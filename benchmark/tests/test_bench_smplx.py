"""The SMPL-X configuration: its body generator's counts, its joint-to-part
map, a tiny copy of the configuration rendered and tracked by the program
and the reference, and the readers of the ``lin`` span's metrics."""

import json
import shutil
import time

import numpy as np
import pytest

from harness import spec
from harness.cell import TraceRun, run_cell
from harness.scene import make_scene
from harness.trackers import ROOT, build_program, build_reference
from reference.formats import read_partmap

SEED = 2 ** 31 + 77
# SMPL-X's kintree_table (the smplx package's SMPLX layer)
SMPLX_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                 16, 17, 18, 19, 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31,
                 32, 20, 34, 35, 20, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46,
                 47, 21, 49, 50, 21, 52, 53]
CONFIG = spec.BENCH_DIR / "configs" / "fused_smplx_720p.json"
TINY_RINGS = {"body": [8, 5], "head": [16, 8], "jaw": [8, 4], "eye": [6, 3],
              "finger1": [6, 4], "finger2": [5, 3], "finger3": [5, 3]}


def test_generator_gives_smplx_counts():
    config = json.loads(CONFIG.read_text())
    gen = spec.model_generator(config["model"]["generator"])
    a = gen.arrays(config["model"])
    assert a["v_template"].shape == (10475, 3)
    assert a["parent"].tolist() == SMPLX_PARENTS
    assert a["weights"].shape == (10475, 55)
    assert a["joint_reg"].shape == (55, 10475)
    assert a["shapedirs"].shape == (10475, 3, 20)
    assert abs(len(a["faces"]) - 20908) <= 0.03 * 20908
    assert a["faces"].min() == 0 and a["faces"].max() == 10474
    # expression keys (10-19) move the head's vertices and nothing else
    moved = np.abs(a["shapedirs"][:, :, 10:]).max(axis=(1, 2)) > 0
    head = a["v_template"]
    assert moved.sum() > 4900
    assert (head[moved, 1] > 0.42).all() and (np.abs(head[moved, 0]) <
                                              0.1).all()
    assert (np.abs(a["shapedirs"][:, :, :10]).max(axis=(1, 2)) > 0).all()
    # each hand from the wrist on: its fingers' vertices, about MANO's 778
    for fingers in (range(25, 40), range(40, 55)):
        hand = a["weights"][:, list(fingers)].sum(1) > 0
        assert 300 < hand.sum() <= 778
    w, means, covs = gen.prior_arrays(55, config["model"])
    assert means.shape == (4, 162) and covs.shape == (4, 162, 162)


def test_partmap_is_the_port_s_map():
    from avatar_tpu_torch.perception.partgroups import SMPLX55_TO_SMPL24
    config = json.loads(CONFIG.read_text())
    ours = read_partmap(str(ROOT / config["forest_partmap"]))
    assert ours[0] == SMPLX55_TO_SMPL24.tolist() and ours[1] == 24
    port = read_partmap(str(ROOT / "data" / "smplx55_smpl24.partmap"))
    assert ours == port


def _tiny_smplx(bench_copy):
    """The tiny fused cell with the SMPL-X body of ``fused_smplx_720p``'s
    generator and map, at the tiny rings, as new files of ``bench_copy``."""
    models = bench_copy / "harness" / "models"
    models.mkdir(parents=True)
    shutil.copy(spec.BENCH_DIR / "harness" / "models" / "smplx_tube.py",
                models)
    full = json.loads(CONFIG.read_text())
    cfg = json.loads((bench_copy / "configs" / "tiny_fused.json").read_text())
    cfg["model"] = dict(full["model"], rings=TINY_RINGS)
    cfg["forest_partmap"] = full["forest_partmap"]
    # fewer LM steps: the plain search is slow on the CPU
    cfg["tracker_config"].update(initial_icp_iters=2, reinit_icp_iters=2,
                                 frame_icp_iters=1)
    (bench_copy / "configs" / "tiny_smplx.json").write_text(json.dumps(cfg))
    (bench_copy / "limits" / "tiny_smplx_steady.json").write_text(
        (bench_copy / "limits" / "tiny_fused_steady.json").read_text())
    b = json.loads((bench_copy / "BENCHMARK.json").read_text())
    b["configs"].append(dict(name="tiny_smplx", source="a test",
                             file="configs/tiny_smplx.json",
                             reduced=["posedirs"], why="a test"))
    b["workloads"].append(dict(name="tiny_smplx_steady", config="tiny_smplx",
                               traffic="tiny_steady_walk", chips=1,
                               why="a test"))
    for name in ("lin_ms.steady", "lin_flops_pct.steady"):
        b["per_layer"].append(dict(name=name, unit="x", better="lower",
                                   source="program_span", layer="LM fit",
                                   moves="frames_per_s",
                                   workloads=["tiny_smplx_steady"]))
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(b))
    return spec.load_cell("tiny_smplx_steady", bench_copy / "BENCHMARK.json",
                          bench_copy)


def test_tiny_smplx_renders_and_both_sides_track_it(bench_copy):
    cell = _tiny_smplx(bench_copy)
    # make_scene raises where a frame's samples overflow the renderer
    scene = make_scene(cell.config, cell.traffic, SEED, "cpu", bench_copy)
    assert len(scene.arrays["parent"]) == 55
    bg_mm = int(cell.config["background_depth_m"] * 1000)
    assert all((f < bg_mm).sum() > 500 for f in scene.frames)
    program = build_program(cell.config, scene, "cpu")
    reference = build_reference(cell.config, scene, "cpu")
    for runner in (program, reference):
        tree = runner.tracker.rtree
        assert tree.part_map[22:25] == [15, 15, 15]
        assert tree.part_map[25:] == [22] * 15 + [23] * 15
    for k in range(3):
        frame = scene.frames[scene.slot(k).frame]
        state = program.state()
        got = program.feed(frame)
        reference.set_state(state)
        want = reference.feed(frame)
        assert got.ok and want.ok, k
        assert got.joints.shape == (55, 3)
        assert got.n_points == want.n_points
        np.testing.assert_allclose(got.joints, want.joints, atol=1e-3)


def test_tiny_smplx_run_is_correct_and_reads_the_lin_span(bench_copy):
    cell = _tiny_smplx(bench_copy)
    result = run_cell(cell, SEED, 1.0, True, "cpu", time.perf_counter(),
                      str(bench_copy))
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["lin_ms.steady"]["value"] > 0
    assert 0 < result["metrics"]["lin_flops_pct.steady"]["value"] < 100


def _frame(stages):
    fit = dict(P=1000, J=55, K=20, D=188, N=4096, pairs=2_000_000)
    return dict(kind="steady", frame=0, wall_s=0.05, stages=stages,
                searches=2, fits=[fit])


@pytest.mark.parametrize("path", ["fit/step/lin", "fit/lin"])
def test_lin_readers_read_the_span_or_nothing(path):
    lin_ms = spec.metric_reader("lin_ms.steady")
    lin_pct = spec.metric_reader("lin_flops_pct.steady")
    span = dict(elapsed_ms=4.0, host_ms=1.0, entries=2, depth=2, counts={})
    fit = dict(elapsed_ms=10.0, host_ms=9.0, entries=1, depth=1,
               counts={"steps": 8})
    run = TraceRun([_frame({"fit": fit, path: span}),
                    _frame({"fit": fit, path: dict(span, elapsed_ms=6.0)}),
                    dict(_frame({"fit": fit}), kind="reinit")],
                   None, None, None)
    assert lin_ms(run) == pytest.approx(5.0)
    import roofline as r
    per_step = (r.jacobian_flops(1000, 55, 20, True) + r.gram_flops(1000, 188)
                + 2_000_000 * 9 + r.solve_flops(188) +
                r.lbs_flops(1000, 55, 20))
    assert lin_pct(run) == pytest.approx(
        100 * 4 * per_step / 10e-3 / 67e12)
    # the parent's program has no lin span: nothing to read
    parent = TraceRun([_frame({"fit": fit, "fit/step": span})], None, None,
                      None)
    assert lin_ms(parent) is None and lin_pct(parent) is None
