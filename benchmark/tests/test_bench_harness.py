"""The harness on the CPU at a tiny size: cells, configurations, mixes and
metrics found by name, the result line, the check on JAX, and the
comparison that decides ``correct`` failing on planted faults."""

import json
import time

import numpy as np
import pytest
import torch

import run
from harness import check, spec
from harness.cell import TraceRun, run_cell
from harness.scene import make_scene
from harness.trackers import Output, build_reference

SEED = 2 ** 31 + 77


def _run(bench_copy, workload, trace=False, seconds=1.0):
    cell = spec.load_cell(workload, bench_copy / "BENCHMARK.json",
                          bench_copy)
    return cell, run_cell(cell, SEED, seconds, trace, "cpu",
                          time.perf_counter(), str(bench_copy))


def test_added_files_are_found_by_name(bench_copy):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as new files, and entries in BENCHMARK.json, with no
    file of the harness edited."""
    cfg = json.loads((bench_copy / "configs" / "tiny_host.json").read_text())
    cfg["tracker_config"]["frame_icp_iters"] = 2
    (bench_copy / "configs" / "extra.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_copy / "traffic" /
                      "tiny_steady_walk.json").read_text())
    mix["root"] = [0.1, 0.1, 2.4]
    (bench_copy / "traffic" / "extra_walk.json").write_text(json.dumps(mix))
    (bench_copy / "limits" / "extra_cell.json").write_text(
        (bench_copy / "limits" / "tiny_host_steady.json").read_text())
    (bench_copy / "metrics" / "extra_frames.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    b = json.loads((bench_copy / "BENCHMARK.json").read_text())
    b["configs"].append(dict(name="extra", source="a test",
                             file="configs/extra.json", reduced=[],
                             why="a test"))
    b["workloads"].append(dict(name="extra_cell", config="extra",
                               traffic="extra_walk", chips=1, why="a test"))
    b["per_layer"].append(dict(name="extra_frames", unit="frames",
                               better="higher", source="program_counter",
                               layer="tracker", moves="frames_per_s",
                               workloads=["extra_cell"]))
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("extra_cell", bench_copy / "BENCHMARK.json",
                          bench_copy)
    assert cell.config["tracker_config"]["frame_icp_iters"] == 2
    assert cell.traffic["root"] == [0.1, 0.1, 2.4]
    assert [m["name"] for m in cell.per_layer][-1] == "extra_frames"
    fake = TraceRun([{"kind": "steady"}] * 3, None, None, cell)
    got = spec.read_metrics(cell.per_layer, fake, bench_copy)
    assert got["extra_frames"] == {"value": 3.0, "unit": "frames"}
    # a reader that finds nothing leaves its metric out
    assert "device_idle_pct" not in got

    cell, result = _run(bench_copy, "extra_cell", trace=True)
    assert result["metrics"]["extra_frames"]["value"] >= 1


# A body model's generator as a configuration brings it: the tube body
# with three finger joints under each hand, 30 joints in all.
_TOY_BODY = '''"""The tube body with three finger joints under each hand."""
import numpy as np

from harness import model_arrays as ma


def _skeleton():
    joints, parents = list(ma._REST_JOINTS), list(ma._PARENTS)
    radius = dict(ma._BONE_RADIUS)
    for hand, side in ((22, 1.0), (23, -1.0)):
        parent = hand
        for k in range(1, 4):
            joints.append(ma._REST_JOINTS[hand] + [side * 0.035 * k, 0, 0])
            parents.append(parent)
            parent = len(joints) - 1
            radius[parent] = 0.012
    return np.array(joints), np.array(parents, np.int32), radius


def arrays(model):
    return ma.tube_arrays(*_skeleton(), n_seg=model["ring_vertices"],
                          n_rings=model["rings"],
                          n_keys=model["shape_keys"], seed=model["seed"])


def prior_arrays(n_joints, model):
    return ma.synthetic_pose_prior_arrays(n_joints, seed=model["prior_seed"])
'''


def _toy_partmap(n_joints: int, n_parts: int = 24) -> str:
    """Joints 0-23 onto the forest's parts 0-23, each hand's fingers onto
    its hand's part (22, 23); modulo ``n_parts``."""
    part = [(min(j, 22) if j < 27 else 23) % n_parts
            for j in range(n_joints)]
    return "\n".join(
        ["partmap disjoint", f"src {n_joints}",
         " ".join(f"joint{j}" for j in range(n_joints)), f"dest {n_parts}",
         " ".join(f"part{p}" for p in range(n_parts))] +
        [f"joint{j} part{p}" for j, p in enumerate(part)]) + "\n"


def test_a_new_body_is_found_by_name(bench_copy):
    """A body with more joints than the forest has parts and more than
    2^14 faces, brought as new files only: its generator, a joint-to-part
    map and configurations naming both.  The scene renders it, the
    reference's fused and host trackers track it, and a map that does not
    fit the model or the forest is refused."""
    models = bench_copy / "harness" / "models"
    models.mkdir(parents=True)
    (models / "toy_hands.py").write_text(_TOY_BODY)
    partmap = bench_copy / "configs" / "toy_hands.partmap"
    partmap.write_text(_toy_partmap(30))
    b = json.loads((bench_copy / "BENCHMARK.json").read_text())
    for kind in ("fused", "host"):
        cfg = json.loads((bench_copy / "configs" /
                          f"tiny_{kind}.json").read_text())
        # 12 rings of 32 vertices a bone: faces about as long as they are
        # wide, so that their samples fit the scene's budget
        cfg["model"] = dict(generator="toy_hands", rings=12,
                            ring_vertices=32, shape_keys=10, seed=7,
                            prior_seed=8)
        # absolute, so that joined to the checkout's root it stays itself
        cfg["forest_partmap"] = str(partmap)
        if kind == "fused":
            # fewer LM steps: the plain search over 11,136 vertices is slow
            # on the CPU
            cfg["tracker_config"].update(initial_icp_iters=2,
                                         reinit_icp_iters=2,
                                         frame_icp_iters=1)
        (bench_copy / "configs" / f"toy_{kind}.json").write_text(
            json.dumps(cfg))
        (bench_copy / "limits" / f"toy_{kind}_steady.json").write_text(
            (bench_copy / "limits" / f"tiny_{kind}_steady.json").read_text())
        b["configs"].append(dict(name=f"toy_{kind}", source="a test",
                                 file=f"configs/toy_{kind}.json", reduced=[],
                                 why="a test"))
        b["workloads"].append(dict(name=f"toy_{kind}_steady",
                                   config=f"toy_{kind}",
                                   traffic="tiny_steady_walk", chips=1,
                                   why="a test"))
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(b))

    for kind, partmap_type in (("fused", 0), ("host", 1)):
        cell = spec.load_cell(f"toy_{kind}_steady",
                              bench_copy / "BENCHMARK.json", bench_copy)
        # make_scene raises where a frame's samples overflow the renderer
        scene = make_scene(cell.config, cell.traffic, SEED, "cpu",
                           bench_copy)
        assert len(scene.arrays["parent"]) == 30
        assert len(scene.arrays["faces"]) > 2 ** 14
        bg_mm = int(cell.config["background_depth_m"] * 1000)
        assert all((f < bg_mm).sum() > 500 for f in scene.frames)
        reference = build_reference(cell.config, scene, "cpu")
        tree = reference.tracker.rtree
        assert tree.part_map == [min(j, 22) if j < 27 else 23
                                 for j in range(30)]
        # the configuration's forest_partmap_type overrides the map's type
        assert tree.partmap_type == partmap_type
        for k in range(3):
            out = reference.feed(scene.frames[scene.slot(k).frame])
            assert out.ok, (kind, k)
            assert out.joints.shape == (30, 3)
            assert np.isfinite(out.joints).all()

    # a map onto other parts than the forest's, or of other joints than the
    # model's, is refused
    for n_joints, n_parts in ((30, 14), (31, 24)):
        partmap.write_text(_toy_partmap(n_joints, n_parts))
        with pytest.raises(ValueError, match="maps"):
            build_reference(cell.config, scene, "cpu")


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"jax": object(), "jax.numpy": object(), "jaxlib.xla": object(),
            "flax.linen": object(), "avatar_tpu": object(),
            "avatar_tpu.tracking": object(), "avatar_tpu_torch": object(),
            "avatar_tpu_torch.tracking": object(), "jaxtyping": object(),
            "flaxen": object(), "numpy": object(), "jax_blocked": None,
            "avatar_tpu.core": None}
    assert run.loaded_forbidden(mods) == [
        "avatar_tpu", "avatar_tpu.tracking", "flax.linen", "jax",
        "jax.numpy", "jaxlib.xla"]


def test_run_refuses_without_enough_cuda_devices(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "fused_steady", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "CUDA" in out.err


def test_result_line(bench_copy):
    cell, result = _run(bench_copy, "tiny_fused_steady")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == set(cell.limits)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_traced_run_reads_the_stage_clock(bench_copy):
    cell, result = _run(bench_copy, "tiny_host_steady", trace=True)
    assert result["correct"] is True
    names = set(result["metrics"])
    assert {"forest_walk_ms", "blob_suppress_ms", "fit_ms.steady",
            "frame_mfu_pct"} <= names
    # no device events on the CPU: nothing of the trace is reported
    assert "device_idle_pct" not in names and "breakdown" not in result
    assert result["metrics"]["frame_mfu_pct"]["value"] > 0


def _state_unchanged(monkeypatch):
    """Every LM step of the program returns its state unchanged."""
    from avatar_tpu_torch.optim import gauss_newton
    real = gauss_newton._update

    def stuck(b, trial, trial_fwd, trial_cost, *args):
        return real(b, trial, trial_fwd, torch.full_like(trial_cost,
                                                         float("inf")),
                    *args)
    monkeypatch.setattr(gauss_newton, "_update", stuck)


def _answer_altered(monkeypatch):
    """The fit's answer is moved 5 cm where it is produced."""
    from avatar_tpu_torch import tracking_fused
    from avatar_tpu_torch.optim import optimizer

    for mod in (tracking_fused, optimizer):
        real = mod.fit

        def moved(*args, _real=real, **kw):
            theta, diag = _real(*args, **kw)
            return theta._replace(p=theta.p + torch.tensor(
                [0.05, 0.0, 0.0], dtype=theta.p.dtype)), diag
        monkeypatch.setattr(mod, "fit", moved)


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered],
                         ids=["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("workload", ["tiny_fused_steady",
                                      "tiny_host_steady"])
def test_planted_fault_is_not_correct(bench_copy, monkeypatch, fault,
                                      workload):
    fault(monkeypatch)
    _, result = _run(bench_copy, workload)
    failed = [k for k, c in result["checks"].items()
              if c["value"] is None or c["value"] > c["limit"]]
    assert result["correct"] is False, result["checks"]
    assert failed


@pytest.mark.parametrize("workload", ["fused_steady", "host_steady"])
def test_a_fault_on_all_frames_but_a_few_is_not_correct(workload):
    """The limits of the benchmark's own cells, on the gaps of 21 compared
    frames of which the program got 5 right, as the reference did, and
    16 wrong by about as much as the TF32 control gets them (PERF.md)."""
    cell = spec.load_cell(workload, run.ROOT / "BENCHMARK.json")
    sound = dict(points_gap=0.0, vertex_gap_mm=0.0,
                 typical_vertex_gap_mm=0.0, cost_gap=0.0, lbs_gap_mm=0.0)
    wrong = dict(sound, vertex_gap_mm=5.0, typical_vertex_gap_mm=0.9,
                 cost_gap=5e-3)
    gaps = [sound] * 5 + [wrong] * 16
    assert check.judge(check.numbers(gaps[:5]), cell.limits)[0]
    assert not check.judge(check.numbers(gaps), cell.limits)[0]


def test_a_missed_reentry_is_counted():
    def rec(body, start, reinit):
        return dict(body=body, segment_start=start,
                    out=Output(True, reinit, 1, 1.0, None, None, None))
    records = [rec(True, True, True), rec(True, False, False),
               rec(False, False, False), rec(True, True, False),
               rec(True, False, True)]
    assert check.window_numbers(records) == {"missed_reentries": 1.0}
    limits = {"missed_reentries": 0}
    assert not check.judge(check.window_numbers(records), limits)[0]
    assert check.judge(check.window_numbers(records[:3]), limits)[0]
