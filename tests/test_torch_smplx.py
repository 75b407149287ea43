"""SMPL-X on the port's normal path, on the CPU: an SMPL-X ``model.npz`` in
both shape layouts through ``AvatarModel``, posed against SMPL-X's plain
forward pass (``benchmark/reference/smplx_lbs.py``); an SMPL file loaded
as before; the joint-to-part map a 55-joint body needs on the 24-part
forests, and the error without it; the ``lin`` span; and the port's
trackers on a tiny SMPL-X-topology body against the benchmark's
reference."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from avatar_tpu_torch import profiling, testing
from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.core.lbs import lbs
from avatar_tpu_torch.core.model import AvatarModel
from avatar_tpu_torch.core.pose_prior import GaussianMixture
from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.optim import gauss_newton
from avatar_tpu_torch.perception.partgroups import (SMPL24_GROUP_LUT,
                                                    SMPLX55_TO_SMPL24)
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.tracking import Tracker, TrackerConfig
from avatar_tpu_torch.tracking_fused import FusedTracker

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from harness import spec  # noqa: E402
from reference import smplx_lbs  # noqa: E402

FOREST = str(ROOT / "data" / "bench_forest_r5.srtr")
# the benchmark's SMPL-X-topology body (``smplx_tube``) and, by region,
# [vertices per ring, rings] that make it a CPU size
SMPLX_TUBE = spec.model_generator("smplx_tube")
TINY_RINGS = {"body": [8, 5], "head": [16, 8], "jaw": [8, 4], "eye": [6, 3],
              "finger1": [6, 4], "finger2": [5, 3], "finger3": [5, 3]}
# a float32 chain of 11 levels at metre scale rounds to micrometres
TOL_M = 1e-5


def _write_smplx_npz(out_dir: Path, n_columns: int, seed: int = 3,
                     rings: dict = TINY_RINGS) -> dict:
    """A seeded SMPL-X-layout ``model.npz`` (and ``pose_prior.txt``) of the
    benchmark's 55-joint body at ``rings``: ``shapedirs`` of ``n_columns``
    (400: 300 shape then 100 expression; 20: 10 then 10) seeded
    directions, the root's parent 2^32 - 1, and the keys the port does not
    read.  Returns the arrays as written."""
    a = SMPLX_TUBE.body(rings, 1, 0, seed)
    rng = np.random.default_rng(seed)
    P = a["v_template"].shape[0]
    shapedirs = rng.normal(0.0, 0.004, (P, 3, n_columns))
    shapedirs[:, :, 0] = a["shapedirs"][:, :, 0]
    parent = a["parent"].astype(np.int64)
    kintree = np.stack([np.where(parent < 0, 2 ** 32 - 1, parent),
                        np.arange(55)]).astype(np.uint32)
    arrays = dict(
        v_template=a["v_template"], f=a["faces"].astype(np.uint32),
        J_regressor=a["joint_reg"], weights=a["weights"],
        kintree_table=kintree, shapedirs=shapedirs,
        posedirs=rng.normal(0.0, 1e-3, (P, 3, 486)),
        hands_componentsl=rng.normal(size=(45, 45)),
        hands_componentsr=rng.normal(size=(45, 45)),
        hands_meanl=rng.normal(size=45), hands_meanr=rng.normal(size=45),
        lmk_faces_idx=np.arange(51, dtype=np.int64),
        lmk_bary_coords=np.full((51, 3), 1.0 / 3.0),
        vt=rng.uniform(size=(P, 2)), ft=a["faces"].astype(np.uint32))
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "model.npz", **arrays)
    testing.synthetic_pose_prior(55, seed=seed, device="cpu").save(
        str(out_dir / "pose_prior.txt"))
    return arrays


def _poses(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return [(t(rng.standard_normal(10)), t(rng.standard_normal(10)),
             t(rng.normal(0.0, 0.3, (55, 3))),
             t([rng.uniform(-0.5, 0.5), 0.1, rng.uniform(2.0, 3.5)]))
            for _ in range(n)]


def _largest_gaps(model: AvatarModel, ref, poses):
    """The largest vertex and joint distance (m) between the port's posed
    model and SMPL-X's plain forward pass, the plain pass translated so
    that its pelvis lands at the port's root position ``p``."""
    dv = dj = 0.0
    for betas, expr, aa, p in poses:
        verts, joints, _, _ = lbs(model.params, model.parents,
                                  torch.cat([betas, expr]), p,
                                  rotation.so3_exp(aa))
        transl = p - smplx_lbs.rest_joints(ref, betas, expr)[0]
        rv, rj = smplx_lbs.forward(ref, betas, expr, aa, transl)
        dv = max(dv, float(torch.linalg.norm(verts - rv, dim=1).max()))
        dj = max(dj, float(torch.linalg.norm(joints - rj, dim=1).max()))
    return dv, dj


@pytest.mark.parametrize("n_columns,expression_start", [(400, 300),
                                                        (20, 10)])
def test_smplx_npz_loads_and_poses_as_smplx(tmp_path, n_columns,
                                            expression_start):
    arrays = _write_smplx_npz(tmp_path / "m", n_columns)
    model = AvatarModel(str(tmp_path / "m"), device="cpu")
    assert model.num_joints() == 55 and model.num_shape_keys() == 20
    assert model.parents == tuple([-1] + arrays["kintree_table"][0, 1:]
                                  .astype(int).tolist())
    want = np.concatenate([
        arrays["shapedirs"][:, :, :10],
        arrays["shapedirs"][:, :, expression_start:expression_start + 10]],
        -1)
    assert np.array_equal(model.shapedirs, want)
    assert model.pose_prior.means.shape == (4, 162)
    ref = smplx_lbs.load(str(tmp_path / "m" / "model.npz"))
    dv, dj = _largest_gaps(model, ref, _poses(6))
    assert dv <= TOL_M and dj <= TOL_M, (dv, dj)


def test_first_20_columns_of_400_are_not_smplx(tmp_path):
    """A loader that took columns 0-19 of the 400-column layout (the
    expression directions mixed in as body shape) misses the plain
    forward pass by far more than the tolerance."""
    arrays = _write_smplx_npz(tmp_path / "m", 400)
    parent = arrays["kintree_table"][0].astype(np.int32)
    parent[0] = -1
    wrong = dict(v_template=arrays["v_template"], parent=parent,
                 faces=arrays["f"], joint_reg=arrays["J_regressor"],
                 weights=arrays["weights"],
                 shapedirs=arrays["shapedirs"][:, :, :20], use_jsr=True)
    model = AvatarModel(arrays=wrong, device="cpu")
    ref = smplx_lbs.load(str(tmp_path / "m" / "model.npz"))
    dv, _ = _largest_gaps(model, ref, _poses(3))
    assert dv > 100 * TOL_M


@pytest.mark.parametrize("n_keys", [10, 300])
def test_smpl_npz_loads_as_before(tmp_path, n_keys):
    """An SMPL ``model.npz`` (24 joints) keeps every array as written, all
    its shape columns included."""
    d = testing.write_synthetic_model_dir(str(tmp_path / "m"), n_keys=n_keys)
    with np.load(Path(d) / "model.npz") as npz:
        written = {k: npz[k] for k in npz.files}
    model = AvatarModel(d, device="cpu")
    assert model.shapedirs.shape[2] == n_keys
    for name, got in (("v_template", model.v_template),
                      ("shapedirs", model.shapedirs),
                      ("J_regressor", model.joint_reg_np),
                      ("weights", model.weights_np)):
        assert got.dtype == np.float64
        assert np.array_equal(got, written[name]), name
    assert np.array_equal(model.faces, written["f"].astype(np.int32))
    assert model.parents == tuple(testing._PARENTS.tolist())


@pytest.fixture(scope="module")
def smplx_model():
    prior = SMPLX_TUBE.prior_arrays(55, {"prior_seed": 8})
    return AvatarModel(arrays=SMPLX_TUBE.body(TINY_RINGS, 10, 10, 7),
                       pose_prior=GaussianMixture(*prior, device="cpu"),
                       device="cpu")


def _intrin():
    return CameraIntrin(fx=151.6, fy=151.6, cx=159.3, cy=91.7)


@pytest.mark.parametrize("kind", ["fused", "host"])
def test_missing_or_wrong_part_map_raises(smplx_model, kind):
    """A 55-joint body on a 24-part forest: without a map, or with one of
    other than its joints, the tracker refuses it naming both counts;
    with ``SMPLX55_TO_SMPL24`` it is built."""
    cls = FusedTracker if kind == "fused" else Tracker
    cfg = TrackerConfig(part_groups=tuple(SMPL24_GROUP_LUT)
                        if kind == "fused" else None)
    tree = RTree(FOREST, device="cpu")
    assert tree.part_map == [] and tree.num_parts == 24
    with pytest.raises(ValueError, match="up to 54.*24 parts"):
        cls(smplx_model, _intrin(), (180, 320), rtree=tree, config=cfg)
    tree.part_map = list(SMPLX55_TO_SMPL24[:30])
    with pytest.raises(ValueError, match="covers 30 joints.*has 55"):
        cls(smplx_model, _intrin(), (180, 320), rtree=tree, config=cfg)
    tree.part_map = list(SMPLX55_TO_SMPL24)
    cls(smplx_model, _intrin(), (180, 320), rtree=tree, config=cfg)
    if kind == "fused":
        # no forest: each joint its own part, past the 24-part group table
        with pytest.raises(ValueError, match="cover 24 parts.*up to 54"):
            cls(smplx_model, _intrin(), (180, 320), rtree=None, config=cfg)


def test_graphed_lin_span_sits_inside_step():
    """On the graphed path a re-linearizing step is ``step/lin`` inside
    ``step``; a kept-bundle step is ``step`` alone."""
    prog = gauss_newton._Program(
        ctx=None, b=SimpleNamespace(flags=torch.tensor([True, False])),
        lin=None, step=None, wild=0)
    replays = []
    prog.graphs = {name: SimpleNamespace(replay=lambda n=name:
                                         replays.append(n))
                   for name in ("lin", "step")}
    prog.launches = {"lin": {}, "step": {}}
    with profiling.stage_clock("cpu") as clock:
        with profiling.scope("fit"):
            for relinearize in (True, False, True):
                assert prog.run(relinearize, graphed=True) == (True, False)
    st = clock.stages
    assert replays == ["lin", "step", "lin"]
    assert st["fit/step"]["entries"] == 3
    assert st["fit/step/lin"]["entries"] == 2
    assert st["fit/sync"]["entries"] == 3
    assert st["fit/step"]["elapsed_ms"] >= st["fit/step/lin"]["elapsed_ms"]


def _harness_inputs(kind: str):
    """The tiny configuration of ``kind`` with the benchmark's SMPL-X body
    and map, at a CPU size, and the tiny steady mix."""
    data = BENCH / "tests" / "data"
    cfg = json.loads((data / "configs" / f"tiny_{kind}.json").read_text())
    full = json.loads((BENCH / "configs" /
                       "fused_smplx_720p.json").read_text())
    cfg["model"] = dict(full["model"], rings=TINY_RINGS)
    cfg["forest_partmap"] = full["forest_partmap"]
    cfg["tracker_config"].update(initial_icp_iters=2, reinit_icp_iters=2,
                                 frame_icp_iters=1)
    traffic = json.loads((data / "traffic" /
                          "tiny_steady_walk.json").read_text())
    return cfg, traffic


@pytest.fixture(scope="module")
def smplx_scenes():
    from harness.scene import make_scene
    out = {}
    for kind in ("fused", "host"):
        cfg, traffic = _harness_inputs(kind)
        out[kind] = cfg, make_scene(cfg, traffic, 2 ** 31 + 77, "cpu", BENCH)
    return out


@pytest.mark.parametrize("kind", ["fused", "host"])
def test_port_tracks_smplx_with_the_reference_s_joints(smplx_scenes, kind):
    """The port's tracker on the tiny SMPL-X-topology body with
    ``SMPLX55_TO_SMPL24``: four frames, the reference taking over the
    port's state before each, with the reference's labelled points and
    joints; the fused
    frames' ``lin`` span counts the linearizations and ``steps`` the LM
    steps, as before."""
    from harness.trackers import build_program, build_reference
    cfg, scene = smplx_scenes[kind]
    program = build_program(cfg, scene, "cpu")
    reference = build_reference(cfg, scene, "cpu")
    assert program.tracker.rtree.part_map == SMPLX55_TO_SMPL24.tolist()
    for k in range(4):
        frame = scene.frames[scene.slot(k).frame]
        state = program.state()
        with profiling.stage_clock("cpu") as clock:
            got = program.feed(frame)
        reference.set_state(state)
        want = reference.feed(frame)
        assert got.ok and want.ok, k
        assert got.n_points == want.n_points
        assert got.joints.shape == (55, 3)
        np.testing.assert_allclose(got.joints, want.joints, atol=1e-4)
        st = clock.stages
        assert st["fit"]["counts"]["steps"] == st["fit/sync"]["entries"]
        assert st["fit/lin"]["entries"] == st["fit/nn"]["entries"] > 0
        assert st["fit/lin"]["depth"] == st["fit/nn"]["depth"] == 2
        assert st["fit/lin"]["entries"] <= st["fit/sync"]["entries"]
