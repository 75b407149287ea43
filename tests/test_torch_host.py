"""Parity of the port's host API with the JAX reference: the host
``Tracker`` and what it runs (``AvatarOptimizer``, ``BGSubtractor``, the
``RTree`` inference API), ``CameraIntrin``, ``AvatarPoseSequence`` and
``lbs_batched``; and the rule that every entry point runs on the card
unless the caller asks for the CPU.

Integer outputs (masks, labels, boxes, counts, flags) must be equal.  The
reference's fits run on its planned NN path (the Pallas kernel in
interpret mode, ``planned_nn``), which the port's bucketed fits take too;
poses then agree within the fit tolerances of ``test_torch_fit.py`` (p
1e-4 m, rotations 1e-4, shape keys 1e-3), tracked joints within 1 mm.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avatar_tpu.core import lbs as jlbs
from avatar_tpu.core import rotation as jrot
from avatar_tpu.core.model import Avatar as JAvatar
from avatar_tpu.core.sequence import AvatarPoseSequence as JSequence
from avatar_tpu.io.calibration import CameraIntrin as JIntrin
from avatar_tpu.optim import correspond as jcorr
from avatar_tpu.optim import nn_pallas
from avatar_tpu.optim.optimizer import AvatarOptimizer as JOptimizer
from avatar_tpu.perception import bgsub as jbgsub
from avatar_tpu.perception import rtree as jrtree
from avatar_tpu.render.renderer import AvatarRenderer as JRenderer
from avatar_tpu.testing import synthetic_model as j_synthetic_model
from avatar_tpu.tracking import Tracker as JTracker
from avatar_tpu.tracking import TrackerConfig as JConfig
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.core import lbs as tlbs
from avatar_tpu_torch.core.model import Avatar as TAvatar
from avatar_tpu_torch.core.model import AvatarModel as TModel
from avatar_tpu_torch.core.sequence import AvatarPoseSequence as TSequence
from avatar_tpu_torch.io.calibration import CameraIntrin as TIntrin
from avatar_tpu_torch.optim.optimizer import AvatarOptimizer as TOptimizer
from avatar_tpu_torch.perception import bgsub as tbgsub
from avatar_tpu_torch.perception import rtree as trtree
from avatar_tpu_torch.testing import synthetic_arrays
from avatar_tpu_torch.testing import synthetic_model as t_synthetic_model
from avatar_tpu_torch.tracking import Tracker as TTracker
from avatar_tpu_torch.tracking import TrackerConfig as TConfig

H = W = 256
INTRIN = dict(fx=220.0, fy=220.0, cx=128.0, cy=128.0)
FOREST = "data/bench_forest.srtr"


@pytest.fixture
def planned_nn(monkeypatch):
    """Route the reference's fit through the part-sorted NN kernel in
    interpret mode (its TPU path) instead of the CPU's unplanned path."""
    kernel = nn_pallas.nn_argmin_ranges

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return kernel(*args, **kw)

    jax.clear_caches()
    monkeypatch.setattr(jcorr, "_pallas_enabled", lambda: True)
    monkeypatch.setattr(nn_pallas, "nn_argmin_ranges", interpreted)
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def models():
    return j_synthetic_model(detail=2), t_synthetic_model(detail=2,
                                                          device="cpu")


@pytest.fixture(scope="module")
def sequence(models):
    """The scene of ``tests/test_tracking.py``: 6 frames of a drifting
    avatar at 256x256, as (xyz, part mask, ground-truth (p, r, w)),
    rendered by the reference."""
    jm = models[0]
    intrin = JIntrin(**INTRIN)
    gt = JAvatar(jm)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 2.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(8)
    drift = rng.normal(0, 0.02, (24, 3))
    frames = []
    for _ in range(6):
        gt.update()
        rend = JRenderer(gt, intrin)
        xyz = np.asarray(intrin.depth_to_xyz_np(rend.render_depth((H, W))))
        frames.append((xyz, rend.render_part_mask((H, W)),
                       (gt.p.copy(), gt.r.copy(), gt.w.copy())))
        step = np.asarray(jrot.so3_exp(jnp.asarray(drift, jnp.float32)))
        gt.r = np.einsum("jab,jbc->jac", step, gt.r)
        gt.p = gt.p + rng.normal(0, 0.01, 3)
    return frames


def _wall(depth_m=4.0):
    """XYZ of a flat wall at ``depth_m``, seen through ``INTRIN``."""
    return TIntrin(**INTRIN).depth_to_xyz_np(
        np.full((H, W), depth_m, np.float32))


# -- entry points default to the card -----------------------------------------


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device argument the entry points ask for CUDA and raise
    where it is absent; there is no CPU fallback.  ``device="cpu"`` works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = synthetic_arrays(1)
    for make in (lambda **kw: TModel(arrays=arrays, **kw),
                 lambda **kw: trtree.RTree(FOREST, **kw),
                 lambda **kw: t_synthetic_model(detail=1, **kw),
                 lambda **kw: tbgsub.BGSubtractor(_wall(), **kw),
                 lambda **kw: from_reference(np.zeros(3), **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        assert make(device="cpu") is not None
    model = TModel(arrays=arrays, device="cpu")
    assert model.params.weights.device.type == "cpu"
    assert TOptimizer(TAvatar(t_synthetic_model(device="cpu"))).device == \
        torch.device("cpu")


# -- AvatarOptimizer ---------------------------------------------------------


@pytest.mark.parametrize("robust_per_part,plane_weight,nn_step",
                         [(False, 0.0, 1), (True, 2.0, 3)])
def test_optimizer_matches_reference(models, sequence, planned_nn,
                                     robust_per_part, plane_weight, nn_step):
    """``optimize`` on a labelled cloud ([3, N] as the reference's C++
    callers pass it) from a start 3 cm and ~0.05 rad per joint off the
    truth: n_matched and the accepted steps equal, the pose within the fit
    tolerances.  The default (global median, no plane term) and the
    tracker's settings with a candidate stride."""
    jm, tm = models
    xyz, mask, (p, r, w) = sequence[0]
    fg = (mask != 255) & (xyz[..., 2] > 0)
    pts = xyz[fg][::4] * np.array([1.0, -1.0, 1.0])
    labels = mask[fg][::4].astype(np.int32)
    rng = np.random.default_rng(12)
    ja = JAvatar(jm)
    ja.p = p + np.array([0.03, -0.02, 0.02])
    ja.r = np.einsum("jab,jbc->jac", np.asarray(jrot.so3_exp(jnp.asarray(
        rng.normal(0, 0.05, (24, 3)), jnp.float32))), r)
    ja.w = w
    jo, to = JOptimizer(ja), TOptimizer(from_reference(ja, model=tm))
    jo.beta_pose, jo.max_iters_per_icp = 0.3, 4    # bench.py's budget
    jo.robust_per_part, jo.plane_weight, jo.nn_step = (
        robust_per_part, plane_weight, nn_step)
    from_reference(jo, into=to)
    assert (to.plane_weight, to.nn_step, to.beta_pose,
            to.max_iters_per_icp) == (plane_weight, nn_step, 0.3, 4)
    info_j = jo.optimize(pts.T, labels, icp_iters=1)
    info_t = to.optimize(pts.T, labels, icp_iters=1)
    assert info_t["n_matched"] == info_j["n_matched"] > 200
    assert info_t["inner_iters"] == info_j["inner_iters"] > 0
    assert info_t["part_counts"] == info_j["part_counts"]
    np.testing.assert_allclose(to.ava.p, ja.p, atol=1e-4)
    np.testing.assert_allclose(to.ava.r, ja.r, atol=1e-4)
    np.testing.assert_allclose(to.ava.w, ja.w, atol=1e-3)
    np.testing.assert_allclose(to.ava.joint_pos, ja.joint_pos, atol=1e-4)
    # the C++-style aliases
    to.betaPose, to.maxItersPerICP = 0.2, 3
    assert (to.beta_pose, to.max_iters_per_icp) == (0.2, 3)


# -- BGSubtractor -----------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
def test_bgsub_run_matches_reference(sequence, stride):
    """Mask, bounding box and components by size equal, with a second,
    small blob (kept at stride 1) and a speck (erased)."""
    bg = _wall()
    scene = bg.copy()
    xyz = sequence[0][0]
    fg = xyz[..., 2] > 0
    scene[fg] = xyz[fg]
    scene[10:30, 200:225] = _wall(3.0)[10:30, 200:225]
    scene[240:243, 5:8] = _wall(2.0)[240:243, 5:8]
    outs = []
    for cls in (jbgsub.BGSubtractor, tbgsub.BGSubtractor):
        kw = {} if cls is jbgsub.BGSubtractor else dict(device="cpu")
        sub = cls(bg, stride=stride, **kw)
        comps = []
        mask = sub.run(scene, comps_by_size=comps)
        outs.append((mask, sub.top_left, sub.bot_right, comps))
    (mj, tlj, brj, cj), (mt, tlt, brt, ct) = outs
    np.testing.assert_array_equal(mt, mj)
    assert (tlt, brt, ct) == (tlj, brj, cj)
    assert len(ct) == 2 and 0 < (mt != 255).sum() < H * W // 2


# -- RTree inference ----------------------------------------------------------


@pytest.fixture(scope="module")
def forests():
    return jrtree.RTree(FOREST), trtree.RTree(FOREST, device="cpu")


@pytest.mark.parametrize("interval", [1, 2])
def test_rtree_predict_matches_reference(sequence, forests, interval):
    """``predict_best`` (with and without gap filling) and ``predict`` at
    256x256 inside a ROI: labels equal, leaf distributions equal."""
    jt, tt = forests
    depth = sequence[1][0][..., 2]
    roi = dict(top_left=(40, 20), bot_right=(220, 240))
    for fill in (True, False):
        np.testing.assert_array_equal(
            tt.predict_best(depth, interval=interval, fill_in_gaps=fill,
                            **roi),
            jt.predict_best(depth, interval=interval, fill_in_gaps=fill,
                            **roi))
        np.testing.assert_array_equal(
            tt.predict(depth, interval=interval, fill_in_gaps=fill, **roi),
            jt.predict(depth, interval=interval, fill_in_gaps=fill, **roi))
    best = tt.predict_best(depth, interval=interval, **roi)
    assert (best != 255).sum() > 1000


@pytest.mark.parametrize("partmap_type", [0, 1])
def test_rtree_post_process_matches_reference(sequence, forests,
                                              partmap_type):
    """``post_process`` on both part-map types (0: per-part blob
    suppression with centre-of-mass tracking; otherwise small-piece
    removal), over two frames: labels equal, com_pre within 1e-4 px."""
    jt, tt = forests
    jt.partmap_type = tt.partmap_type = partmap_type
    com_j = np.zeros((2, 3))                 # resized like the reference's
    com_t = com_j.copy()
    roi = dict(top_left=(30, 10), bot_right=(230, 250))
    for xyz, _, _ in sequence[:2]:
        labels = jt.predict_best(xyz[..., 2], interval=2, **roi)
        out_j = jt.post_process(labels, com_j, interval=2, **roi)
        out_t = tt.post_process(labels, com_t, interval=2, **roi)
        np.testing.assert_array_equal(out_t, out_j)
        assert (out_t != labels).any(), "the filter erased something"
    np.testing.assert_allclose(com_t, com_j, atol=1e-4)
    assert com_t.shape == (2, tt.num_parts)
    # training over several devices needs a launched world
    with pytest.raises(RuntimeError, match="run_world"):
        tt.train_from_avatar(None, None, None, (8, 8), devices=2)
    assert tt.read_part_map("data/bench_forest_g14c.srtr.partmap") == \
        jt.read_part_map("data/bench_forest_g14c.srtr.partmap")


def test_upscale_grid_and_remove_small_pieces():
    rng = np.random.default_rng(3)
    img = np.where(rng.random((50, 44)) < 0.3, 255,
                   rng.integers(0, 4, (50, 44))).astype(np.uint8)
    tl, br = (5, 3), (39, 46)
    ref = jrtree.upscale_grid(jnp.asarray(img), 3, jnp.asarray(tl),
                              jnp.asarray(br))
    got = trtree.upscale_grid(torch.as_tensor(img), 3, tl, br)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jrtree.remove_small_pieces(jnp.asarray(img), 4, 2,
                                     jnp.asarray([300, 300], jnp.int32),
                                     thresh=0.0002)
    got = trtree.remove_small_pieces(torch.as_tensor(img), 4, 2, (300, 300),
                                     thresh=0.0002)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < (got.numpy() != img).sum() < (img != 255).sum()


# -- lbs_batched, CameraIntrin, AvatarPoseSequence ---------------------------


def test_lbs_batched(models):
    jm, tm = models
    rng = np.random.default_rng(2)
    B, J, K = 3, jm.num_joints(), jm.num_shape_keys()
    w = rng.normal(0, 0.5, (B, K)).astype(np.float32)
    p = rng.normal(0, 1.0, (B, 3)).astype(np.float32)
    rots = np.array(jrot.so3_exp(jnp.asarray(
        rng.normal(0, 0.3, (B, J, 3)), jnp.float32)))
    ref = jlbs.lbs_batched(jm.params, jm.parents, jnp.asarray(w),
                           jnp.asarray(p), jnp.asarray(rots))
    got = tlbs.lbs_batched(tm.params, tm.parents, torch.as_tensor(w),
                           torch.as_tensor(p), torch.as_tensor(rots))
    assert len(got) == len(ref) == 4
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_camera_intrin_file_and_geometry(tmp_path):
    ref = JIntrin.from_file("tests/fixtures/ref_intrin.txt")
    got = TIntrin.from_file("tests/fixtures/ref_intrin.txt")
    assert got == TIntrin(**{k: getattr(ref, k) for k in
                             ("fx", "fy", "cx", "cy", "k", "p")})
    got.write_file(str(tmp_path / "t.txt"))
    ref.write_file(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert TIntrin.from_file(str(tmp_path / "t.txt")) == got
    (tmp_path / "bad.txt").write_text("fx 1 fy 2\n")
    with pytest.raises(ValueError):
        TIntrin.from_file(str(tmp_path / "bad.txt"))

    rng = np.random.default_rng(0)
    depth = np.where(rng.random((30, 40)) < 0.8,
                     rng.uniform(1, 4, (30, 40)), 0).astype(np.float32)
    xyz = got.depth_to_xyz(torch.as_tensor(depth)).numpy()
    np.testing.assert_array_equal(xyz, np.asarray(
        ref.depth_to_xyz(jnp.asarray(depth))))
    np.testing.assert_array_equal(got.depth_to_xyz_np(depth),
                                  ref.depth_to_xyz_np(depth))
    pts = torch.as_tensor(xyz[depth > 0])
    np.testing.assert_allclose(got.to_2d(pts).numpy(), np.asarray(
        ref.to_2d(jnp.asarray(pts.numpy()))), rtol=1e-6)
    uv = rng.uniform(0, 40, (20, 2)).astype(np.float32)
    z = rng.uniform(1, 4, 20).astype(np.float32)
    np.testing.assert_array_equal(
        got.to_3d(torch.as_tensor(uv), torch.as_tensor(z)).numpy(),
        np.asarray(ref.to_3d(jnp.asarray(uv), jnp.asarray(z))))
    from avatar_tpu.io.calibration import intrin_from_xyz as j_from_xyz
    from avatar_tpu_torch.io.calibration import intrin_from_xyz
    assert intrin_from_xyz(xyz) == TIntrin(**vars(j_from_xyz(xyz)))


def test_pose_sequence_write_read_and_pose(models, tmp_path):
    jm, tm = models
    rng = np.random.default_rng(6)
    F, J = 5, jm.num_joints()
    q = rng.normal(size=(F, J, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = rng.normal(size=(F, 3))
    path = str(tmp_path / "bank.dat")
    TSequence.write(path, pos, q, {"a": 0, "b": 3})
    js, ts = JSequence(path), TSequence(path)
    assert (ts.num_frames, ts.frame_size, ts.subsequences) == (
        js.num_frames, js.frame_size, js.subsequences) == (
        F, 3 + 4 * J, {"a": 0, "b": 3})
    ja, ta = JAvatar(jm), TAvatar(tm)
    js.pose_avatar(ja, 3)
    ts.pose_avatar(ta, 3)
    np.testing.assert_array_equal(ta.p, ja.p)
    np.testing.assert_allclose(ta.r, ja.r, atol=1e-6)
    ts.preload()
    np.testing.assert_array_equal(ts.get_frame(4), js.get_frame(4))
    # the avatar draws a random bank frame, or raises without a bank
    ta.random_mocap_pose(ts, rng=np.random.default_rng(1))
    ja.random_mocap_pose(js, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(ta.p, ja.p)
    with pytest.raises(FileNotFoundError):
        ta.random_mocap_pose(TSequence(str(tmp_path / "missing.dat")))


def test_data_paths_stay_in_the_checkout(tmp_path, monkeypatch):
    """With no data-root variable a data path resolves under the checkout,
    whatever the working directory; a variable naming a root that holds
    the model directory wins."""
    import os

    from avatar_tpu_torch.utils import resolve_root_path

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for env in ("AVATAR_TPU_DIR", "OPENARK_DIR", "SMPLSYNTH_DIR"):
        monkeypatch.delenv(env, raising=False)
    (tmp_path / "data" / "avatar-model").mkdir(parents=True)
    monkeypatch.chdir(tmp_path / "data")
    rel = "data/avatar-mocap/cmu-mocap.dat"
    assert resolve_root_path(rel) == os.path.join(repo, rel)
    assert TSequence().sequence_path == os.path.join(repo, rel)
    monkeypatch.setenv("OPENARK_DIR", str(tmp_path))
    assert resolve_root_path(rel) == os.path.join(str(tmp_path), rel)


# -- the host Tracker: the four scenarios of tests/test_tracking.py -----------


# LM budgets of 6 steps on (re)init frames and 3 in steady state: two
# float32 LMs agree to ~0.005 mm after 5 cold-start steps and then part at
# near-ties of the stop test (0.65 mm after 10 steps, a different optimum
# after 20; PERF.md, Findings), and the test compares the packages,
# not that conditioning.  beta_pose 0.3 as in test_torch_tracker.py.
TRACK_CFG = dict(data_interval=4, min_points=200, beta_pose=0.3,
                 frame_icp_iters=1, reinit_icp_iters=2, initial_icp_iters=2,
                 iters_per_icp=3)


def _trackers(models, tmp_path):
    """A reference and a port ``Tracker`` with ``TRACK_CFG``, each logging
    metrics."""
    jm, tm = models
    cfg = TRACK_CFG
    jt = JTracker(jm, JIntrin(**INTRIN), (H, W), config=JConfig(**cfg))
    tt = TTracker(tm, TIntrin(**INTRIN), (H, W), config=TConfig(**cfg))
    jt.open_metrics(str(tmp_path / "j.jsonl"))
    tt.open_metrics(str(tmp_path / "t.jsonl"))
    return jt, tt


def _track_both(jt, tt, xyz, mask):
    """One frame through both trackers from the reference's state: flags
    and point counts equal, joints within 1 mm."""
    from_reference(jt, into=tt)
    rj = jt.track(xyz, labels_override=mask)
    rt = tt.track(xyz, labels_override=mask)
    assert (rt.ok, rt.reinitialized, rt.n_points) == (
        rj.ok, rj.reinitialized, rj.n_points)
    assert tt.reinit == jt.reinit
    if rj.ok:
        np.testing.assert_array_equal(rt.part_mask, rj.part_mask)
        assert rt.fit_info["n_matched"] == rj.fit_info["n_matched"]
        err = np.linalg.norm(tt.ava.joint_pos - jt.ava.joint_pos, axis=1)
        assert err.max() < 1e-3, f"{err.max() * 1e3:.3f} mm"
    return rj, rt


def _metrics(jt, tt, tmp_path):
    """Both metrics logs: the same records with the same keys, and the
    same frame, flag and count values."""
    jt.close_metrics()
    tt.close_metrics()
    recs = [[json.loads(ln) for ln in (tmp_path / f).read_text().split(
        "\n") if ln] for f in ("j.jsonl", "t.jsonl")]
    assert len(recs[0]) == len(recs[1]) > 0
    for a, b in zip(*recs):
        assert a.keys() == b.keys()
        for k in ("frame", "ok", "reinit", "n_points", "n_matched",
                  "inner_iters", "part_counts"):
            assert a[k] == b[k], k


def test_tracker_sequence_matches_reference(models, sequence, planned_nn,
                                            tmp_path):
    jt, tt = _trackers(models, tmp_path)
    for i, (xyz, mask, _) in enumerate(sequence):
        rj, rt = _track_both(jt, tt, xyz, mask)
        assert rt.ok and rt.reinitialized == (i == 0)
    _metrics(jt, tt, tmp_path)


def test_tracker_loss_and_reinit_matches_reference(models, sequence,
                                                   planned_nn, tmp_path):
    jt, tt = _trackers(models, tmp_path)
    xyz, mask, _ = sequence[0]
    assert _track_both(jt, tt, xyz, mask)[1].ok
    rj, rt = _track_both(jt, tt, np.zeros_like(xyz),
                         np.full((H, W), 255, np.uint8))
    assert not rt.ok and tt.reinit
    rj, rt = _track_both(jt, tt, xyz, mask)
    assert rt.ok and rt.reinitialized and not tt.first_init
    _metrics(jt, tt, tmp_path)


def test_tracker_with_bgsub_matches_reference(models, sequence, planned_nn,
                                              tmp_path):
    jt, tt = _trackers(models, tmp_path)
    bg = _wall()
    xyz, mask, _ = sequence[0]
    scene = bg.copy()
    fg = xyz[..., 2] > 0
    scene[fg] = xyz[fg]
    jt.set_background(bg)
    tt.set_background(bg)
    rj, rt = _track_both(jt, tt, scene, mask)
    assert rt.ok and rt.n_points > 50
    assert (tt.bgsub.top_left, tt.bgsub.bot_right) == (
        jt.bgsub.top_left, jt.bgsub.bot_right)
    _metrics(jt, tt, tmp_path)


def test_tracker_render_overlay_matches_reference(models, sequence,
                                                  planned_nn, tmp_path):
    """The overlay of the tracked pose, rendered from the reference's
    pose: within one grey level of the reference's but for at most 1% of
    the body's pixels (silhouette pixels)."""
    jt, tt = _trackers(models, tmp_path)
    _track_both(jt, tt, *sequence[0][:2])
    from_reference(jt, into=tt).ava.update()
    rgb = np.full((H, W, 3), 60, np.uint8)
    oj, ot = jt.render_overlay(rgb), tt.render_overlay(rgb)
    assert ot.shape == (H, W, 3) and (ot != 60).any()
    differ = (np.abs(ot.astype(int) - oj).max(-1) > 1).sum()
    assert differ <= 0.01 * (oj != 60).any(-1).sum()
