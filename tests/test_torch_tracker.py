"""Parity of the port's ``FusedTracker`` with the JAX reference over three
frames (one reinit, two steady-state), with the committed 3-tree forest,
background subtraction, the tracked window and the wildcard channel — the
bench's configuration at 256x256 — and both packages' fits on the planned
part-sorted NN (the reference's Pallas kernel in interpret mode).

Per frame: the strided label image and n_points are equal, the part
centres (com_pre) agree within 1e-3 px, and the pose within the fit
tolerances (p 1e-4 m, rotations 1e-4, shape keys 1e-3).  Also: the port
imports without JAX.  ``warmup`` leaves the tracker as it found it, and the
metrics log has the reference's lines (integer fields equal; the cost
within 1e-3 relative, the shape-key tolerance of the fits above).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avatar_tpu.core import rotation as jrot
from avatar_tpu.core.model import Avatar
from avatar_tpu.io.calibration import CameraIntrin
from avatar_tpu.optim import correspond as jcorr
from avatar_tpu.optim import nn_pallas
from avatar_tpu.perception.partgroups import SMPL24_GROUP_LUT
from avatar_tpu.perception.rtree import RTree as JRTree
from avatar_tpu.render.renderer import AvatarRenderer
from avatar_tpu.testing import synthetic_model as j_synthetic_model
from avatar_tpu.tracking import TrackerConfig as JConfig
from avatar_tpu.tracking_fused import FusedTracker as JTracker
from avatar_tpu_torch.io.calibration import CameraIntrin as TIntrin
from avatar_tpu_torch.perception.rtree import RTree as TRTree
from avatar_tpu_torch.testing import synthetic_model as t_synthetic_model
from avatar_tpu_torch.tracking import TrackerConfig as TConfig
from avatar_tpu_torch.tracking_fused import FusedTracker as TTracker

# the bench's focal length and forest stride (the scale the forest was
# trained at), with the body far enough back to fit a 256x256 frame.  At
# this size a leg gets a handful of samples, and under the default pose
# prior (0.03) its rotation is ill-conditioned enough for float32
# summation-order noise to reach ~5e-4; beta_pose 0.3 keeps the system
# well conditioned, so the comparison tests the port, not the conditioning.
H = W = 256
FX, FY, CX, CY = 606.438, 606.351, 128.0, 128.0
WALL = 6.0
FORESTS = [f"data/bench_forest_r5{s}.srtr" for s in ("", "_1", "_2")]
CFG = dict(data_interval=3, min_points=300, rtree_interval=3,
           frame_icp_iters=1, reinit_icp_iters=1, initial_icp_iters=1,
           iters_per_icp=3, reinit_seeds=2, label_conf_thresh=0.55,
           beta_pose=0.3,
           seg_window=(252, 210), part_groups=tuple(SMPL24_GROUP_LUT))


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


def _frames(model, n=3):
    """uint16 depth frames of a moving avatar in front of a wall."""
    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 4.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(8)
    drift = rng.normal(0, 0.03, (24, 3))
    intrin = CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY)
    frames = []
    for _ in range(n):
        gt.update()
        depth = AvatarRenderer(gt, intrin).render_depth((H, W))
        frames.append((np.where(depth > 0, depth, WALL) * 1000).astype(
            np.uint16))
        step = np.asarray(jrot.so3_exp(jnp.asarray(drift, jnp.float32)))
        gt.r = np.einsum("jab,jbc->jac", step, gt.r)
        gt.p = gt.p + np.array([0.02, 0.0, 0.01])
    return frames


def _trees(cls, **kw):
    trees = [cls(p, **kw) for p in FORESTS]
    for t in trees:
        t.partmap_type = 0
    return trees


def test_fused_tracker_matches_reference(planned_nn):
    jmodel = j_synthetic_model(detail=2)
    tmodel = t_synthetic_model(detail=2, device="cpu")
    frames = _frames(jmodel)
    bg = np.full((H, W), WALL, np.float32)
    jt = JTracker(jmodel, CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(JRTree), config=JConfig(**CFG))
    tt = TTracker(tmodel, TIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(TRTree, device="cpu"), config=TConfig(**CFG))
    jt.set_background(bg)
    tt.set_background(bg)
    for i, frame in enumerate(frames):
        out_j = jt._run(jnp.asarray(jt._pre_stride(frame)), jt._zero_labels(),
                        3, use_window=i > 0, render_labels=i > 0,
                        is_reinit=i == 0)
        out_t = tt._run(tt._upload(tt._pre_stride(frame)), tt._zero_labels,
                        3, use_window=i > 0, render_labels=i > 0,
                        is_reinit=i == 0)
        lab_j = np.asarray(out_j.labels_strided)
        np.testing.assert_array_equal(out_t.labels_strided.numpy(), lab_j,
                                      err_msg=f"frame {i}")
        assert (lab_j != 255).sum() > 50, "the forest must label the body"
        dj = np.asarray(out_j.host_diag)
        dt = out_t.host_diag.numpy()
        G = tt.num_parts
        assert dt[0] == dj[0] > 50                      # n_points
        np.testing.assert_allclose(out_t.com_pre.numpy(),
                                   np.asarray(out_j.com_pre), atol=1e-3)
        np.testing.assert_allclose(dt[3 + G:3 + 3 * G], dj[3 + G:3 + 3 * G],
                                   atol=1e-3)
        th_j, th_t = out_j.theta, out_t.theta
        np.testing.assert_allclose(th_t.p.numpy(), np.asarray(th_j.p),
                                   atol=1e-4, err_msg=f"frame {i}")
        np.testing.assert_allclose(th_t.rots.numpy(), np.asarray(th_j.rots),
                                   atol=1e-4, err_msg=f"frame {i}")
        np.testing.assert_allclose(th_t.w.numpy(), np.asarray(th_j.w),
                                   atol=1e-3, err_msg=f"frame {i}")
        # advance both trackers from the same (reference) state
        jt._theta_prev = jt._theta
        jt._theta, jt.com_pre = th_j, out_j.com_pre
        tt._theta_prev = tt._theta
        tt._theta = th_t
        tt.com_pre = out_t.com_pre


def test_track_state_machine_matches_reference(planned_nn):
    """``track``: reinit with two seeds, then steady state; per frame the
    same ok / reinit flags and n_points, and joints within 1 mm.  Then an
    empty frame: both trackers declare the person lost."""
    jmodel = j_synthetic_model(detail=2)
    tmodel = t_synthetic_model(detail=2, device="cpu")
    frames = _frames(jmodel)
    jt = JTracker(jmodel, CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(JRTree), config=JConfig(**CFG))
    tt = TTracker(tmodel, TIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(TRTree, device="cpu"), config=TConfig(**CFG))
    bg = np.full((H, W), WALL, np.float32)
    jt.set_background(bg)
    tt.set_background(bg)
    for i, frame in enumerate(frames):
        rj, rt = jt.track(frame), tt.track(frame)
        assert (rt.ok, rt.reinitialized, rt.n_points) == \
            (rj.ok, rj.reinitialized, rj.n_points), f"frame {i}"
        assert rt.ok and rt.reinitialized == (i == 0)
        joints_j = jt.sync_avatar().joint_pos
        _, joints_t = tt.pose()
        err = np.linalg.norm(joints_t - joints_j, axis=1).mean()
        assert err < 1e-3, f"frame {i}: {err * 1e3:.3f} mm"
    empty = np.full((H, W), int(WALL * 1000), np.uint16)
    rj, rt = jt.track(empty), tt.track(empty)
    assert not rt.ok and not rj.ok and rt.n_points == rj.n_points == 0
    assert tt.reinit and jt.reinit


def test_port_imports_without_jax():
    """The port never imports jax or avatar_tpu: import every module in a
    fresh interpreter where ``import jax`` fails."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import avatar_tpu_torch\n"
        "for m in pkgutil.walk_packages(avatar_tpu_torch.__path__,\n"
        "                               'avatar_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.startswith('avatar_tpu') and\n"
        "       not m.startswith('avatar_tpu_torch')]\n"
        "assert not bad, bad\n"
        "assert 'avatar_tpu_torch.profiling' in sys.modules\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_fused_tracker_refine_matches_reference(planned_nn, monkeypatch):
    """Accuracy mode (``refine_every=1, refine_steps=2``): every steady
    frame re-fits its data bucket with ``fit_refine``.  Both trackers run
    from the reference's state.  Per frame the label image and n_points
    are equal, and the refine stage is called as the reference calls it:
    the same bucket, wildcard id and gate, freeze_shape, step count,
    priors scaled by refine_beta, and a start pose within the fit
    tolerances.  At this size the bucket holds ~300 samples, half of them
    wildcards, and one refine step moves vertices ~10 cm: the port in
    float32 and float64 lands 1.7 cm apart from the same inputs, so the
    refined poses themselves are compared at 720p on the card
    (``chip_smoke.py``), not here."""
    import avatar_tpu.tracking_fused as jtf
    import avatar_tpu_torch.tracking_fused as ttf
    from avatar_tpu_torch.convert import from_reference

    calls = {"j": [], "t": []}
    j_refine, t_refine = jtf.fit_refine, ttf.fit_refine

    def j_spy(ctx, parents, ring, pts, parts, theta, bp, bs, **kw):
        static = {k: kw[k] for k in ("n_steps", "num_parts", "wild",
                                     "freeze_shape")}
        jax.debug.callback(
            lambda *v: calls["j"].append((static, [np.asarray(a) for a in v])),
            pts, parts, theta.p, theta.rots, theta.w, bp, bs,
            kw["wild_gate2"])
        return j_refine(ctx, parents, ring, pts, parts, theta, bp, bs, **kw)

    def t_spy(ctx, parents, ring, pts, parts, theta, bp, bs, **kw):
        static = {k: kw[k] for k in ("n_steps", "num_parts", "wild",
                                     "freeze_shape")}
        calls["t"].append((static, [a.numpy().copy() for a in (
            pts, parts, theta.p, theta.rots, theta.w, bp, bs,
            kw["wild_gate2"])]))
        return t_refine(ctx, parents, ring, pts, parts, theta, bp, bs, **kw)

    monkeypatch.setattr(jtf, "fit_refine", j_spy)
    monkeypatch.setattr(ttf, "fit_refine", t_spy)
    jmodel = j_synthetic_model(detail=2)
    tmodel = t_synthetic_model(detail=2, device="cpu")
    frames = _frames(jmodel)
    bg = np.full((H, W), WALL, np.float32)
    cfg = dict(CFG, refine_every=1, refine_steps=2)
    jt = JTracker(jmodel, CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(JRTree), config=JConfig(**cfg))
    tt = TTracker(tmodel, TIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(TRTree, device="cpu"), config=TConfig(**cfg))
    np.testing.assert_array_equal(tt._ring.numpy(), np.asarray(jt._ring))
    jt.set_background(bg)
    tt.set_background(bg)
    for i, frame in enumerate(frames):
        kw = dict(use_window=i > 0, render_labels=i > 0, is_reinit=i == 0,
                  refine=i > 0)
        out_j = jt._run(jnp.asarray(jt._pre_stride(frame)), jt._zero_labels(),
                        3, **kw)
        out_t = tt._run(tt._upload(tt._pre_stride(frame)), tt._zero_labels,
                        3, **kw)
        np.testing.assert_array_equal(out_t.labels_strided.numpy(),
                                      np.asarray(out_j.labels_strided),
                                      err_msg=f"frame {i}")
        assert out_t.host_diag.numpy()[0] == np.asarray(out_j.host_diag)[0]
        assert len(calls["j"]) == len(calls["t"]) == i
        if i > 0:
            (sj, vj), (st, vt) = calls["j"][-1], calls["t"][-1]
            assert st == sj == dict(n_steps=2, num_parts=tt.num_parts,
                                    wild=tt.num_parts, freeze_shape=True)
            np.testing.assert_array_equal(vt[1], vj[1])          # parts
            np.testing.assert_allclose(vt[0], vj[0], atol=1e-6)  # points
            np.testing.assert_allclose(vt[2], vj[2], atol=1e-4)  # p
            np.testing.assert_allclose(vt[3], vj[3], atol=1e-4)  # rots
            np.testing.assert_allclose(vt[4], vj[4], atol=1e-3)  # w
            np.testing.assert_allclose(vt[5:], vj[5:], rtol=1e-6)
            np.testing.assert_allclose(vt[5], 0.1 * CFG["beta_pose"],
                                       rtol=1e-6)
            th = out_t.theta
            assert all(bool(torch.isfinite(a).all()) for a in th)
            assert not np.allclose(th.rots.numpy(), vt[3])  # it refined
        # advance both trackers from the reference's state
        jt._theta_prev = jt._theta
        jt._theta, jt.com_pre = out_j.theta, out_j.com_pre
        tt._theta_prev = tt._theta
        tt._theta = from_reference(out_j.theta, "cpu")
        tt.com_pre = from_reference(out_j.com_pre, "cpu")


def _snapshot(tracker):
    """Every attribute of the per-frame tracking state, and the timer's."""
    state = {k: getattr(tracker, k) for k in tracker._WARM_STATE}
    state["_starve"] = tracker._starve.copy()
    state["limb_recoveries"] = dict(tracker.limb_recoveries)
    state["_batch_q"] = list(tracker._batch_q)
    state["_pending_q"] = list(tracker._pending_q)
    state["timer.stats"] = {k: list(v) for k, v in
                            tracker.timer.stats.items()}
    return state


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], tuple):                  # a Theta
            assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_warmup_leaves_no_trace(tmp_path):
    """A warmed tracker (reinit, steady, shape-refit and refine variants,
    on a fresh tracker and again mid-sequence) is in the state it was in
    before, ``first_init`` and ``timer.stats`` included, writes nothing to
    an open metrics log, and tracks the frames of an unwarmed tracker bit
    for bit.  ``warmup(batch=2)`` also runs a batch of two and leaves
    ``batch_thetas`` and the batches and frames in flight as they were."""
    tmodel = t_synthetic_model(detail=2, device="cpu")
    frames = _frames(j_synthetic_model(detail=2))
    cfg = dict(CFG, refine_every=2, refine_steps=2, shape_refit_after=1)
    bg = np.full((H, W), WALL, np.float32)
    trackers = []
    for _ in range(2):
        t = TTracker(tmodel, TIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                     rtree=_trees(TRTree, device="cpu"), config=TConfig(**cfg))
        t.set_background(bg)
        trackers.append(t)
    cold, warm = trackers
    warm.open_metrics(str(tmp_path / "warm.jsonl"))
    calls = []
    real_run = warm._run

    def spy(*a, **kw):
        calls.append((kw.get("is_reinit", False), kw.get("refine", False),
                      kw.get("fit_shape", False)))
        return real_run(*a, **kw)

    warm._run = spy
    for i, frame in enumerate(frames):
        before = _snapshot(warm)
        del calls[:]
        warm.warmup(frame)
        variants = set(calls)
        assert variants == {(True, False, False), (False, False, False),
                            (False, False, True), (False, True, False)}
        _same_state(_snapshot(warm), before)
        assert warm.first_init == (i == 0)
        rc, rw = cold.track(frame), warm.track(frame)
        assert (rw.ok, rw.reinitialized, rw.n_points, rw.fit_info) == \
            (rc.ok, rc.reinitialized, rc.n_points, rc.fit_info)
        assert rw.ok
        for a, b in zip(warm._theta, cold._theta):
            assert torch.equal(a, b), f"frame {i}"
        assert torch.equal(warm.com_pre, cold.com_pre)
    _same_state({k: v for k, v in _snapshot(warm).items()
                 if k not in ("_metrics_file", "_metrics_frame",
                              "timer.stats")},
                {k: v for k, v in _snapshot(cold).items()
                 if k not in ("_metrics_file", "_metrics_frame",
                              "timer.stats")})
    warm.close_metrics()
    lines = (tmp_path / "warm.jsonl").read_text().splitlines()
    assert [json.loads(ln)["frame"] for ln in lines] == [0, 1, 2]
    warm.track_batch(frames[1:3])
    warm.track_batch_async(frames[1:3])           # a batch in flight
    assert warm.track_async(frames[2]) is None     # and a frame
    assert warm.batch_thetas is not None and warm._pending_q
    before = _snapshot(warm)
    batches, run_batch = [], warm._run_batch
    warm._run_batch = lambda dep_b, *a: (batches.append(len(dep_b)),
                                         run_batch(dep_b, *a))[1]
    warm.warmup(frames[0], batch=2)
    assert batches == [2]
    _same_state(_snapshot(warm), before)


def test_metrics_log_matches_reference(planned_nn, tmp_path):
    """``open_metrics`` / ``close_metrics``: over a reinit and two steady
    frames, each from the reference's state, both packages write one line
    per tracked frame with the same keys; flags, counts and per-part
    counts are equal, the cost within 1e-3 relative, and a lost frame
    writes no line."""
    from avatar_tpu_torch.convert import from_reference

    jmodel = j_synthetic_model(detail=2)
    tmodel = t_synthetic_model(detail=2, device="cpu")
    frames = _frames(jmodel)
    jt = JTracker(jmodel, CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(JRTree), config=JConfig(**CFG))
    tt = TTracker(tmodel, TIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(TRTree, device="cpu"), config=TConfig(**CFG))
    bg = np.full((H, W), WALL, np.float32)
    paths = [str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")]
    for t, path in zip((jt, tt), paths):
        t.set_background(bg)
        t.open_metrics(path)
    for frame in frames:
        assert jt.track(frame).ok and tt.track(frame).ok
        # the next frame starts from the reference's state in both
        tt._theta = from_reference(jt._theta, "cpu")
        tt._theta_prev = from_reference(jt._theta_prev, "cpu")
        tt.com_pre = from_reference(jt.com_pre, "cpu")
    empty = np.full((H, W), int(WALL * 1000), np.uint16)
    assert not jt.track(empty).ok and not tt.track(empty).ok
    jt.close_metrics()
    tt.close_metrics()
    tt.close_metrics()                      # closing twice is harmless
    lines_j, lines_t = ([json.loads(ln) for ln in open(p)] for p in paths)
    assert len(lines_j) == len(lines_t) == len(frames)
    for i, (rj, rt) in enumerate(zip(lines_j, lines_t)):
        assert rt.keys() == rj.keys(), f"frame {i}"
        assert {"frame", "ok", "reinit", "n_points", "cost", "n_matched",
                "part_counts", "hard_overflow"} <= rt.keys()
        assert ("reinit_ms" in rt) and (i == 0 or "frame_ms" in rt)
        for k in ("frame", "ok", "reinit", "n_points", "n_matched",
                  "part_counts"):
            assert rt[k] == rj[k], (i, k)
        assert rt["frame"] == i and rt["reinit"] == (i == 0)
        np.testing.assert_allclose(rt["cost"], rj["cost"], rtol=1e-3)
        np.testing.assert_allclose(rt["hard_overflow"], rj["hard_overflow"],
                                   atol=1e-6)
        assert all(rt[k] > 0 for k in rt if k.endswith("_ms"))
