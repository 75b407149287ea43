"""Parity of the port's ``FusedTracker`` with the JAX reference over three
frames (one reinit, two steady-state), with the committed 3-tree forest,
background subtraction, the tracked window and the wildcard channel — the
bench's configuration at 256x256 — and both packages' fits on the planned
part-sorted NN (the reference's Pallas kernel in interpret mode).

Per frame: the strided label image and n_points are equal, the part
centres (com_pre) agree within 1e-3 px, and the pose within the fit
tolerances (p 1e-4 m, rotations 1e-4, shape keys 1e-3).  Also: the port
imports without JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

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


def _trees(cls):
    trees = [cls(p) for p in FORESTS]
    for t in trees:
        t.partmap_type = 0
    return trees


def test_fused_tracker_matches_reference(planned_nn):
    jmodel = j_synthetic_model(detail=2)
    tmodel = t_synthetic_model(detail=2)
    frames = _frames(jmodel)
    bg = np.full((H, W), WALL, np.float32)
    jt = JTracker(jmodel, CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(JRTree), config=JConfig(**CFG))
    tt = TTracker(tmodel, TIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(TRTree), config=TConfig(**CFG))
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
    tmodel = t_synthetic_model(detail=2)
    frames = _frames(jmodel)
    jt = JTracker(jmodel, CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(JRTree), config=JConfig(**CFG))
    tt = TTracker(tmodel, TIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(TRTree), config=TConfig(**CFG))
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
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
