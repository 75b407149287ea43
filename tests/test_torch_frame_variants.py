"""Parity of the port's ``_fused_frame_impl`` with the JAX reference on the
frame paths the bench configuration does not take: the full tree ensemble
(no selective walk), a single tree, the full-grid walk (no tracked window),
oracle labels without a forest, and the extremity boost.

One steady-state frame per variant, from the ground-truth pose, both
packages on the planned NN (see ``test_torch_tracker.py``, whose scene and
config this reuses).  The label image and n_points must be equal; the pose
within the fit tolerances (p 1e-4 m, rotations 1e-4, shape keys 1e-3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avatar_tpu.core import rotation as jrot
from avatar_tpu.core.model import Avatar
from avatar_tpu.io.calibration import CameraIntrin
from avatar_tpu.optim.gauss_newton import Theta as JTheta
from avatar_tpu.perception.rtree import RTree as JRTree
from avatar_tpu.render.renderer import AvatarRenderer
from avatar_tpu.testing import synthetic_model as j_synthetic_model
from avatar_tpu.tracking import TrackerConfig as JConfig
from avatar_tpu.tracking_fused import FusedTracker as JTracker
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.io.calibration import CameraIntrin as TIntrin
from avatar_tpu_torch.perception.rtree import RTree as TRTree
from avatar_tpu_torch.testing import synthetic_model as t_synthetic_model
from avatar_tpu_torch.tracking import TrackerConfig as TConfig
from avatar_tpu_torch.tracking_fused import FusedTracker as TTracker
from test_torch_tracker import (CFG, CX, CY, FORESTS, FX, FY, H, W, WALL,
                                planned_nn)  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def scene():
    """One frame, its part mask and the ground-truth pose."""
    jmodel = j_synthetic_model(detail=2)
    gt = Avatar(jmodel)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 4.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    gt.update()
    rend = AvatarRenderer(gt, CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY))
    depth = rend.render_depth((H, W))
    frame = (np.where(depth > 0, depth, WALL) * 1000).astype(np.uint16)
    mask = rend.render_part_mask((H, W))
    theta = JTheta(p=jnp.asarray(gt.p, jnp.float32),
                   rots=jnp.asarray(gt.r, jnp.float32),
                   w=jnp.asarray(gt.w, jnp.float32))
    # a start pose 2 cm and a few degrees off the truth
    pert = jrot.so3_exp(jnp.asarray(np.random.default_rng(3).normal(
        0, 0.05, (24, 3)), jnp.float32))
    theta0 = theta._replace(p=theta.p + jnp.asarray([0.02, -0.01, 0.01]),
                            rots=jnp.einsum("jab,jbc->jac", pert, theta.rots))
    return jmodel, t_synthetic_model(detail=2), frame, mask, theta0


def _trees(cls, n):
    trees = [cls(p) for p in FORESTS[:n]]
    for t in trees:
        t.partmap_type = 0
    return trees


@pytest.mark.parametrize("variant,over,n_trees", [
    ("full ensemble", dict(selective_walk=0.0), 3),
    ("single tree", dict(), 1),
    ("no window", dict(seg_window=None), 3),
    ("oracle labels", dict(), 0),
    ("extremity boost", dict(extremity_boost_n=256, wild_n=0), 3),
])
def test_frame_variant_matches_reference(scene, planned_nn, variant, over,
                                         n_trees):
    jmodel, tmodel, frame, mask, theta0 = scene
    cfg = {**CFG, **over}
    jt = JTracker(jmodel, CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(JRTree, n_trees) or None, config=JConfig(**cfg))
    tt = TTracker(tmodel, TIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(TRTree, n_trees) or None,
                  config=TConfig(**cfg))
    bg = np.full((H, W), WALL, np.float32)
    jt.set_background(bg)
    tt.set_background(bg)
    jt._theta = jt._theta_prev = theta0
    tt._theta = tt._theta_prev = from_reference(theta0)
    lab = jt._map_labels(jt._pre_stride(mask))
    out_j = jt._run(jnp.asarray(jt._pre_stride(frame)),
                    jnp.asarray(lab, jnp.uint8), 3)
    out_t = tt._run(tt._upload(tt._pre_stride(frame)),
                    torch.as_tensor(tt._map_labels(tt._pre_stride(mask))), 3)
    lab_j = np.asarray(out_j.labels_strided)
    np.testing.assert_array_equal(out_t.labels_strided.numpy(), lab_j)
    assert (lab_j != 255).sum() > 50, variant
    dj, dt = np.asarray(out_j.host_diag), out_t.host_diag.numpy()
    assert dt[0] == dj[0] > 50                      # n_points
    np.testing.assert_array_equal(dt[3:3 + tt.num_parts],
                                  dj[3:3 + tt.num_parts])  # part counts
    th_j, th_t = out_j.theta, out_t.theta
    np.testing.assert_allclose(th_t.p.numpy(), np.asarray(th_j.p), atol=1e-4)
    np.testing.assert_allclose(th_t.rots.numpy(), np.asarray(th_j.rots),
                               atol=1e-4)
    np.testing.assert_allclose(th_t.w.numpy(), np.asarray(th_j.w), atol=1e-3)
