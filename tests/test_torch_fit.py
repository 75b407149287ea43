"""Parity of the port's ``gauss_newton.fit`` with the JAX reference.

The reference takes its CPU's unplanned NN path unless told otherwise; the
port always takes the planned part-sorted path.  So the reference runs
here with the planned path switched on and the Pallas kernel in interpret
mode (``planned_nn``), and both packages get identical state through
``avatar_tpu_torch.convert``.  Tolerances: p within 1e-4 m, rotations
within 1e-4, shape keys within 1e-3 (float32 sums in different orders,
through a few LM steps); match counts equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avatar_tpu.core import rotation as jrot
from avatar_tpu.optim import correspond as jcorr
from avatar_tpu.optim import gauss_newton as jgn
from avatar_tpu.optim import nn_pallas
from avatar_tpu.testing import synthetic_model
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.optim import gauss_newton as tgn


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
def setup():
    model = synthetic_model(detail=1)
    part = (model.main_joint % 6).astype(np.int32)      # 6 parts
    ctx = jgn.FitContext(
        lbs=model.params,
        anc_mask=jnp.asarray(model.ancestor_mask, jnp.float32),
        faces=jnp.asarray(model.faces, jnp.int32),
        model_part=jnp.asarray(part),
        prior=jgn.PriorData(model.pose_prior.means, model.pose_prior.prec_cho,
                            model.pose_prior.consts_log))
    rng = np.random.default_rng(31)
    J, K = model.num_joints(), model.num_shape_keys()
    gt = jgn.Theta(
        p=jnp.asarray([0.05, -0.02, 2.6], jnp.float32),
        rots=jrot.so3_exp(jnp.asarray(rng.normal(0, 0.25, (J, 3)),
                                      jnp.float32)),
        w=jnp.asarray(rng.normal(0, 0.3, K), jnp.float32))
    x = np.asarray(jgn._forward(ctx, model.parents, gt, True)[0])
    n = 700
    pick = rng.choice(x.shape[0], n, replace=False)
    pts = np.zeros((1024, 3), np.float32)
    pts[:n] = x[pick] + rng.normal(0, 0.003, (n, 3))
    parts = np.full(1024, -1, np.int32)
    parts[:n] = part[pick]
    parts[n - 60:n] = 6                                 # wildcards
    theta0 = jgn.Theta(
        p=gt.p + jnp.asarray([0.03, 0.02, -0.02], jnp.float32),
        rots=jnp.einsum("jab,jbc->jac", jrot.so3_exp(jnp.asarray(
            rng.normal(0, 0.05, (J, 3)), jnp.float32)), gt.rots),
        w=jnp.zeros(K, jnp.float32))
    return model, ctx, pts, parts, theta0


@pytest.mark.parametrize("freeze_shape,robust_per_part",
                         [(False, True), (True, False)])
def test_fit_matches_reference(setup, planned_nn, freeze_shape,
                               robust_per_part):
    model, ctx, pts, parts, theta0 = setup
    kw = dict(n_steps=6, num_parts=6, plane_weight=2.0, huber_k=3.0,
              robust_per_part=robust_per_part, beta_temp=0.3,
              clamp_angle=0.25, freeze_shape=freeze_shape, wild_gate=0.2,
              wild_weight=0.7)
    bp, bs = np.float32(0.03), np.float32(0.12)
    th_j, dg_j = jgn.fit(ctx, model.parents, jnp.asarray(pts),
                         jnp.asarray(parts), theta0, jnp.asarray(bp),
                         jnp.asarray(bs), **kw)
    th_t, dg_t = tgn.fit(from_reference(ctx, "cpu"), model.parents,
                         torch.as_tensor(pts), torch.as_tensor(parts),
                         from_reference(theta0, "cpu"), torch.tensor(bp),
                         torch.tensor(bs), **kw)
    np.testing.assert_allclose(th_t.p.numpy(), np.asarray(th_j.p), atol=1e-4)
    np.testing.assert_allclose(th_t.rots.numpy(), np.asarray(th_j.rots),
                               atol=1e-4)
    np.testing.assert_allclose(th_t.w.numpy(), np.asarray(th_j.w), atol=1e-3)
    assert int(dg_t.n_matched) == int(dg_j.n_matched)
    np.testing.assert_array_equal(dg_t.part_counts.numpy(),
                                  np.asarray(dg_j.part_counts))
    assert int(dg_t.inner_iters) == int(dg_j.inner_iters)
    np.testing.assert_allclose(float(dg_t.cost), float(dg_j.cost), rtol=1e-3)
    # the fit moved toward the data
    assert float(dg_t.cost) < 0.5 * float(
        tgn.fit(from_reference(ctx, "cpu"), model.parents,
                torch.as_tensor(pts), torch.as_tensor(parts),
                from_reference(theta0, "cpu"),
                torch.tensor(bp), torch.tensor(bs),
                **{**kw, "n_steps": 1})[1].cost)


def test_icp_jacobian_matches_jacfwd(setup):
    """The analytic [P,3,D] Jacobian equals torch.func.jacfwd of the posed
    cloud through the retraction at delta = 0 (mirrors
    tests/test_optimizer.py)."""
    model, ctx_j, _, _, theta_j = setup
    ctx = from_reference(ctx_j, "cpu")
    theta = from_reference(theta_j, "cpu")
    parents = model.parents
    fwd = tgn._forward(ctx, parents, theta, True)
    Rg = fwd[3]
    J_an = tgn._icp_jacobian(ctx, parents, theta, fwd)

    def posed(delta):
        th = tgn._retract(theta, delta, Rg, parents)
        return tgn._forward(ctx, parents, th, True)[0]

    J_ad = torch.func.jacfwd(posed)(torch.zeros(J_an.shape[2]))
    scale = float(J_ad.abs().max())
    assert float((J_an - J_ad).abs().max()) < 2e-5 * max(scale, 1.0)
    J_fr = tgn._icp_jacobian(ctx, parents, theta, fwd, with_shape=False)
    torch.testing.assert_close(J_fr, J_an[:, :, :J_fr.shape[2]])


def test_prior_terms_and_nanmedian(setup):
    model, ctx_j, _, _, theta_j = setup
    ctx, theta = from_reference(ctx_j, "cpu"), from_reference(theta_j, "cpu")
    Rg_j = jgn._forward(ctx_j, model.parents, theta_j, True)[3]
    ref = jgn._prior_terms(ctx_j, model.parents, theta_j, Rg_j,
                           jnp.float32(0.7), jnp.float32(0.3))
    got = tgn._prior_terms(ctx, model.parents, theta,
                           torch.as_tensor(np.array(Rg_j)), 0.7, 0.3)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=1e-5)
    x = np.array([3.0, np.nan, 1.0, 2.0, 10.0, np.nan], np.float32)
    for v in (x, x[:5], np.full(3, np.nan, np.float32)):
        np.testing.assert_equal(float(tgn._nanmedian(torch.as_tensor(v))),
                                float(jnp.nanmedian(jnp.asarray(v))))


def test_fit_unaligned_rows_matches_reference(setup):
    """N = 1000 rows (not a multiple of 256): both packages take their
    unplanned NN every step, the reference's norm-expansion scan on the
    CPU and the port's ``find_nn_stats`` (B2).  Same tolerances as the
    planned fit."""
    model, ctx, pts, parts, theta0 = setup
    pts, parts = pts[:1000], parts[:1000]
    kw = dict(n_steps=6, num_parts=6, plane_weight=2.0, huber_k=3.0,
              robust_per_part=True, beta_temp=0.3, clamp_angle=0.25,
              wild_gate=0.2, wild_weight=0.7)
    bp, bs = np.float32(0.03), np.float32(0.12)
    th_j, dg_j = jgn.fit(ctx, model.parents, jnp.asarray(pts),
                         jnp.asarray(parts), theta0, jnp.asarray(bp),
                         jnp.asarray(bs), **kw)
    th_t, dg_t = tgn.fit(from_reference(ctx, "cpu"), model.parents,
                         torch.as_tensor(pts), torch.as_tensor(parts),
                         from_reference(theta0, "cpu"), torch.tensor(bp),
                         torch.tensor(bs), **kw)
    np.testing.assert_allclose(th_t.p.numpy(), np.asarray(th_j.p), atol=1e-4)
    np.testing.assert_allclose(th_t.rots.numpy(), np.asarray(th_j.rots),
                               atol=1e-4)
    np.testing.assert_allclose(th_t.w.numpy(), np.asarray(th_j.w), atol=1e-3)
    assert int(dg_t.n_matched) == int(dg_j.n_matched) > 600
    np.testing.assert_array_equal(dg_t.part_counts.numpy(),
                                  np.asarray(dg_j.part_counts))
    assert int(dg_t.inner_iters) == int(dg_j.inner_iters)
