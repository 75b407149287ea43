"""The LM loop of ``gauss_newton.fit`` and ``fit_refine`` as step
functions over static buffers (the port's counterpart of the reference's
compiled ``lax.while_loop``; on the card each step is a replayed CUDA graph,
here the same functions run uncaptured).

* The restructured fits against the JAX reference on the same numpy-seeded
  inputs, at the tolerances of ``test_torch_fit.py`` and
  ``test_torch_surface.py``: p within 1e-4 m, rotations within 1e-4, shape
  keys within 1e-3, match counts, part counts and accepted steps equal.
  The reference runs its planned NN in interpret mode where the port plans.
* A step reads nothing from the device and builds no tensor from host
  data: the step functions run under a guard that fails on ``item``,
  ``tolist``, ``__bool__``, ``__int__``, ``__float__`` and
  ``torch.tensor``.
* Nothing per call is baked into a program: fits that reuse a program
  with other numbers and another context equal fresh fits to the bit.
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
from avatar_tpu.optim import surface as jsurf
from avatar_tpu.testing import synthetic_model
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.optim import gauss_newton as tgn

NP = 6


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
    """A detail-1 model, its fit context with 6 parts, a ground-truth pose,
    a start near it, and 700 noisy samples of the posed model (the last 60
    wildcards) padded to 2048 rows: ``test_torch_fit.py``'s inputs, with
    more padding."""
    model = synthetic_model(detail=1)
    part = (model.main_joint % NP).astype(np.int32)
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
    pts = np.zeros((2048, 3), np.float32)
    pts[:n] = x[pick] + rng.normal(0, 0.003, (n, 3))
    parts = np.full(2048, -1, np.int32)
    parts[:n] = part[pick]
    parts[n - 60:n] = NP                                # wildcards
    theta0 = jgn.Theta(
        p=gt.p + jnp.asarray([0.03, 0.02, -0.02], jnp.float32),
        rots=jnp.einsum("jab,jbc->jac", jrot.so3_exp(jnp.asarray(
            rng.normal(0, 0.05, (J, 3)), jnp.float32)), gt.rots),
        w=jnp.zeros(K, jnp.float32))
    return model, ctx, pts, parts, theta0, gt


def _surface_samples(model, gt, n, seed):
    """``n`` points on the interiors of camera-facing faces of the posed
    model (every barycentric coordinate >= 0.1, one above 0.5, +-0.5 mm
    along the normal), labelled with the dominant corner's part: each
    point's closest surface point is inside its own face, so no two faces
    of a ring tie for it (the sampler of ``test_torch_surface.py``)."""
    x = np.asarray(jgn._forward(_context(model), model.parents, gt,
                                True)[0], np.float64)
    faces = np.asarray(model.faces)
    fn = np.cross(x[faces[:, 1]] - x[faces[:, 0]],
                  x[faces[:, 2]] - x[faces[:, 0]])
    fn /= np.linalg.norm(fn, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    fi = rng.choice(np.where(fn[:, 2] < -0.3)[0], 4 * n)
    bw = rng.dirichlet([2.0, 2.0, 2.0], 4 * n)
    ok = (bw.max(1) > 0.5) & (bw.min(1) > 0.1)
    fi, bw = fi[ok][:n], bw[ok][:n]
    pts = ((bw[:, :, None] * x[faces[fi]]).sum(1) +
           fn[fi] * rng.uniform(-5e-4, 5e-4, (n, 1))).astype(np.float32)
    parts = np.asarray(model.main_joint)[faces[fi, np.argmax(bw, 1)]]
    return pts, parts.astype(np.int32)


def _context(model):
    """The refine's context: every joint its own part."""
    mp = np.arange(model.num_joints(), dtype=np.int32)[model.main_joint]
    return jgn.FitContext(
        lbs=model.params,
        anc_mask=jnp.asarray(model.ancestor_mask, jnp.float32),
        faces=jnp.asarray(model.faces, jnp.int32),
        model_part=jnp.asarray(mp, jnp.int32),
        prior=jgn.PriorData(model.pose_prior.means, model.pose_prior.prec_cho,
                            model.pose_prior.consts_log))


# the fit's configurations: the fused tracker's steady frame (shape frozen,
# per-part robust scales, temporal prior and motion clamp), a reinit-sized
# bucket (shape free, no temporal prior or clamp), the median robust scale,
# the per-part scales with the shape free, and an unaligned row count (the
# unplanned NN, B2).  The reinit-sized fit takes 3 steps: with the shape
# free and no temporal prior the fit is ill-conditioned, and two float32
# implementations part there after a few steps (4e-4 in rotation after 6
# steps on these inputs; ROADMAP §C)
FIT_CASES = {
    "steady": (1024, dict(freeze_shape=True, robust_per_part=True,
                          beta_temp=0.3, clamp_angle=0.25)),
    "reinit_sized": (2048, dict(robust_per_part=True, beta_temp=0.0,
                                clamp_angle=0.0, n_steps=3)),
    "freeze_shape_median": (1024, dict(freeze_shape=True, beta_temp=0.3,
                                       clamp_angle=0.25)),
    "robust_per_part": (1024, dict(robust_per_part=True, beta_temp=0.3,
                                   clamp_angle=0.25)),
    "unaligned": (1000, dict(robust_per_part=True, beta_temp=0.3,
                             clamp_angle=0.25)),
}


def _check_theta(th_t, dg_t, th_j, dg_j, w_atol=1e-3):
    np.testing.assert_allclose(th_t.p.numpy(), np.asarray(th_j.p), atol=1e-4)
    np.testing.assert_allclose(th_t.rots.numpy(), np.asarray(th_j.rots),
                               atol=1e-4)
    np.testing.assert_allclose(th_t.w.numpy(), np.asarray(th_j.w),
                               atol=w_atol)
    assert int(dg_t.n_matched) == int(dg_j.n_matched)
    np.testing.assert_array_equal(dg_t.part_counts.numpy(),
                                  np.asarray(dg_j.part_counts))
    assert int(dg_t.inner_iters) == int(dg_j.inner_iters) > 0


@pytest.mark.parametrize("case", [*FIT_CASES, "refine"])
def test_restructured_fit_matches_reference(setup, planned_nn, case):
    model, ctx, pts, parts, theta0, gt = setup
    if case == "refine":
        # one LM step under a prior that fixes every degree of freedom,
        # from the ground truth: correspondences, weights, gram and solve
        # are the reference's (test_torch_surface.py's step case)
        rctx = _context(model)
        rpts, rparts = _surface_samples(model, gt, 1024, 4)
        ring = jsurf.vertex_face_rings(np.asarray(model.faces),
                                       model.num_points())
        b = np.float32(0.3)
        kw = dict(n_steps=1, num_parts=model.num_joints(),
                  freeze_shape=True)
        th_j, dg_j = jgn.fit_refine(
            rctx, model.parents, jnp.asarray(ring), jnp.asarray(rpts),
            jnp.asarray(rparts), gt, jnp.asarray(b), jnp.asarray(b), **kw)
        th_t, dg_t = tgn.fit_refine(
            from_reference(rctx, "cpu"), model.parents,
            torch.as_tensor(ring), torch.as_tensor(rpts),
            torch.as_tensor(rparts), from_reference(gt, "cpu"),
            torch.tensor(b), torch.tensor(b), **kw)
        assert int(dg_t.n_matched) > 900
        _check_theta(th_t, dg_t, th_j, dg_j)
        return
    n_rows, extra = FIT_CASES[case]
    kw = dict(n_steps=6, num_parts=NP, plane_weight=2.0, huber_k=3.0,
              wild_gate=0.2, wild_weight=0.7)
    kw.update(extra)
    bp, bs = np.float32(0.03), np.float32(0.12)
    th_j, dg_j = jgn.fit(ctx, model.parents, jnp.asarray(pts[:n_rows]),
                         jnp.asarray(parts[:n_rows]), theta0,
                         jnp.asarray(bp), jnp.asarray(bs), **kw)
    th_t, dg_t = tgn.fit(from_reference(ctx, "cpu"), model.parents,
                         torch.as_tensor(pts[:n_rows]),
                         torch.as_tensor(parts[:n_rows]),
                         from_reference(theta0, "cpu"), torch.tensor(bp),
                         torch.tensor(bs), **kw)
    _check_theta(th_t, dg_t, th_j, dg_j)
    np.testing.assert_allclose(float(dg_t.cost), float(dg_j.cost), rtol=1e-3)
    assert dg_t.corr.shape == (n_rows,) and int(
        (dg_t.corr >= 0).sum()) == int(dg_t.n_matched)


def _port_inputs(setup, n_rows=1024):
    model, ctx, pts, parts, theta0, _ = setup
    return (model, from_reference(ctx, "cpu"), torch.as_tensor(pts[:n_rows]),
            torch.as_tensor(parts[:n_rows]), from_reference(theta0, "cpu"))


def _ring(model):
    return torch.as_tensor(jsurf.vertex_face_rings(
        np.asarray(model.faces), model.num_points()))


@pytest.mark.parametrize("case", ["fit_planned", "fit_unplanned",
                                  "refine_planned"])
def test_step_functions_read_nothing_from_the_device(setup, monkeypatch,
                                                     case):
    """Both step functions of a program, run again after its fit, under a
    guard on every Python-level host read and on ``torch.tensor``."""
    model, ctx, pts, parts, theta0 = _port_inputs(
        setup, 1000 if case == "fit_unplanned" else 1024)
    programs = {}
    if case.startswith("fit"):
        tgn.fit(ctx, model.parents, pts, parts, theta0, 0.03, 0.12,
                n_steps=3, num_parts=NP, robust_per_part=True,
                freeze_shape=True, beta_temp=0.3, programs=programs)
    else:
        tgn.fit_refine(ctx, model.parents, _ring(model), pts, parts, theta0,
                       0.01, 0.01, n_steps=3, num_parts=NP, wild=NP,
                       wild_gate2=0.04, freeze_shape=True, programs=programs)
    (prog,) = programs.values()

    def refuse(name):
        def raising(*a, **k):
            raise AssertionError(f"{name} inside an LM step")
        return raising

    for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    monkeypatch.setattr(torch, "tensor", refuse("torch.tensor"))
    before = prog.b.accepted.clone()
    prog.fns["lin"]()
    prog.fns["step"]()
    monkeypatch.undo()
    assert int(prog.b.accepted) >= int(before)
    assert prog.b.flags.dtype == torch.bool and prog.b.flags.shape == (2,)


def _snapshot(out):
    th, dg = out
    return [t.numpy().tobytes() for t in (*th, dg.cost, dg.n_matched,
                                          dg.inner_iters, dg.part_counts,
                                          dg.corr)]


@pytest.mark.parametrize("which", ["fit", "refine", "fit_cand_mask"])
def test_reused_programs_equal_fresh_fits(setup, which):
    """Fits through one program with other prior weights, wildcard gate
    and weight, each equal to the same fit made by a fresh program, to the
    bit; a fit with a second context under the same key rebuilds the
    program, and a context that differs only in its candidate mask (a new
    one per fit, as ``AvatarOptimizer`` makes it) reuses it."""
    model, ctx_a, pts, parts, theta0 = _port_inputs(setup)
    ring = _ring(model)
    P = ctx_a.model_part.shape[0]
    if which == "fit_cand_mask":
        ctxs = [ctx_a._replace(cand_mask=torch.as_tensor(
            np.arange(P) % s == 0)) for s in (2, 3, 2, 1)]
    else:
        # a second context: other part labels, so another plan and other
        # matches
        ctx_b = ctx_a._replace(model_part=torch.remainder(
            ctx_a.model_part + 1, NP).to(torch.int32))
        ctxs = [ctx_a, ctx_a, ctx_b, ctx_a]
    calls = list(zip(ctxs, (0.03, 0.3, 0.01, 0.1), (0.12, 0.05, 0.2, 0.1),
                     (0.2, 0.1, 0.3, 0.15), (0.7, 1.0, 0.5, 0.9)))

    def run(programs, ctx, bp, bs, gate, wild_weight):
        if which != "refine":
            return tgn.fit(ctx, model.parents, pts, parts, theta0,
                           torch.tensor(bp), torch.tensor(bs), n_steps=8,
                           num_parts=NP, robust_per_part=True,
                           freeze_shape=True, beta_temp=0.3,
                           clamp_angle=0.25, wild_gate=gate,
                           wild_weight=wild_weight, programs=programs)
        # the tracker's refine: priors scaled by refine_beta, the gate
        # squared
        refine_beta = wild_weight
        return tgn.fit_refine(ctx, model.parents, ring, pts, parts, theta0,
                              bp * refine_beta, bs * refine_beta, n_steps=4,
                              num_parts=NP, wild=NP,
                              wild_gate2=torch.tensor(gate * gate),
                              freeze_shape=True, programs=programs)

    fresh = [_snapshot(run({}, *call)) for call in calls]
    programs, used = {}, []
    reused = []
    for call in calls:
        reused.append(_snapshot(run(programs, *call)))
        used.append({id(p): p for p in programs.values()})
    for i, (a, b) in enumerate(zip(fresh, reused)):
        assert a == b, f"call {i}: a reused program differs from a fresh one"
    assert fresh[0] != fresh[1]             # the numbers do reach the fit
    assert used[1] == used[0]               # the second fit reused it
    if which == "fit_cand_mask":
        assert all(u == used[0] for u in used)
    else:
        assert all(p.ctx is ctx_a for p in programs.values())
