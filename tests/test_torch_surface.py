"""Parity of the port's point-to-mesh correspondence
(``optim/surface.py``) and surface refine (``gauss_newton.fit_refine``)
with the JAX reference, plus the port's own converged-fit gate.

Inputs are made with numpy from a seed and given to both packages.  The
reference's fit runs its planned part-sorted NN (the Pallas kernel in
interpret mode) through the same monkeypatch as ``test_torch_fit.py``.
Tolerances: closest point bary and d2 within 1e-6; correspondence bary and
normals within 1e-5 (integer outputs equal); the fit's p within 1e-4 m,
rotations 1e-4, shape keys 1e-3, match counts equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avatar_tpu.core.lbs import lbs as jlbs
from avatar_tpu.core.model import Avatar as JAvatar
from avatar_tpu.io.calibration import CameraIntrin
from avatar_tpu.optim import correspond as jcorr
from avatar_tpu.optim import gauss_newton as jgn
from avatar_tpu.optim import nn_pallas
from avatar_tpu.optim import surface as jsurf
from avatar_tpu.render.renderer import AvatarRenderer as JRenderer
from avatar_tpu.testing import synthetic_model as j_synthetic_model
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.core.lbs import lbs as t_lbs
from avatar_tpu_torch.core.model import Avatar as TAvatar
from avatar_tpu_torch.optim import gauss_newton as tgn
from avatar_tpu_torch.optim import surface as tsurf
from avatar_tpu_torch.render.renderer import AvatarRenderer as TRenderer
from avatar_tpu_torch.testing import probe_samples
from avatar_tpu_torch.testing import synthetic_model as t_synthetic_model


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


def test_closest_point_triangle_all_regions():
    """The seven Voronoi regions of one triangle, then random triangles
    and points: bary and d2 within 1e-6 of the reference."""
    a = np.array([0.0, 0.0, 0.0], np.float32)
    b = np.array([1.0, 0.0, 0.0], np.float32)
    c = np.array([0.0, 1.0, 0.0], np.float32)
    pts = np.array([[0.25, 0.25, 1.0],     # interior
                    [-1.0, -1.0, 0.5],     # vertex a
                    [2.0, -0.5, 0.0],      # vertex b
                    [-0.5, 2.0, 0.2],      # vertex c
                    [0.5, -1.0, 0.0],      # edge ab
                    [-1.0, 0.5, 0.0],      # edge ac
                    [1.0, 1.0, 0.0]],      # edge bc
                   np.float32)
    want = np.array([[0.5, 0.25, 0.25], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                     [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    rng = np.random.default_rng(5)
    tri = rng.normal(0, 0.05, (512, 3, 3)).astype(np.float32)
    rp = rng.normal(0, 0.08, (512, 3)).astype(np.float32)
    for p, ta, tb, tc in ((pts, a, b, c),
                          (rp, tri[:, 0], tri[:, 1], tri[:, 2])):
        bj, dj = jsurf.closest_point_triangle(*map(jnp.asarray,
                                                   (p, ta, tb, tc)))
        bt, dt = tsurf.closest_point_triangle(*map(torch.as_tensor,
                                                   (p, ta, tb, tc)))
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    bt, _ = tsurf.closest_point_triangle(*map(torch.as_tensor,
                                              (pts, a, b, c)))
    np.testing.assert_allclose(bt.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("max_ring", [12, 4])
def test_vertex_face_rings_equal(max_ring):
    """The numpy copy equals the reference, also when rings overflow."""
    model = j_synthetic_model(detail=2)
    faces = np.asarray(model.faces)
    np.testing.assert_array_equal(
        tsurf.vertex_face_rings(faces, model.num_points(), max_ring),
        jsurf.vertex_face_rings(faces, model.num_points(), max_ring))


@pytest.mark.parametrize("front_margin", [None, 0.2])
def test_surface_correspond_matches_reference(front_margin):
    model = j_synthetic_model(detail=2)
    ava = JAvatar(model)
    ava.randomize(seed=3)
    ava.update()
    x = np.array(ava.cloud, np.float32)
    faces = np.asarray(model.faces, np.int32)
    ring = jsurf.vertex_face_rings(faces, model.num_points())
    rng = np.random.default_rng(9)
    n = 512
    fi = rng.integers(0, faces.shape[0], n)
    bw = rng.dirichlet([1.0, 1.0, 1.0], n)
    pts = ((bw[:, :, None] * x[faces[fi]]).sum(1) +
           rng.normal(0, 0.004, (n, 3))).astype(np.float32)
    # NN vertex per point (any vertex among the 3 nearest), some unmatched
    d2 = ((pts[:, None, :] - x[None]) ** 2).sum(-1)
    corr = np.argsort(d2, axis=1)[np.arange(n), rng.integers(0, 3, n)]
    corr = corr.astype(np.int32)
    corr[rng.random(n) < 0.1] = -1
    ref = jsurf.surface_correspond(jnp.asarray(pts), jnp.asarray(corr),
                                   jnp.asarray(x), jnp.asarray(faces),
                                   jnp.asarray(ring), front_margin)
    got = tsurf.surface_correspond(torch.as_tensor(pts),
                                   torch.as_tensor(corr), torch.as_tensor(x),
                                   torch.as_tensor(faces),
                                   torch.as_tensor(ring), front_margin)
    tri_j, bary_j, fn_j, valid_j = map(np.asarray, ref)
    tri_t, bary_t, fn_t, valid_t = (t.numpy() for t in got)
    np.testing.assert_array_equal(valid_t, valid_j)
    assert valid_j.sum() > n // 2      # a random pose: back faces too
    v = valid_j
    np.testing.assert_array_equal(tri_t[v], tri_j[v])
    np.testing.assert_allclose(bary_t[v], bary_j[v], atol=1e-5)
    np.testing.assert_allclose(fn_t[v], fn_j[v], atol=1e-5)


# bench.py's fit_rmse_mm probe at the quick configuration
# (tests/test_surface.py::test_converged_fit_submillimeter)
H = W = 256
INTRIN = dict(fx=220.0, fy=220.0, cx=128.0, cy=128.0)


def _probe_inputs(depth, mask, stride=2):
    """Oracle-labelled stride samples of one rendered frame."""
    depth_mm = (np.where(depth > 0, depth, 0) * 1000).astype(np.uint16)
    return probe_samples(depth_mm, mask, CameraIntrin(**INTRIN), stride)


def _gt_pose(ava):
    ava.randomize(seed=77)
    ava.w *= 0.3
    ava.p = np.array([0.0, 0.1, 2.6])
    ava.r[0] = np.diag([-1.0, 1.0, -1.0])
    ava.update()
    return ava


def _context(model):
    mp = np.arange(model.num_joints(), dtype=np.int32)[model.main_joint]
    return jgn.FitContext(
        lbs=model.params,
        anc_mask=jnp.asarray(model.ancestor_mask, model.dtype),
        faces=jnp.asarray(model.faces, jnp.int32),
        model_part=jnp.asarray(mp, jnp.int32),
        prior=jgn.PriorData(model.pose_prior.means, model.pose_prior.prec_cho,
                            model.pose_prior.consts_log))


@pytest.fixture(scope="module")
def refine_setup():
    """Ground-truth pose, fit context, rings, and 2048 samples on the
    interiors of camera-facing faces (a dominant corner, every barycentric
    coordinate >= 0.1, +-0.5 mm along the normal), labelled with the part
    of the dominant corner.  Such a point's closest surface point is
    inside its own face, so no two faces of its ring tie for it."""
    model = j_synthetic_model(detail=2)
    gt = _gt_pose(JAvatar(model))
    x = np.asarray(gt.cloud, np.float64)
    faces = np.asarray(model.faces)
    fn = np.cross(x[faces[:, 1]] - x[faces[:, 0]],
                  x[faces[:, 2]] - x[faces[:, 0]])
    fn /= np.linalg.norm(fn, axis=1, keepdims=True)
    rng = np.random.default_rng(4)
    n = 2048
    fi = rng.choice(np.where(fn[:, 2] < -0.3)[0], 4 * n)
    bw = rng.dirichlet([2.0, 2.0, 2.0], 4 * n)
    ok = (bw.max(1) > 0.5) & (bw.min(1) > 0.1)
    fi, bw = fi[ok][:n], bw[ok][:n]
    pts = ((bw[:, :, None] * x[faces[fi]]).sum(1) +
           fn[fi] * rng.uniform(-5e-4, 5e-4, (n, 1))).astype(np.float32)
    parts = np.asarray(model.main_joint)[faces[fi, np.argmax(bw, 1)]]
    ring = jsurf.vertex_face_rings(faces, model.num_points())
    theta = jgn.Theta(p=jnp.asarray(gt.p, jnp.float32),
                      rots=jnp.asarray(gt.r, jnp.float32),
                      w=jnp.asarray(gt.w, jnp.float32))
    return model, _context(model), ring, pts, parts.astype(np.int32), theta


def _both_refine(setup, beta, **kw):
    model, ctx, ring, pts, parts, theta0 = setup
    kw.update(num_parts=model.num_joints())
    b = np.float32(beta)
    ref = jgn.fit_refine(ctx, model.parents, jnp.asarray(ring),
                         jnp.asarray(pts), jnp.asarray(parts), theta0,
                         jnp.asarray(b), jnp.asarray(b), **kw)
    got = tgn.fit_refine(from_reference(ctx, "cpu"), model.parents,
                         torch.as_tensor(ring), torch.as_tensor(pts),
                         torch.as_tensor(parts), from_reference(theta0, "cpu"),
                         torch.tensor(b), torch.tensor(b), **kw)
    return ref, got


@pytest.mark.parametrize("freeze_shape", [False, True])
def test_fit_refine_step_matches_reference(refine_setup, planned_nn,
                                           freeze_shape):
    """One LM step under a prior that fixes every degree of freedom: the
    correspondences, weights, gram and solve are the reference's, so p,
    rotations and shape keys agree within the fit tolerances."""
    (th_j, dg_j), (th_t, dg_t) = _both_refine(
        refine_setup, 0.3, n_steps=1, freeze_shape=freeze_shape)
    assert int(dg_t.n_matched) == int(dg_j.n_matched) > 1900
    assert int(dg_t.inner_iters) == int(dg_j.inner_iters) == 1
    np.testing.assert_array_equal(dg_t.part_counts.numpy(),
                                  np.asarray(dg_j.part_counts))
    np.testing.assert_allclose(th_t.p.numpy(), np.asarray(th_j.p), atol=1e-4)
    np.testing.assert_allclose(th_t.rots.numpy(), np.asarray(th_j.rots),
                               atol=1e-4)
    np.testing.assert_allclose(th_t.w.numpy(), np.asarray(th_j.w), atol=1e-3)
    if freeze_shape:
        np.testing.assert_allclose(th_t.w.numpy(), np.asarray(
            refine_setup[5].w), atol=1e-4)


def _record_last_correspondences(monkeypatch):
    """Record, for both packages, the inputs of the last
    ``surface_correspond`` of a ``fit_refine``: the data rows, each row's
    nearest model vertex and the posed vertices of that linearization."""
    last = {}
    port, ref = tsurf.surface_correspond, jsurf.surface_correspond

    def port_spy(data_pts, corr, x, *args, **kw):
        last["port"] = (data_pts.numpy().copy(), corr.numpy().copy(),
                        x.numpy().copy())
        return port(data_pts, corr, x, *args, **kw)

    def keep_ref(data_pts, corr, x):
        last["ref"] = tuple(np.asarray(a) for a in (data_pts, corr, x))

    def ref_spy(data_pts, corr, x, *args, **kw):
        jax.debug.callback(keep_ref, data_pts, corr, x)
        return ref(data_pts, corr, x, *args, **kw)

    monkeypatch.setattr(tsurf, "surface_correspond", port_spy)
    monkeypatch.setattr(jsurf, "surface_correspond", ref_spy)
    return last


@pytest.mark.parametrize("freeze_shape", [False, True])
def test_fit_refine_matches_reference(refine_setup, planned_nn, monkeypatch,
                                      freeze_shape):
    """Four LM steps under a weak prior.  A round limb's twist about its
    own axis barely moves the surface, so under a weak prior float32
    noise alone sets it (1e-3 apart between the packages, and as far
    apart between the port in float32 and float64).  What the data fix is
    compared: the accepted steps, the root position within 1e-4 m, every
    posed vertex within 0.5 mm, and the last linearization's nearest
    vertex of every data row.

    The same noise moves the posed vertices of the last linearization
    apart, by up to ~0.1 mm between the packages, and between the port's
    runs at different CPU thread counts (whose sums round differently).
    A row whose two nearest vertices lie closer together than that may
    match either one, and through that vertex's one-ring surface land
    inside the trim or outside it.  So every row's nearest vertex is
    compared exactly, except a row where the packages' two choices are
    within twice the distance those vertices moved between the packages'
    iterates: there either one is a nearest vertex.  The match counts
    differ by at most the number of such rows."""
    model = refine_setup[0]
    last = _record_last_correspondences(monkeypatch)
    (th_j, dg_j), (th_t, dg_t) = _both_refine(
        refine_setup, 1e-2, n_steps=4, freeze_shape=freeze_shape)
    (d_t, c_t, x_t), (d_j, c_j, x_j) = last["port"], last["ref"]
    np.testing.assert_array_equal(d_t, d_j)
    x_t, x_j = x_t.astype(np.float64), x_j.astype(np.float64)
    ties = np.nonzero(c_t != c_j)[0]
    for i in ties:
        d = d_t[i].astype(np.float64)
        vs = (c_t[i], c_j[i])
        gap = abs(np.linalg.norm(d - x_t[vs[0]]) -
                  np.linalg.norm(d - x_t[vs[1]]))
        moved = max(np.linalg.norm(x_t[v] - x_j[v]) for v in vs)
        assert min(vs) >= 0 and gap <= 2 * moved, (i, vs, gap, moved)
    assert int(dg_j.n_matched) > 1900
    assert abs(int(dg_t.n_matched) - int(dg_j.n_matched)) <= len(ties)
    assert int(dg_t.inner_iters) == int(dg_j.inner_iters) > 0
    np.testing.assert_allclose(th_t.p.numpy(), np.asarray(th_j.p), atol=1e-4)
    v_j = np.asarray(jlbs(model.params, model.parents, th_j.w, th_j.p,
                          th_j.rots)[0])
    v_t = t_lbs(from_reference(model.params, "cpu"), model.parents, th_t.w,
                th_t.p, th_t.rots)[0].numpy()
    np.testing.assert_allclose(v_t, v_j, atol=5e-4)
    if freeze_shape:
        np.testing.assert_allclose(th_t.w.numpy(), np.asarray(
            refine_setup[5].w), atol=1e-4)


def _probe_ctx_t(model):
    mp = np.arange(model.num_joints(), dtype=np.int32)[model.main_joint]
    pp = model.pose_prior
    return tgn.FitContext(
        lbs=model.params,
        anc_mask=torch.as_tensor(model.ancestor_mask, dtype=torch.float32),
        faces=torch.as_tensor(model.faces), model_part=torch.as_tensor(mp),
        prior=tgn.PriorData(pp.means, pp.prec_cho, pp.consts_log))


def _rmse_mm(v, cloud):
    return float(np.sqrt(np.mean(np.sum((np.asarray(v) - cloud) ** 2,
                                        -1))) * 1e3)


def test_fit_rmse_probe_matches_reference(planned_nn):
    """bench.py's fit_rmse_mm probe on the reference's rendered frame:
    the port's converged-fit error within 0.2 mm of the reference's."""
    model = j_synthetic_model(detail=2)
    gt = _gt_pose(JAvatar(model))
    rend = JRenderer(gt, CameraIntrin(**INTRIN))
    pts, parts = _probe_inputs(rend.render_depth((H, W)),
                               rend.render_part_mask((H, W)))
    ring = jsurf.vertex_face_rings(np.asarray(model.faces),
                                   model.num_points())
    theta = jgn.Theta(p=jnp.asarray(gt.p, jnp.float32),
                      rots=jnp.asarray(gt.r, jnp.float32),
                      w=jnp.asarray(gt.w, jnp.float32))
    (th_j, _), (th_t, _) = _both_refine(
        (model, _context(model), ring, pts, parts, theta), 1e-4, n_steps=20)
    rmse_j = _rmse_mm(jlbs(model.params, model.parents, th_j.w, th_j.p,
                           th_j.rots)[0], gt.cloud)
    rmse_t = _rmse_mm(t_lbs(from_reference(model.params, "cpu"), model.parents,
                            th_t.w, th_t.p, th_t.rots)[0], gt.cloud)
    assert rmse_j < 1.0 and rmse_t < 1.0, (rmse_j, rmse_t)
    assert abs(rmse_t - rmse_j) < 0.2, (rmse_j, rmse_t)


def test_converged_fit_submillimeter():
    """The port's own fit_rmse_mm gate at the quick configuration: render
    with the port, refine 20 steps from the ground truth, < 1 mm."""
    model = t_synthetic_model(detail=2, device="cpu")
    gt = _gt_pose(TAvatar(model))
    rend = TRenderer(gt, CameraIntrin(**INTRIN))
    pts, parts = _probe_inputs(rend.render_depth((H, W)),
                               rend.render_part_mask((H, W)))
    ring = torch.as_tensor(tsurf.vertex_face_rings(model.faces,
                                                   model.num_points()))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    out, diag = tgn.fit_refine(
        _probe_ctx_t(model), model.parents, ring, torch.as_tensor(pts),
        torch.as_tensor(parts), tgn.Theta(f32(gt.p), f32(gt.r), f32(gt.w)),
        f32(1e-4), f32(1e-4), n_steps=20, num_parts=model.num_joints())
    v = t_lbs(model.params, model.parents, out.w, out.p, out.rots)[0]
    rmse_mm = _rmse_mm(v.numpy(), gt.cloud)
    assert int(diag.n_matched) > 300
    assert rmse_mm < 1.0, f"converged fit drifted {rmse_mm:.2f} mm off GT"


def test_fit_refine_unaligned_rows_matches_reference(refine_setup):
    """2000 rows (not a multiple of 256): both packages take their
    unplanned NN, the reference's norm-expansion scan on the CPU and the
    port's ``find_nn_stats`` (B2).  One LM step as above, the same
    tolerances."""
    model, ctx, ring, pts, parts, theta0 = refine_setup
    setup = (model, ctx, ring, pts[:2000], parts[:2000], theta0)
    (th_j, dg_j), (th_t, dg_t) = _both_refine(setup, 0.3, n_steps=1)
    assert int(dg_t.n_matched) == int(dg_j.n_matched) > 1850
    assert int(dg_t.inner_iters) == int(dg_j.inner_iters) == 1
    np.testing.assert_allclose(th_t.p.numpy(), np.asarray(th_j.p), atol=1e-4)
    np.testing.assert_allclose(th_t.rots.numpy(), np.asarray(th_j.rots),
                               atol=1e-4)
    np.testing.assert_allclose(th_t.w.numpy(), np.asarray(th_j.w), atol=1e-3)
