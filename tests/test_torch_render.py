"""Parity of the port's renderer (``render/raster.py``,
``render/renderer.py``) with the JAX reference.

The raster cases of ``tests/test_render.py`` (one triangle, occlusion in
either face order, budget overflow) give equal face ids and dropped-slot
counts.  On a posed detail-2 avatar at 256x256: face ids equal on >=
99.9% of pixels (a pixel whose two candidate faces' quantized depth keys
tie may go either way under float32 noise); where they are equal, depth
within 1e-5 m and the part mask equal.  Lambert within 1 grey level on
>= 99.9% of pixels.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avatar_tpu.core.model import Avatar as JAvatar
from avatar_tpu.io.calibration import CameraIntrin
from avatar_tpu.render import raster as jraster
from avatar_tpu.render import renderer as jrenderer
from avatar_tpu.testing import synthetic_model as j_synthetic_model
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.core.model import Avatar as TAvatar
from avatar_tpu_torch.io.calibration import CameraIntrin as TIntrin
from avatar_tpu_torch.render import raster as traster
from avatar_tpu_torch.render import renderer as trenderer
from avatar_tpu_torch.testing import synthetic_model as t_synthetic_model

TRI = [[0, 1, 2]]
RASTER_CASES = {
    "single_triangle": ([[10.0, 10.0], [30.0, 10.0], [10.0, 30.0]],
                        [2.0, 2.0, 2.0], TRI, 64, 4096),
    "depth_gradient": ([[0.0, 0.0], [40.0, 0.0], [0.0, 40.0]],
                       [1.0, 3.0, 1.0], TRI, 64, 4096),
    "occlusion_far_first": ([[5.0, 5.0], [25.0, 5.0], [5.0, 25.0]] * 2,
                            [3.0, 3.0, 3.0, 1.0, 1.0, 1.0],
                            [[0, 1, 2], [3, 4, 5]], 32, 2048),
    "occlusion_near_first": ([[5.0, 5.0], [25.0, 5.0], [5.0, 25.0]] * 2,
                             [3.0, 3.0, 3.0, 1.0, 1.0, 1.0],
                             [[3, 4, 5], [0, 1, 2]], 32, 2048),
    "budget_overflow": ([[0.0, 0.0], [60.0, 0.0], [0.0, 60.0]],
                        [1.0, 1.0, 1.0], TRI, 64, 16),
}


@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_rasterize_cases(case):
    proj, z, faces, size, budget = RASTER_CASES[case]
    proj = np.asarray(proj, np.float32)
    z = np.asarray(z, np.float32)
    faces = np.asarray(faces, np.int32)
    ref = jraster.rasterize(jnp.asarray(proj), jnp.asarray(z),
                            jnp.asarray(faces), size, size, budget=budget)
    got = traster.rasterize(torch.as_tensor(proj), torch.as_tensor(z),
                            torch.as_tensor(faces), size, size, budget)
    ref = from_reference(ref, "cpu")
    np.testing.assert_array_equal(got.fid.numpy(), ref.fid.numpy())
    assert int(got.n_dropped) == int(ref.n_dropped)
    np.testing.assert_allclose(got.depth.numpy(), ref.depth.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got.bary.numpy(), ref.bary.numpy(),
                               atol=1e-5)
    if case == "budget_overflow":
        assert int(got.n_dropped) > 0
    elif case.startswith("occlusion"):
        assert got.depth[10, 10] == pytest.approx(1.0, abs=1e-4)


def test_rasterize_rejects_aliased_face_ids():
    """The reference's int32 key packs 14 bits of face id and aliases
    larger meshes silently; the port's key takes as many bits as the face
    count needs: of 2^14 + 1 faces, the last alone covers a triangle of
    pixels and is drawn there as itself, not as face 0."""
    F = (1 << traster.FID_BITS) + 1
    proj = torch.tensor([[0.0, 0.0], [7.0, 0.0], [0.0, 7.0]])
    z = torch.ones(3)
    faces = torch.zeros((F, 3), dtype=torch.int32)
    faces[-1] = torch.tensor([0, 1, 2], dtype=torch.int32)
    out = traster.rasterize(proj, z, faces, 8, 8, F + 64)
    assert int(out.n_dropped) == 0
    # pixel (0, 0): every degenerate face and the last tie; the lowest id
    assert int(out.fid[0, 0]) == 0
    assert int((out.fid == F - 1).sum()) > 20
    assert int(out.fid.max()) == F - 1


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def test_raster_keys_up_to_2_14_faces_are_the_int32_keys():
    g = torch.Generator().manual_seed(3)
    zq = torch.randint(1, 1 << traster.Z_BITS, (4096,), generator=g,
                       dtype=torch.int32)
    for n_faces in (100, 1 << 14):
        face = torch.randint(0, n_faces, (4096,), generator=g)
        keys, bits = traster.fragment_keys(zq, face, n_faces)
        assert bits == 14 and keys.dtype == torch.int64
        assert torch.equal(keys, (zq << 14) | (face.to(torch.int32) &
                                               ((1 << 14) - 1)))
    assert traster.fragment_keys(zq, face, (1 << 14) + 1)[1] == 15


def test_raster_outputs_up_to_2_14_faces_stay_the_same():
    """Every output of a raster of 60 random faces over two frames, to the
    bit, as the int32 key gave them before the wider key."""
    rng = np.random.default_rng(5)
    P, F, H, W = 90, 60, 48, 64
    proj = torch.as_tensor(rng.uniform([-5, -5], [W + 5, H + 5], (2, P, 2)),
                           dtype=torch.float32)
    z = torch.as_tensor(rng.uniform(1.0, 5.0, (2, P)), dtype=torch.float32)
    faces = torch.as_tensor(np.stack([rng.permutation(P)[:3]
                                      for _ in range(F)]), dtype=torch.int32)
    r = traster.rasterize_batch(proj, z, faces, H, W, 200000)
    assert [t.dtype for t in r] == [torch.int32, torch.float32,
                                    torch.float32, torch.int32]
    assert int((r.fid >= 0).sum()) == 5795
    assert _digest(t.numpy() for t in r) == \
        "53a21da0eacd887d33b250993d7627dfc235ee5bcb550353d373d7f0c96608f1"


def test_raster_past_2_14_faces_is_a_brute_force_zbuffer():
    """2^14 small faces and 300 large ones over a 32x24 image: the winning
    face of every pixel is that of a per-pixel search over every face, by
    the 17-bit depth and then the lowest face id; faces numbered above
    2^14 win some pixels."""
    rng = np.random.default_rng(11)
    H, W, n_small, n_large = 24, 32, 1 << 14, 300
    F = n_small + n_large
    centre = np.concatenate([rng.uniform(0, W, (F, 1)),
                             rng.uniform(0, H, (F, 1))], 1)
    size = np.r_[np.full(n_small, 2.0), np.full(n_large, 9.0)][:, None, None]
    angle = rng.uniform(0, 2 * np.pi, (F, 1)) + np.array([0.0, 2.1, 4.2])
    corners = centre[:, None] + size * np.stack([np.cos(angle),
                                                 np.sin(angle)], -1)
    proj = torch.as_tensor(corners.reshape(1, 3 * F, 2), dtype=torch.float32)
    z = torch.as_tensor(rng.uniform(1.0, 6.0, (1, 3 * F)),
                        dtype=torch.float32)
    faces = torch.arange(3 * F, dtype=torch.int32).reshape(F, 3)
    r = traster.rasterize_batch(proj, z, faces, H, W, 600000)
    assert int(r.n_dropped[0]) == 0

    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    px, py = xx.reshape(-1, 1), yy.reshape(-1, 1)              # [HW, 1]
    a, b, c = (proj[0, faces[:, k].long()][None] for k in range(3))
    w1, w2, w3 = traster._barycentric(px, py, a, b, c)         # [HW, F]
    za, zb, zc = (z[0, faces[:, k].long()][None] for k in range(3))
    zi = w1 * za + w2 * zb + w3 * zc
    inside = (w1 >= -1e-6) & (w2 >= -1e-6) & (w3 >= -1e-6) & (zi > 0)
    zq = torch.clamp(zi / traster.Z_MAX_DEFAULT * float(1 << traster.Z_BITS),
                     1.0, float((1 << traster.Z_BITS) - 1)).to(torch.int64)
    key = torch.where(inside, zq * F + torch.arange(F),
                      torch.iinfo(torch.int64).max)
    best = key.min(1).values
    want = torch.where(best < torch.iinfo(torch.int64).max, best % F, -1)
    got = r.fid[0].reshape(-1).long()
    assert torch.equal(got, want)
    assert (got >= 1 << 14).sum() > 20 and (
        (got >= 0) & (got < 1 << 14)).sum() > 20


H = W = 256
INTRIN = dict(fx=220.0, fy=220.0, cx=128.0, cy=128.0)


@pytest.fixture(scope="module")
def posed():
    jm = j_synthetic_model(detail=2)
    tm = t_synthetic_model(detail=2, device="cpu")
    ja = JAvatar(jm)
    ja.randomize(seed=20)
    ja.p = np.array([0.0, 0.1, 2.6])
    ja.r[0] = np.diag([-1.0, 1.0, -1.0])
    ja.update()
    ta = from_reference(ja, model=tm)
    ta.update()
    return ja, ta


def test_render_frame_matches_reference(posed):
    ja, ta = posed
    faces = np.asarray(ja.model.faces, np.int32)
    vp = np.asarray(ja.model.main_joint, np.int32)
    budget = jraster.default_budget(H, W, faces.shape[0])
    assert budget == traster.default_budget(H, W, faces.shape[0])
    ref = jrenderer.render_frame(jnp.asarray(ja.cloud, jnp.float32),
                                 jnp.asarray(faces), jnp.asarray(vp),
                                 *INTRIN.values(), H, W, budget)
    got = trenderer.render_frame(torch.as_tensor(ta.cloud),
                                 torch.as_tensor(faces), torch.as_tensor(vp),
                                 *INTRIN.values(), H, W, budget)
    fid_j = np.asarray(ref.fid)
    fid_t = got.fid.numpy()
    same = fid_t == fid_j
    assert (fid_j >= 0).sum() > 2000
    assert same.mean() >= 0.999, f"{(~same).sum()} pixels differ"
    assert int(got.n_dropped) == int(ref.n_dropped) == 0
    np.testing.assert_allclose(got.depth.numpy()[same],
                               np.asarray(ref.depth)[same], atol=1e-5)
    np.testing.assert_array_equal(got.part_mask.numpy()[same],
                                  np.asarray(ref.part_mask)[same])
    # edge-on winners are background in both
    assert ((got.part_mask.numpy() == 255) == (got.depth.numpy() == 0)).all()


def test_render_lambert_matches_reference(posed):
    ja, ta = posed
    faces = np.asarray(ja.model.faces, np.int32)
    budget = jraster.default_budget(H, W, faces.shape[0])
    ref = np.asarray(jrenderer.render_lambert(
        jnp.asarray(ja.cloud, jnp.float32), jnp.asarray(faces),
        *INTRIN.values(), H, W, budget)).astype(int)
    got = trenderer.render_lambert(
        torch.as_tensor(ta.cloud), torch.as_tensor(faces),
        *INTRIN.values(), H, W, budget).numpy().astype(int)
    assert (ref > 0).sum() > 2000
    diff = np.abs(got - ref)
    assert diff.max() <= 1, f"{(diff > 1).sum()} pixels differ by > 1"


def test_avatar_renderer_matches_reference(posed):
    ja, ta = posed
    part_map = np.arange(24, dtype=np.int32)[::-1].copy()
    jr = jrenderer.AvatarRenderer(ja, CameraIntrin(**INTRIN), part_map)
    tr = trenderer.AvatarRenderer(ta, TIntrin(**INTRIN), part_map)
    np.testing.assert_allclose(tr.get_projected_points(),
                               jr.get_projected_points(), atol=1e-3)
    np.testing.assert_allclose(tr.get_projected_joints(),
                               jr.get_projected_joints(), atol=1e-3)
    fid_t, fid_j = tr.renderFaces((H, W)), np.asarray(jr.render_faces((H, W)))
    same = fid_t == fid_j
    assert same.mean() >= 0.999
    np.testing.assert_allclose(tr.renderDepth((H, W))[same],
                               np.asarray(jr.render_depth((H, W)))[same],
                               atol=1e-5)
    mask_t = tr.renderPartMask((H, W))
    np.testing.assert_array_equal(
        mask_t[same], np.asarray(jr.render_part_mask((H, W)))[same])
    assert set(np.unique(mask_t)) <= set(part_map.tolist()) | {255}
    assert tr.renderLambert((H, W)).dtype == np.uint8
    # the cache holds until update() after a pose change
    ta.p = ta.p + np.array([0.05, 0.0, 0.0])
    ta.update()
    np.testing.assert_array_equal(tr.render_faces((H, W)), fid_t)
    tr.update()
    assert not np.array_equal(tr.render_faces((H, W)), fid_t)
    ta.p = ta.p - np.array([0.05, 0.0, 0.0])
    ta.update()


def test_renderer_requires_update():
    ta = TAvatar(t_synthetic_model(detail=1, device="cpu"))
    with pytest.raises(RuntimeError):
        trenderer.AvatarRenderer(ta, TIntrin(**INTRIN)).render_depth((32, 32))
