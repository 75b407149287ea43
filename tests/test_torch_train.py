"""Parity of the port's forest training (``avatar_tpu_torch/train``, the
format writers, the ``rtree_train`` / ``rtree_transfer`` tools) with the
JAX reference, on the CPU at small sizes.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart.  Stated tolerances: probe scores within 1e-6 (they are
differences of cached depths, equal in practice); min/max, histogram
counts, assignments and host samples equal; gains within rtol 1e-5 of the
largest entropy term (the gains are differences of ``n log n`` terms, so
their rounding error scales with those terms, not with the gain); a tree
grown by both packages from one in-memory frame source equal in ``u``,
``v``, ``lnode``, ``rnode`` and ``leafid``, ``thresh`` within rtol 1e-6
and ``leaf_data`` within 1e-6.  The two packages' synthetic generators
draw from different random streams, so the port's own synthetic path is
held by its properties (same id same frame, resume, accuracy).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avatar_tpu.core.lbs import lbs as j_lbs
from avatar_tpu.core.pose_prior import GaussianMixture as JGaussianMixture
from avatar_tpu.io import formats as jformats
from avatar_tpu.io.calibration import CameraIntrin as JIntrin
from avatar_tpu.render.renderer import render_frame as j_render_frame
from avatar_tpu.testing import synthetic_model as j_synthetic_model
from avatar_tpu.train import forest as jforest
from avatar_tpu.train import synth as jsynth
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.core.lbs import lbs as t_lbs
from avatar_tpu_torch.io import formats as tformats
from avatar_tpu_torch.io.calibration import CameraIntrin as TIntrin
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.render import raster as traster
from avatar_tpu_torch.render.renderer import render_frame as t_render_frame
from avatar_tpu_torch.testing import synthetic_model as t_synthetic_model
from avatar_tpu_torch.testing import synthetic_pose_prior
from avatar_tpu_torch.train import forest as tforest
from avatar_tpu_torch.train import synth as tsynth

H = W = 128
INTRIN = dict(fx=120.0, fy=120.0, cx=64.0, cy=64.0)
N_FRAMES = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jmodel():
    return j_synthetic_model(detail=1)


@pytest.fixture(scope="module")
def tmodel():
    return t_synthetic_model(detail=1, device="cpu")


@pytest.fixture(scope="module")
def scene(jmodel):
    """16 poses drawn by the reference's generator and their frames,
    rendered once by the JAX side: what both packages are fed."""
    src = jsynth.make_source(jmodel, JIntrin(**INTRIN), n_images=N_FRAMES,
                             seed=3)
    n_keys = jmodel.num_shape_keys()
    ids = jnp.arange(N_FRAMES, dtype=jnp.int32)
    w, p, rots = jax.vmap(
        lambda i: jsynth.sample_pose(src, i, 3, n_keys))(ids)
    budget = traster.default_budget(H, W, int(src.faces.shape[0]))

    def one(w, p, rots):
        cloud = j_lbs(src.lbs, jmodel.parents, w, p, rots)[0]
        fr = j_render_frame(cloud, src.faces, src.vertex_part, *src.intrin,
                            H, W, budget)
        return fr.fid, fr.depth, fr.part_mask

    fid, depth, mask = jax.jit(jax.vmap(one))(w, p, rots)
    return dict(src=src, w=np.asarray(w), p=np.asarray(p),
                rots=np.asarray(rots), fid=np.asarray(fid),
                depth=np.asarray(depth), mask=np.asarray(mask),
                budget=budget)


class MemorySource:
    """A frame source held in memory (``size()`` / ``load_batch(ids)``),
    given to both packages' trainers."""

    def __init__(self, depth, mask):
        self.depth, self.mask = depth, mask

    def size(self):
        return len(self.depth)

    def load_batch(self, ids):
        ids = np.asarray(ids)
        return self.depth[ids], self.mask[ids]


@pytest.fixture(scope="module")
def source(scene):
    return MemorySource(scene["depth"], scene["mask"])


# ---------------------------------------------------------------------------
# the frame generator
# ---------------------------------------------------------------------------


def test_render_poses_matches_reference(scene, jmodel):
    """The same (w, p, rots) through ``jax.vmap(lbs + render_frame)`` and
    ``render_poses``: face ids, part masks and depth.  A pixel whose two
    candidate faces' quantized depth keys tie may go to either face under
    float32 noise in the skinned cloud (see test_torch_render.py), so
    equality is held on >= 99.9% of pixels and everything else where the
    face ids agree."""
    tsrc = from_reference(scene["src"], "cpu")
    t = lambda k: torch.tensor(scene[k])
    depth, mask, joints = tsynth.render_poses(
        tsrc, jmodel.parents, t("w"), t("p"), t("rots"), H, W)
    fid = torch.stack([t_render_frame(
        t_lbs(tsrc.lbs, jmodel.parents, t("w")[b], t("p")[b],
              t("rots")[b])[0], tsrc.faces, tsrc.vertex_part,
        *tsrc.intrin, H, W, scene["budget"]).fid
        for b in range(N_FRAMES)]).numpy()
    same = fid == scene["fid"]
    assert (scene["fid"] >= 0).sum() > 200 * N_FRAMES
    assert same.mean() >= 0.999, f"{(~same).sum()} pixels differ"
    np.testing.assert_array_equal(mask.numpy()[same], scene["mask"][same])
    np.testing.assert_allclose(depth.numpy()[same], scene["depth"][same],
                               atol=1e-5)
    assert joints.shape == (N_FRAMES, 24, 3)


def test_frame_in_batch_equals_frame_alone(scene, jmodel):
    tsrc = from_reference(scene["src"], "cpu")
    t = lambda k: torch.tensor(scene[k])
    depth, mask, joints = tsynth.render_poses(
        tsrc, jmodel.parents, t("w")[:4], t("p")[:4], t("rots")[:4], H, W)
    for b in (0, 3):
        d1, m1, j1 = tsynth.render_poses(
            tsrc, jmodel.parents, t("w")[b:b + 1], t("p")[b:b + 1],
            t("rots")[b:b + 1], H, W)
        assert torch.equal(d1[0], depth[b]) and torch.equal(m1[0], mask[b])
        assert torch.equal(j1[0], joints[b])
    # the raster itself, with a face mask per frame and a budget that
    # overflows: every field of a frame equals the frame's own raster
    clouds = torch.stack([t_lbs(tsrc.lbs, jmodel.parents, t("w")[b],
                                t("p")[b], t("rots")[b])[0]
                          for b in range(3)])
    proj = traster.project_points(clouds, *tsrc.intrin)
    valid = torch.as_tensor(np.random.default_rng(0).random(
        (3, tsrc.faces.shape[0])) < 0.8)
    batch = traster.rasterize_batch(proj, clouds[..., 2], tsrc.faces, H, W,
                                    3000, face_valid=valid)
    assert int(batch.n_dropped.min()) > 0 and batch.fid.shape == (3, H, W)
    for b in range(3):
        alone = traster.rasterize(proj[b], clouds[b, :, 2], tsrc.faces, H, W,
                                  3000, face_valid=valid[b])
        for name, x, y in zip(alone._fields, alone, batch):
            assert torch.equal(x, y[b]), (b, name)


def test_synthetic_frames_follow_their_ids(tmodel):
    """The port's own generator: the same id gives the same frame on every
    call and in any batch, different ids differ, the frames hold a body in
    the reference's root box, and ``frame_seq`` is the reference's."""
    src = tsynth.make_source(tmodel, TIntrin(**INTRIN), n_images=8, seed=3)
    n_keys = tmodel.num_shape_keys()
    d1, m1, j1 = tsynth.render_batch(src, tmodel.parents, np.arange(4), 3,
                                     H, W, n_keys)
    d2, m2, _ = tsynth.render_batch(src, tmodel.parents, np.array([2, 0]),
                                    3, H, W, n_keys)
    assert torch.equal(d2[0], d1[2]) and torch.equal(d2[1], d1[0])
    assert torch.equal(m2[0], m1[2])
    assert not torch.equal(d1[0], d1[1])
    fg = int((d1[0] > 0).sum())
    assert 50 < fg < H * W * 0.9
    w, p, rots = tsynth.sample_pose(src, np.arange(64), 3, n_keys)
    lo = torch.tensor([-1.0, -0.5, 2.2])
    hi = torch.tensor([1.0, 0.5, 4.5])
    assert bool(((p >= lo) & (p <= hi)).all())
    # the root faces the camera: within pi/3 of a half turn about y, plus
    # the 0.2 rad perturbation
    assert bool((rots[:, 0, 2, 2] < -0.2).all())
    np.testing.assert_allclose(
        (rots[:, 0] @ rots[:, 0].transpose(1, 2)).numpy(),
        np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-5)
    jsrc = jsynth.make_source(j_synthetic_model(detail=1), JIntrin(**INTRIN),
                              n_images=8, seed=3)
    np.testing.assert_array_equal(src.frame_seq.numpy(),
                                  np.asarray(jsrc.frame_seq))


def test_gaussian_mixture_sample_moments():
    """``GaussianMixture.sample`` against the mixture's own mean and
    covariance (20000 draws; the standard error of a mean is ~0.002, of a
    covariance entry ~0.001)."""
    gm = synthetic_pose_prior(24, seed=8, device="cpu")
    gen = torch.Generator().manual_seed(5)
    x = gm.sample(gen, (20000,)).numpy().astype(np.float64)
    assert x.shape == (20000, 69)
    wts, mu, cov = gm._np["weights"], gm._np["means"], gm._np["covs"]
    mean = wts @ mu
    second = np.einsum("c,cij->ij", wts, cov + np.einsum(
        "ci,cj->cij", mu, mu))
    np.testing.assert_allclose(x.mean(0), mean, atol=0.01)
    np.testing.assert_allclose(np.cov(x.T), second - np.outer(mean, mean),
                               atol=0.01)
    again = gm.sample(torch.Generator().manual_seed(5), (20000,))
    np.testing.assert_array_equal(again.numpy(), x.astype(np.float32))
    assert gm.sample(gen, (2, 3)).shape == (2, 3, 69)
    # the reference's factor, which its sampler multiplies by
    jgm = JGaussianMixture(wts, mu, cov)
    np.testing.assert_allclose(gm.cov_cho.numpy(), np.asarray(jgm.cov_cho),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# level passes
# ---------------------------------------------------------------------------

NC, F, T, P, S = 5, 12, 8, 24, 96


@pytest.fixture(scope="module")
def pass_inputs(scene):
    """One image batch with its samples, node assignment and features."""
    rng = np.random.default_rng(21)
    B = 8
    depth_mm = np.round(scene["depth"][:B] * 1000.0).astype(np.uint16)
    mask = scene["mask"][:B]
    xs, ys, ps, vs = zip(*(jforest._sample_pixels(
        depth_mm[b].astype(np.float32) * 1e-3, mask[b], S, rng)
        for b in range(B)))
    valid = np.stack(vs)
    valid[0, -5:] = False                   # some samples not valid
    node_local = rng.integers(-1, NC, (B, S)).astype(np.int32)
    node_local[:, :4] = 3                   # every slot has samples...
    node_local[node_local == 1] = 0         # ...but slot 1, which is empty
    pool = lambda *shape: rng.uniform(-60, 60, shape).astype(np.float32)
    sel = np.nonzero((node_local >= 0) & valid)
    return dict(
        depth_mm=depth_mm, depth=depth_mm.astype(np.float32) * np.float32(
            1e-3), sx=np.stack(xs), sy=np.stack(ys), part=np.stack(ps),
        valid=valid, node_local=node_local,
        shared=(pool(F, 2), pool(F, 2)),
        per_node=(pool(NC, F, 2), pool(NC, F, 2)),
        # the flat passes' view: the chunk's live samples
        pos=(sel[0] * (H * W)).astype(np.int32),
        fsx=np.stack(xs)[sel], fsy=np.stack(ys)[sel],
        fpart=np.stack(ps)[sel], fnl=node_local[sel])


def _both(name, args, static=()):
    """``name`` of both trainers' modules on the same numpy arguments."""
    ref = getattr(jforest, name)(*(jnp.asarray(a) for a in args), *static)
    got = getattr(tforest, name)(*(torch.tensor(np.asarray(a)) for a in args),
                                 *static)
    unpack = lambda o, f: tuple(f(x) for x in o) if isinstance(
        o, tuple) else (f(o),)
    return unpack(ref, np.asarray), unpack(got, lambda x: x.numpy())


@pytest.mark.parametrize("features", ["shared", "per_node"])
@pytest.mark.parametrize("name", ["_feature_scores", "pass_minmax",
                                  "pass_counts", "pass_minmax_flat",
                                  "pass_counts_flat"])
def test_level_pass_matches_reference(pass_inputs, name, features):
    """Scores within 1e-6; min/max and counts equal."""
    d = pass_inputs
    fu, fv = d[features]
    batch = (d["depth"], d["sx"], d["sy"])
    bits = torch.from_numpy(d["depth_mm"].reshape(-1).view(np.int16))
    flat = (d["pos"], d["fsx"], d["fsy"])
    mn_args = batch + (d["valid"], d["node_local"], fu, fv)
    if name == "_feature_scores":
        (ref,), (got,) = _both(name, batch + (d["valid"], fu, fv,
                                              d["node_local"]))
        assert ref.shape == (8, S, F)
        np.testing.assert_allclose(got, ref, atol=1e-6)
        return
    if name == "pass_minmax":
        ref, got = _both(name, mn_args, (NC,))
    elif name == "pass_counts":
        (smin, smax), _ = _both("pass_minmax", mn_args, (NC,))
        ref, got = _both(name, batch + (d["part"], d["valid"],
                                        d["node_local"], fu, fv, smin, smax),
                         (NC, T, P))
    else:
        j = lambda *a: tuple(jnp.asarray(x) for x in a)
        t = lambda *a: tuple(torch.as_tensor(x) for x in a)
        jcache = jnp.asarray(d["depth_mm"].reshape(-1))
        ref = jforest.pass_minmax_flat(jcache, *j(*flat, d["fnl"], fu, fv),
                                       H, W, NC)
        got = tforest.pass_minmax_flat(bits, *t(*flat, d["fnl"], fu, fv),
                                       H, W, NC)
        if name == "pass_counts_flat":
            smin, smax = ref
            ref = jforest.pass_counts_flat(
                jcache, *j(*flat, d["fpart"], d["fnl"], fu, fv, smin, smax),
                H, W, NC, T, P)
            got = tforest.pass_counts_flat(
                bits, *t(*flat, d["fpart"], d["fnl"], fu, fv,
                         np.asarray(smin), np.asarray(smax)), H, W, NC, T, P)
        ref = tuple(np.asarray(x) for x in ref) if isinstance(
            ref, tuple) else (np.asarray(ref),)
        got = tuple(x.numpy() for x in got) if isinstance(
            got, tuple) else (got.numpy(),)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    if "counts" in name:
        n_live = int(((d["node_local"] >= 0) & d["valid"]).sum())
        assert got[0].sum() == n_live * F and got[0][1].sum() == 0
    else:
        assert (got[0][1] == np.float32(3e38)).all()    # the empty slot


def test_flat_counts_equal_batch_counts(pass_inputs):
    """The sample-major and the image-major passes fill the same
    histogram (what makes the two pass modes grow one tree)."""
    d = pass_inputs
    t = lambda *a: tuple(torch.as_tensor(x) for x in a)
    fu, fv = t(*d["per_node"])
    batch = t(d["depth"], d["sx"], d["sy"])
    valid, nl = t(d["valid"], d["node_local"])
    smin, smax = tforest.pass_minmax(*batch, valid, nl, fu, fv, NC)
    counts = tforest.pass_counts(*batch, torch.as_tensor(d["part"]), valid,
                                 nl, fu, fv, smin, smax, NC, T, P)
    bits = torch.from_numpy(d["depth_mm"].reshape(-1).view(np.int16))
    flat = t(d["pos"], d["fsx"], d["fsy"])
    fmin, fmax = tforest.pass_minmax_flat(bits, *flat, *t(d["fnl"]), fu, fv,
                                          H, W, NC)
    fcounts = tforest.pass_counts_flat(
        bits, *flat, *t(d["fpart"], d["fnl"]), fu, fv, fmin, fmax, H, W, NC,
        T, P)
    assert torch.equal(fmin, smin) and torch.equal(fmax, smax)
    assert torch.equal(fcounts, counts)


@pytest.mark.parametrize("name", ["pass_assign", "pass_assign_flat"])
def test_assign_matches_reference(pass_inputs, name):
    d = pass_inputs
    rng = np.random.default_rng(4)
    n_nodes = 9
    bu = rng.uniform(-60, 60, (n_nodes, 2)).astype(np.float32)
    bv = rng.uniform(-60, 60, (n_nodes, 2)).astype(np.float32)
    bt = rng.uniform(-1, 1, n_nodes).astype(np.float32)
    bl = rng.integers(9, 20, n_nodes).astype(np.int32)
    br = rng.integers(20, 30, n_nodes).astype(np.int32)
    isp = rng.random(n_nodes) < 0.7
    split = (bu, bv, bt, bl, br, isp)
    if name == "pass_assign":
        node = rng.integers(0, n_nodes, d["sx"].shape).astype(np.int32)
        (ref,), (got,) = _both(name, (d["depth"], d["sx"], d["sy"],
                                      d["valid"], node) + split)
    else:
        node = rng.integers(-1, n_nodes, d["pos"].shape).astype(np.int32)
        ref = np.asarray(jforest.pass_assign_flat(
            jnp.asarray(d["depth_mm"].reshape(-1)),
            *(jnp.asarray(a) for a in (d["pos"], d["fsx"], d["fsy"], node)
              + split), H, W))
        got = tforest.pass_assign_flat(
            torch.from_numpy(d["depth_mm"].reshape(-1).view(np.int16)),
            *(torch.as_tensor(a) for a in (d["pos"], d["fsx"], d["fsy"],
                                           node) + split), H, W).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != node).sum() > 50


def test_frame_cache_round_trip():
    """The cache holds uint16 millimetres as int16 bits: every value comes
    back, through plain indexing and through the probes' gather."""
    mm = np.array([0, 1, 32767, 32768, 65535], np.uint16)
    bits = tforest._encode_mm(torch.as_tensor(mm.astype(np.float32) * 1e-3))
    assert bits.dtype == torch.int16 and bits.element_size() == 2
    np.testing.assert_array_equal(bits.numpy().view(np.uint16), mm)
    idx = torch.tensor([[4, 3], [2, 0]])
    back = torch.round(tforest._decode_mm(bits[idx]) * 1000).to(torch.int32)
    np.testing.assert_array_equal(back.numpy(), mm[idx.numpy()])
    cache = torch.zeros((2, 1, 5), dtype=torch.int16)
    tforest._cache_write(cache, torch.as_tensor(
        mm.astype(np.float32) * 1e-3).reshape(1, 1, 5), 1)
    np.testing.assert_array_equal(cache[1, 0].numpy().view(np.uint16), mm)
    assert not cache[0].any()


def _whole_counts(seed, skip=()):
    """Histograms [4, 6, 8, 5] as the count pass makes them: each node's
    samples fall into one bucket per feature (never into ``skip``), so
    every feature of a node holds the same samples."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((4, 6, 8, 5), np.float32)
    buckets = np.setdiff1d(np.arange(8), skip)
    for node in range(4):
        part = rng.integers(0, 5, 800 + 10 * node)
        for f in range(6):
            # feature 1 separates the parts best
            b = np.where(rng.random(len(part)) < (0.9 if f == 1 else 0.2),
                         buckets[part % len(buckets)],
                         rng.choice(buckets, len(part)))
            np.add.at(counts[node, f], (b, part), 1.0)
    return counts


def test_split_gains_match_reference():
    """Gains within rtol 1e-5 of the node's largest entropy term n log n;
    totals equal."""
    counts = _whole_counts(0)
    counts[2] *= 50                                 # a node with many samples
    counts[3, :, :, 0] = counts[3].sum(-1)          # a pure node: gains 0
    counts[3, :, :, 1:] = 0
    (gj, tj), (gt, tt) = _both("split_gains", (counts,))
    n = counts.sum((2, 3))[:, :, None]
    err = np.abs(gt - gj)
    assert (err < 1e-5 * n * np.log(n)).all(), err.max()
    # against the gains themselves float32 cancellation leaves ~5e-4
    assert (err[:3] / np.abs(gj[:3])).max() < 2e-3
    np.testing.assert_array_equal(tt, tj)
    assert gt.shape == (4, 6, 7) and np.abs(gt[3]).max() < 1e-2
    assert gt[:3].max() > 10


def test_split_decide_takes_the_first_of_tied_gains():
    """Two exact ties: feature 4 is a copy of feature 1 (equal gains at
    every threshold), and buckets 3 and 4 of every feature are empty, so
    thresholds 2, 3 and 4 cut the samples alike.  Both packages take the
    first maximum; thresholds within 1e-6, the rest equal."""
    counts = _whole_counts(1, skip=(3, 4))
    counts[:, 4] = counts[:, 1]
    rng = np.random.default_rng(2)
    smin = rng.uniform(-2, 0, (4, 6)).astype(np.float32)
    smax = smin + rng.uniform(0.5, 2, (4, 6)).astype(np.float32)
    ref, got = _both("split_decide", (counts, smin, smax), (8,))
    gains = tforest.split_gains(torch.as_tensor(counts))[0].numpy()
    flat = gains.reshape(4, -1)
    n_max = (flat == flat.max(1, keepdims=True)).sum(1)
    assert (n_max >= 2).all(), "the counts hold no exact tie"
    for r, g, what in zip(ref, got, ("gain", "f_best", "thresh", "range",
                                     "n", "part_hist")):
        if what == "gain":
            np.testing.assert_allclose(g, r, rtol=1e-5)
        elif what == "thresh":
            np.testing.assert_allclose(g, r, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, r, err_msg=what)
    assert (got[1] == 1).all()
    np.testing.assert_array_equal(got[1] * 7 + np.argmax(
        gains[np.arange(4), got[1]], axis=1), np.argmax(flat, axis=1))


def test_host_sampler_equals_reference(scene):
    for k, balance in ((0, 0.5), (1, 0.0), (2, 1.0)):
        args = (scene["depth"][k], scene["mask"][k], 150)
        ref = jforest._sample_pixels(*args, np.random.default_rng(9),
                                     balance)
        got = tforest._sample_pixels(*args, np.random.default_rng(9),
                                     balance)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)
            assert g.dtype == r.dtype
    empty = tforest._sample_pixels(np.zeros((8, 8), np.float32),
                                   np.full((8, 8), 255, np.uint8), 5,
                                   np.random.default_rng(0))
    assert not empty[3].any()


def test_device_sampler_properties(scene):
    """``sample_pixels_device``: no pixel twice, every drawn pixel is
    foreground with its own label, a frame with fewer than S foreground
    pixels is handled, and the part balance moves with ``balance``."""
    depth = torch.as_tensor(scene["depth"][:6]).clone()
    mask = torch.as_tensor(scene["mask"][:6]).clone()
    depth[5] = 0                                    # an empty frame
    mask[5] = 255
    depth[4, :, 40:] = 0                            # a sliver: < S pixels
    mask[4, :, 40:] = 255
    n_fg = ((mask != 255) & (depth > 0)).reshape(6, -1).sum(1)
    S_ = 300
    assert 0 < n_fg[4] < S_ < n_fg[:4].min()
    gen = torch.Generator().manual_seed(1)
    x, y, part, valid = tforest.sample_pixels_device(depth, mask, S_, 24,
                                                     0.5, gen)
    assert x.shape == (6, S_) and x.dtype == torch.int32
    np.testing.assert_array_equal(valid.sum(1).numpy(),
                                  np.minimum(n_fg.numpy(), S_))
    b = torch.arange(6)[:, None].expand(6, S_)
    xl, yl = x.long(), y.long()
    assert bool((depth[b, yl, xl] > 0)[valid].all())
    assert torch.equal(mask[b, yl, xl].int()[valid], part[valid])
    assert bool((part[~valid] == 0).all())
    for k in range(5):
        pix = (yl[k] * W + xl[k])[valid[k]]
        assert pix.unique().numel() == pix.numel()
    # the largest part's share of the samples: its share of the pixels
    # at balance 0, one part in n_present at balance 1
    pix = np.bincount(scene["mask"][0][scene["mask"][0] != 255],
                      minlength=24)
    big, n_present = int(np.argmax(pix)), int((pix > 0).sum())
    pixel_share = pix[big] / pix.sum()
    assert pixel_share > 2.0 / n_present
    share = []
    for balance in (0.0, 1.0):
        draws = [tforest.sample_pixels_device(
            depth[:1], mask[:1], 200, 24, balance,
            torch.Generator().manual_seed(s))[2] for s in range(8)]
        share.append(float((torch.cat(draws) == big).float().mean()))
    assert abs(share[0] - pixel_share) < 0.03
    assert abs(share[1] - 1.0 / n_present) < 0.03


# ---------------------------------------------------------------------------
# the whole trainer, from one in-memory frame source
# ---------------------------------------------------------------------------

TRAIN_KW = dict(num_parts=24, num_images=N_FRAMES, num_points_per_image=200,
                num_features=24, max_probe_offset=60.0, min_samples=16,
                max_tree_depth=6, image_batch=8, seed=7)


def _assert_same_tree(got, ref):
    for f in ("u", "v", "lnode", "rnode", "leafid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.thresh, ref.thresh, rtol=1e-6)
    np.testing.assert_allclose(got.leaf_data, ref.leaf_data, atol=1e-6)


def _trainers(source, **kw):
    kw = dict(TRAIN_KW, **kw)
    return (jforest.ForestTrainer(None, None, (H, W), frame_source=source,
                                  **kw),
            tforest.ForestTrainer(None, None, (H, W), frame_source=source,
                                  device="cpu", **kw))


@pytest.fixture(scope="module")
def flat_tree(source):
    return _trainers(source, pass_mode="flat")[1].train()


@pytest.mark.parametrize("mode", ["flat", "batch", "filter"])
def test_trainer_grows_the_reference_tree(source, flat_tree, mode):
    """Both packages' trainers on the same frames: the same tree, in flat
    and in batch mode and with the filter stage on; and the port's three
    dense runs are one tree."""
    kw = dict(pass_mode="flat", num_features_filtered=8,
              filter_subsample=2) if mode == "filter" else dict(
        pass_mode=mode)
    jt, tt = _trainers(source, **kw)
    ref, got = jt.train(), tt.train()
    assert (ref.leafid < 0).sum() > 5
    _assert_same_tree(got, ref)
    if mode == "filter":
        assert not np.array_equal(got.u, flat_tree.u)
    else:
        _assert_same_tree(got, flat_tree)
    assert [s["nodes"] for s in tt.level_stats][:3] == [1, 2, 4]
    assert all(s["probe_evals"] > 0 for s in tt.level_stats)


def _run_levels(trainer, module, n):
    trainer._init_samples()
    trainer.tree = module._TreeBuilder(24)
    trainer.frontier = [trainer.tree.add_node()]
    trainer.frontier_depth = [trainer.max_depth]
    trainer.level = 0
    for _ in range(n):
        trainer._train_level()
        trainer.level += 1
    trainer.save_checkpoint()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(source, flat_tree, tmp_path,
                                            writer):
    """A checkpoint written after two levels by one package's trainer,
    resumed by the other's, gives the tree of an uninterrupted run."""
    ckpt = str(tmp_path / "mid.ckpt")
    jt, tt = _trainers(source, pass_mode="batch", checkpoint_path=ckpt)
    if writer == "reference":
        _run_levels(jt, jforest, 2)
        fd = _trainers(source, pass_mode="flat")[1].train(resume_from=ckpt)
    else:
        _run_levels(tt, tforest, 2)
        fd = _trainers(source, pass_mode="batch")[0].train(resume_from=ckpt)
    with np.load(ckpt) as z:
        assert int(z["level"]) == 2 and z["node_of"].shape == (N_FRAMES, 200)
        assert z["sx"].dtype == np.int32 and z["svalid"].dtype == bool
    _assert_same_tree(fd, flat_tree)


def test_trainer_defaults_to_the_card(source):
    """With no model to follow and no ``device`` the trainer takes the
    card, and raises where there is none: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tforest.ForestTrainer(None, None, (H, W), frame_source=source,
                              **TRAIN_KW)
    from avatar_tpu_torch.tools import rtree_train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rtree_train.main(["x.srtr", "--synthetic-model", "1", "-q"])


def test_mesh_training_is_refused(source):
    """Over a mesh the trainer refuses the flat passes, and ``devices`` > 1
    outside a launched world names the launcher (the mesh's own tests are
    ``tests/test_torch_parallel.py``)."""
    from avatar_tpu_torch.parallel.training import make_mesh

    with make_mesh(1, device="cpu") as mesh:
        with pytest.raises(ValueError, match="pass_mode='batch'"):
            tforest.ForestTrainer(None, None, (H, W), frame_source=source,
                                  device="cpu", mesh=mesh, pass_mode="flat",
                                  **TRAIN_KW)
    with pytest.raises(RuntimeError, match="run_world"):
        RTree(24, device="cpu").train_from_avatar(
            None, None, None, (H, W), devices=2)


# ---------------------------------------------------------------------------
# the port's own synthetic path (the sizes of tests/test_forest_training.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmodel):
    tree = RTree(24, device="cpu")
    tree.train_from_avatar(
        tmodel, None, TIntrin(**INTRIN), (H, W), num_images=48,
        num_points_per_image=400, num_features=48, max_probe_offset=60.0,
        min_samples=24, max_tree_depth=9, seed=5)
    return tree


def test_trained_tree_segments(tmodel, trained):
    """Held-out accuracy beats chance by a wide margin (the reference
    test's bound, 0.35, at its size), and the tree is sound."""
    fd = trained.forest
    internal = fd.leafid < 0
    assert internal.sum() > 3
    assert (fd.lnode[internal] > 0).all()
    assert (fd.rnode[internal] < fd.num_nodes).all()
    np.testing.assert_allclose(fd.leaf_data.sum(1), 1.0, atol=1e-5)
    src = tsynth.make_source(tmodel, TIntrin(**INTRIN), n_images=4,
                             seed=999)
    depth, mask, _ = tsynth.render_batch(src, tmodel.parents, np.arange(4),
                                         999, H, W, tmodel.num_shape_keys())
    total = correct = 0
    for d, m in zip(depth.numpy(), mask.numpy()):
        pred = trained.predict_best(d)
        fg = (m != 255) & (pred != 255)
        total += fg.sum()
        correct += (pred[fg] == m[fg]).sum()
    assert total > 1000
    assert correct / total > 0.35, f"accuracy only {correct / total:.2%}"


def test_train_transfer_renormalizes_leaves(tmodel, trained):
    tree = RTree(24, device="cpu")
    tree.set_forest(trained.forest)
    old_leaf = tree.forest.leaf_data.copy()
    tree.trainTransfer(tmodel, None, TIntrin(**INTRIN), (H, W),
                       num_images=8, seed=31)
    new_leaf = tree.forest.leaf_data
    assert new_leaf.shape == old_leaf.shape
    np.testing.assert_allclose(new_leaf.sum(1), 1.0, atol=1e-5)
    assert not np.allclose(new_leaf, old_leaf)
    np.testing.assert_array_equal(tree.forest.u, trained.forest.u)


def test_synthetic_resume_gives_the_same_tree(tmodel, tmp_path):
    """Interrupted after two levels and resumed in a fresh trainer (the
    frame cache re-rendered from the image ids): the tree of an
    uninterrupted run, flat or batch."""
    ckpt = str(tmp_path / "synth.ckpt")
    kw = dict(TRAIN_KW, num_images=12, seed=5)
    make = lambda **k: tforest.ForestTrainer(tmodel, TIntrin(**INTRIN),
                                             (H, W), **dict(kw, **k))
    full = make().train()
    _run_levels(make(checkpoint_path=ckpt), tforest, 2)
    resumed = make(pass_mode="batch").train(resume_from=ckpt)
    for f in ("u", "v", "thresh", "lnode", "rnode", "leafid", "leaf_data"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(full, f))


def test_train_from_files_matches_reference(scene, tmp_path):
    """File-dataset training (``RTree.train``: ``.depth`` frames and PNG
    part masks from two directories): both packages read the same frames
    and grow the same tree."""
    from avatar_tpu.perception.rtree import RTree as JRTree

    cv2 = pytest.importorskip("cv2")
    ddir, mdir = tmp_path / "depth_exr", tmp_path / "part_mask"
    ddir.mkdir()
    mdir.mkdir()
    for i in range(12):
        tformats.write_depth_rle(str(ddir / f"depth_{i:08d}.depth"),
                                 scene["depth"][i])
        cv2.imwrite(str(mdir / f"part_mask_{i:08d}.png"), scene["mask"][i])
    kw = dict(num_points_per_image=150, num_features=16,
              max_probe_offset=60.0, min_samples=16, max_tree_depth=5,
              seed=5)
    jt, tt = JRTree(24), RTree(24, device="cpu")
    jt.train(str(ddir), str(mdir), **kw)
    tt.train(str(ddir), str(mdir), **kw)
    assert (tt.forest.leafid < 0).sum() > 3
    _assert_same_tree(tt.forest, jt.forest)
    src = tforest.FileFrameSource(str(ddir), str(mdir))
    assert src.size() == 12 and tuple(src.image_size()) == (H, W)
    depth, mask = src.load_batch(np.array([3, 0]))
    np.testing.assert_array_equal(depth, scene["depth"][[3, 0]])
    np.testing.assert_array_equal(mask, scene["mask"][[3, 0]])
    (mdir / "part_mask_00000011.png").unlink()
    with pytest.raises(ValueError, match="mismatch"):
        tforest.FileFrameSource(str(ddir), str(mdir))


# ---------------------------------------------------------------------------
# formats and tools
# ---------------------------------------------------------------------------


def test_srtr_writer_matches_reference(flat_tree, tmp_path):
    a, b = str(tmp_path / "a.srtr"), str(tmp_path / "b.srtr")
    tformats.write_srtr(a, flat_tree)
    jformats.write_srtr(b, flat_tree)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    tree = RTree(24, device="cpu")
    tree.set_forest(flat_tree)
    assert tree.exportFile(a)
    for back in (tformats.read_srtr(a), jformats.read_srtr(a),
                 from_reference(jformats.read_srtr(a))):
        for f in ("u", "v", "thresh", "lnode", "rnode", "leafid",
                  "leaf_data"):
            np.testing.assert_array_equal(getattr(back, f),
                                          getattr(flat_tree, f))
        assert back.num_parts == 24


def test_partmap_writer_matches_reference(tmp_path):
    from avatar_tpu_torch.perception.partgroups import (SMPL24_GROUP_LUT,
                                                        SMPL24_GROUP_NAMES)

    src = [f"joint{j}" for j in range(24)]
    mapping = {src[j]: SMPL24_GROUP_NAMES[SMPL24_GROUP_LUT[j]]
               for j in range(24)}
    a, b = str(tmp_path / "a.partmap"), str(tmp_path / "b.partmap")
    for mod, path in ((tformats, a), (jformats, b)):
        mod.write_partmap(path, mod.PARTMAP_CONTIGUOUS, src,
                          list(SMPL24_GROUP_NAMES), mapping)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for mod in (tformats, jformats):
        pm, n_new, kind = mod.read_partmap(a)
        assert pm == list(SMPL24_GROUP_LUT) and (n_new, kind) == (14, 0)


def test_depth_codec_matches_reference(scene, tmp_path, monkeypatch):
    """``.depth`` bytes equal to the reference's numpy codec, each
    readable by the other package; a trailing zero run is not written."""
    from avatar_tpu.native import rle

    monkeypatch.setattr(rle, "_LIB", False)         # the numpy branch
    frames = [scene["depth"][0], np.zeros((4, 6), np.float32),
              np.arange(12, dtype=np.float32).reshape(3, 4)]
    for k, depth in enumerate(frames):
        a, b = str(tmp_path / f"a{k}.depth"), str(tmp_path / f"b{k}.depth")
        tformats.write_depth_rle(a, depth)
        jformats.write_depth_rle(b, depth)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            data = fa.read()
            assert data == fb.read() == rle.encode(depth)
        np.testing.assert_array_equal(tformats.read_depth(b), depth)
        np.testing.assert_array_equal(jformats.read_depth(a), depth)
    assert len(tformats.encode_depth_rle(frames[1])) == 4
    with pytest.raises(ValueError):
        tformats.decode_depth_rle(b"\x01")


TOOL_ARGS = ["--synthetic-model", "1", "--width", "64", "--height", "64",
             "--fx", "60", "--fy", "60", "--cx", "32", "--cy", "32",
             "--device", "cpu", "-q"]


def test_tools_train_and_transfer(tmp_path, capsys):
    from avatar_tpu_torch.tools import rtree_train, rtree_transfer

    out, out2 = str(tmp_path / "t.srtr"), str(tmp_path / "t2.srtr")
    rtree_train.main([out, "--images", "8", "--pixels", "100", "--features",
                      "16", "--depth", "4", "--min-samples", "20", "--probe",
                      "30", "--checkpoint", out + ".ckpt"] + TOOL_ARGS)
    assert "wrote" in capsys.readouterr().out
    fd = jformats.read_srtr(out)
    assert fd.num_parts == 24 and (fd.leafid < 0).sum() >= 1
    assert os.path.exists(out + ".ckpt")
    rtree_transfer.main([out, out2, "--images", "4"] + TOOL_ARGS)
    fd2 = tformats.read_srtr(out2)
    np.testing.assert_array_equal(fd2.thresh, fd.thresh)
    np.testing.assert_allclose(fd2.leaf_data.sum(1), 1.0, atol=1e-5)
    assert not np.allclose(fd2.leaf_data, fd.leaf_data)


def test_tool_refuses_devices(tmp_path):
    """``--devices`` trains on synthetic renders; with ``--data`` (one
    device, as in the reference) it is refused before any training."""
    from avatar_tpu_torch.tools import rtree_train

    with pytest.raises(SystemExit) as e:
        rtree_train.main([str(tmp_path / "x.srtr"), "--devices", "1",
                          "--data", str(tmp_path)] + TOOL_ARGS)
    assert "--data trains on one device" in str(e.value.code)
    assert not os.path.exists(tmp_path / "x.srtr")


def test_train_and_tools_import_without_jax():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "for m in ('train', 'train.synth', 'train.forest', 'tools',\n"
        "          'tools.common', 'tools.rtree_train',\n"
        "          'tools.rtree_transfer'):\n"
        "    importlib.import_module('avatar_tpu_torch.' + m)\n"
        "sys.path.insert(0, 'scripts')\n"
        "import train_bench_forest_torch\n"
        "bad = [m for m in sys.modules if m.startswith('avatar_tpu') and\n"
        "       not m.startswith('avatar_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
