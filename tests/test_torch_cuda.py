"""On the card: the hand-written CUDA kernel against its plain PyTorch
version (B1 at the fit's planned shapes, B2 at the unplanned
``find_nn_stats``'s, the fused search, and cases built against the merge of
the kernel's work units), and the renderer, ``find_nn_stats`` and the
forest trainer's passes (the frame cache's gather, min/max, counts,
assignment, gains, the device sampler) against the same functions on the
CPU, a world of one over NCCL (the sharded passes and the mesh trainer),
``optim_tool``, and ``track_batch`` against the frame-by-frame chain.
Imports
no JAX (the card's machine has none); on a machine without a CUDA device
every test skips.  On the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from avatar_tpu_torch.optim import correspond, nn_kernel
from avatar_tpu_torch.perception.partgroups import SMPL24_NUM_GROUPS
from avatar_tpu_torch.testing import (synthetic_nn_inputs,
                                      synthetic_nn_stats_inputs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [8192, 32768])
def test_kernel_matches_plain_at_fit_shapes(cuda, n_rows):
    """B1 (ranged) and B2 (full range): indices equal, d2 within rtol 1e-6
    (both round every product and sum on its own)."""
    args = synthetic_nn_inputs(n_rows, seed=n_rows, device=cuda)
    assert args[2].shape[0] == 6656
    before = dict(nn_kernel.LAUNCHES)
    d, i = nn_kernel.nn_argmin_ranges(*args, wild=SMPL24_NUM_GROUPS)
    torch.cuda.synchronize()
    assert nn_kernel.LAUNCHES == {**before, "nn_argmin_ranges":
                                  before["nn_argmin_ranges"] + 1}
    rd, ri = nn_kernel.nn_argmin_ranges_ref(*args, wild=SMPL24_NUM_GROUPS)
    assert torch.equal(i, ri)
    torch.testing.assert_close(d, rd, rtol=1e-6, atol=0.0)
    assert (i[args[1] == SMPL24_NUM_GROUPS] >= 0).all()
    assert (i[args[1] < 0] == -1).all()

    # full range at chunk 512 (6656 slots are not a multiple of 1024)
    d2, i2 = nn_kernel.nn_argmin(*args[:5], chunk=512,
                                 wild=SMPL24_NUM_GROUPS)
    assert nn_kernel.LAUNCHES["nn_argmin"] == before["nn_argmin"] + 1
    rd2, ri2 = nn_kernel.nn_argmin_ref(*args[:5], chunk=512,
                                       wild=SMPL24_NUM_GROUPS)
    assert torch.equal(i2, ri2)
    torch.testing.assert_close(d2, rd2, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    args = list(synthetic_nn_inputs(1024, seed=1, device=cuda))
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin_ranges(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin_ranges(*args[:2], args[2].cpu(), *args[3:])
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin_ranges(*args, chunk=500)


@pytest.mark.cuda
def test_rasterize_on_card_matches_cpu(cuda):
    """The z-buffer raster of a posed detail-6 avatar at 1280x720 on the
    card against the same function on the CPU: face ids equal on >= 99.9%
    of pixels, depth within 1e-5 m where they are."""
    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.render import raster
    from avatar_tpu_torch.testing import synthetic_model

    model = synthetic_model(detail=6, device="cpu")
    ava = Avatar(model)
    ava.randomize(seed=77)
    ava.p = np.array([0.0, 0.1, 2.6])
    ava.r[0] = np.diag([-1.0, 1.0, -1.0])
    ava.update()
    cloud = torch.as_tensor(ava.cloud)
    proj = raster.project_points(cloud, 606.438, 606.351, 637.294, 366.992)
    faces = torch.as_tensor(model.faces, dtype=torch.int32)
    budget = raster.default_budget(720, 1280, model.num_faces())
    ref = raster.rasterize(proj, cloud[:, 2], faces, 720, 1280, budget)
    got = raster.rasterize(proj.to(cuda), cloud[:, 2].to(cuda),
                           faces.to(cuda), 720, 1280, budget)
    same = (got.fid.cpu() == ref.fid)
    assert int((ref.fid >= 0).sum()) > 10000
    assert float(same.float().mean()) >= 0.999
    assert int(got.n_dropped) == int(ref.n_dropped)
    torch.testing.assert_close(got.depth.cpu()[same], ref.depth[same],
                               rtol=0.0, atol=1e-5)


@pytest.mark.cuda
def test_render_frame_on_card_matches_cpu(cuda):
    """``render_frame`` (depth, part mask) on the card against the CPU."""
    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.render import raster, renderer
    from avatar_tpu_torch.testing import synthetic_model

    model = synthetic_model(detail=6, device="cpu")
    ava = Avatar(model)
    ava.randomize(seed=20)
    ava.p = np.array([0.1, 0.0, 2.4])
    ava.update()
    args = (torch.as_tensor(ava.cloud),
            torch.as_tensor(model.faces, dtype=torch.int32),
            torch.as_tensor(model.main_joint, dtype=torch.int32))
    intr = (606.438, 606.351, 637.294, 366.992, 720, 1280,
            raster.default_budget(720, 1280, model.num_faces()))
    ref = renderer.render_frame(*args, *intr)
    got = renderer.render_frame(*(a.to(cuda) for a in args), *intr)
    same = got.fid.cpu() == ref.fid
    assert float(same.float().mean()) >= 0.999
    torch.testing.assert_close(got.depth.cpu()[same], ref.depth[same],
                               rtol=0.0, atol=1e-5)
    assert torch.equal(got.part_mask.cpu()[same], ref.part_mask[same])


@pytest.mark.cuda
def test_frames_in_a_batch_equal_frames_alone_on_card(cuda):
    """``render_frames`` of 5 poses at the trainer's 240x427, with a budget
    that overflows on the nearest pose: every field of every frame equals
    ``render_frame`` of that pose alone, to the bit."""
    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.render import renderer
    from avatar_tpu_torch.testing import synthetic_model

    model = synthetic_model(detail=6, device="cpu")
    ava = Avatar(model)
    clouds = []
    for seed, depth in enumerate((1.2, 2.4, 3.0, 3.6, 4.4)):
        ava.randomize(seed=seed)
        ava.p = np.array([0.2 * seed - 0.4, 0.0, depth])
        ava.r[0] = np.diag([-1.0, 1.0, -1.0])
        ava.update()
        clouds.append(torch.as_tensor(ava.cloud))
    clouds = torch.stack(clouds).to(cuda)
    rest = (torch.as_tensor(model.faces, dtype=torch.int32, device=cuda),
            torch.as_tensor(model.main_joint, dtype=torch.int32,
                            device=cuda),
            606.438 / 3, 606.351 / 3, 637.294 / 3, 366.992 / 3, 240, 427,
            120000)
    batch = renderer.render_frames(clouds, *rest)
    assert int(batch.n_dropped[0]) > 0 and int(batch.n_dropped[4]) == 0
    assert int((batch.fid[2] >= 0).sum()) > 1000
    for b in range(5):
        alone = renderer.render_frame(clouds[b], *rest)
        for name, x, y in zip(alone._fields, alone, batch):
            assert torch.equal(x, y[b]), (b, name)


@pytest.mark.cuda
def test_b2_at_find_nn_stats_shapes(cuda):
    """B2 as ``find_nn_stats`` launches it: 8192 unsorted rows, the model
    axis padded to 7168 slots with invisible slots of part -2, chunk 1024.
    Indices equal to the plain version's, d2 equal to the last bit."""
    data, dpart, verts, part, visible = synthetic_nn_stats_inputs(
        8192, device=cuda)
    args = nn_kernel.match_inputs(
        correspond.unplanned_match(data, dpart, part), verts, verts.mean(0),
        visible)[:5]
    assert args[2].shape[0] == 7168 and (args[3][6624:] == -2).all()
    before = nn_kernel.LAUNCHES["nn_argmin"]
    d, i = nn_kernel.nn_argmin(*args, wild=SMPL24_NUM_GROUPS)
    torch.cuda.synchronize()
    assert nn_kernel.LAUNCHES["nn_argmin"] == before + 1
    rd, ri = nn_kernel.nn_argmin_ref(*args, wild=SMPL24_NUM_GROUPS)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    assert (i[args[1] == SMPL24_NUM_GROUPS] >= 0).all()
    assert (i[args[1] < 0] == -1).all() and (i < 6624).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [8192, 5000])
def test_find_nn_stats_on_card_matches_cpu(cuda, n_rows):
    """``find_nn_stats`` on the card (B2) against its CPU result (the plain
    version): corr and n_matched equal, cnt equal, s and q within 1e-6
    relative (scatter-adds in another order)."""
    args = synthetic_nn_stats_inputs(n_rows, seed=n_rows, device="cpu")
    kw = dict(wild=SMPL24_NUM_GROUPS, wild_gate2=torch.tensor(0.04))
    ref = correspond.find_nn_stats(*args, **kw)
    got = correspond.find_nn_stats(*(a.to(cuda) for a in args),
                                   wild=SMPL24_NUM_GROUPS,
                                   wild_gate2=torch.tensor(0.04,
                                                           device=cuda))
    assert torch.equal(got.corr.cpu(), ref.corr)
    assert float(got.n_matched) == float(ref.n_matched) > n_rows // 2
    assert torch.equal(got.cnt.cpu(), ref.cnt)
    torch.testing.assert_close(got.s.cpu(), ref.s, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.q.cpu(), ref.q, rtol=1e-6, atol=0.0)


# -- cases against the merge of the kernel's work units ----------------------
# A work unit is 64 data rows by up to 512 slots of one model chunk; units
# of one row merge through an atomic minimum of (d2, index).  Every case
# holds the kernel to the plain version: indices equal, d2 to the last bit.

def _equal_to_plain(args, **kw):
    d, i = nn_kernel.nn_argmin_ranges(*args, **kw)
    torch.cuda.synchronize()
    rd, ri = nn_kernel.nn_argmin_ranges_ref(*args, **kw)
    assert torch.equal(i, ri), int((i != ri).sum())
    assert torch.equal(d, rd)
    return d, i


def _one_part_case(cuda, N, Pp, chunk, dup_slots, seed=0):
    """N rows near model vertex ``dup_slots[0]``, whose point every slot
    of ``dup_slots`` repeats; one part, all visible, full range."""
    g = torch.Generator().manual_seed(seed)
    model = torch.randn(Pp, 3, generator=g)
    model[dup_slots] = model[dup_slots[0]].clone()
    data = model[dup_slots[0]] + 1e-3 * torch.randn(N, 3, generator=g)
    t = lambda a: a.to(cuda)
    T = N // 256
    return [t(data), t(torch.zeros(N, dtype=torch.int32)), t(model),
            t(torch.zeros(Pp, dtype=torch.int32)),
            t(torch.ones(Pp, dtype=torch.bool)),
            t(torch.zeros(T, dtype=torch.int32)),
            t(torch.full((T,), Pp // chunk, dtype=torch.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [512, 1024, 3072])
def test_duplicates_across_chunk_and_unit_boundaries(cuda, chunk):
    """The same point on both sides of a 512-slot unit boundary and of a
    chunk boundary: the lowest index wins, and when it turns invisible the
    next one does, whichever unit scanned it."""
    Pp = 6144
    dups = [509, 511, 512, 1023, 1024, 3071, 3072, 3073, 6143]
    args = _one_part_case(cuda, 256, Pp, chunk, dups)
    for k, want in enumerate(dups):
        d, i = _equal_to_plain(args, chunk=chunk)
        assert (i == want).all(), (want, i.unique())
        args[4][want] = False


@pytest.mark.cuda
def test_rows_without_candidate_and_empty_ranges(cuda):
    """Rows with no candidate give (3e38, -1): a part no slot carries,
    padding rows, a tile with ``cstart == cend``, an all-padding tile, and
    a launch where no tile has any unit."""
    args = list(synthetic_nn_inputs(1024, n_wild=100, seed=3, device=cuda))
    args[1] = args[1].clone()
    real = (args[1] >= 0).nonzero()[:, 0]
    args[1][real[:5]] = 77                  # a part of no model slot
    d, i = _equal_to_plain(args, wild=SMPL24_NUM_GROUPS)
    assert (i[real[:5]] == -1).all() and (d[real[:5]] == 3.0e38).all()
    assert (i[args[1] < 0] == -1).all() and (args[1] < 0).sum() > 256
    args[5], args[6] = args[5].clone(), args[6].clone()
    args[6][-1] = args[5][-1]               # cstart == cend on a real tile
    d, i = _equal_to_plain(args, wild=SMPL24_NUM_GROUPS)
    assert (i[-256:] == -1).all()
    args[6][:] = args[5]                    # no unit at all
    d, i = _equal_to_plain(args, wild=SMPL24_NUM_GROUPS)
    assert (i == -1).all() and (d == 3.0e38).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [256, 1024])
def test_small_and_all_wildcard_launches(cuda, n_rows):
    """N = 256 (one tile), and every row a wildcard: each scans the whole
    real model axis."""
    args = list(synthetic_nn_inputs(n_rows, n_wild=n_rows // 2, seed=n_rows,
                                    device=cuda))
    _equal_to_plain(args, wild=SMPL24_NUM_GROUPS)
    args[1] = torch.full_like(args[1], SMPL24_NUM_GROUPS)
    args[5] = torch.zeros_like(args[5])
    args[6] = torch.full_like(args[6], 13)
    d, i = _equal_to_plain(args, wild=SMPL24_NUM_GROUPS)
    assert (i >= 0).all()


@pytest.mark.cuda
def test_full_range_without_range_tensors(cuda):
    """``nn_argmin`` hands the kernel no cstart/cend: the same result as
    the full range written out."""
    args = synthetic_nn_inputs(2048, seed=9, device=cuda)
    full = nn_kernel._full_range(2048, 6656, 256, 512, cuda)
    d, i = nn_kernel.nn_argmin(*args[:5], chunk=512, wild=SMPL24_NUM_GROUPS)
    d2, i2 = _equal_to_plain(list(args[:5]) + list(full), chunk=512,
                             wild=SMPL24_NUM_GROUPS)
    assert torch.equal(i, i2) and torch.equal(d, d2)


@pytest.mark.cuda
def test_second_launch_sees_no_stale_key(cuda):
    """Two launches in a row share the scratch: the second, with every
    slot invisible, must not find the first one's keys."""
    args = list(synthetic_nn_inputs(1024, seed=4, device=cuda))
    d, i = _equal_to_plain(args, wild=SMPL24_NUM_GROUPS)
    assert (i >= 0).any()
    del d, i
    args[4] = torch.zeros_like(args[4])
    d, i = _equal_to_plain(args, wild=SMPL24_NUM_GROUPS)
    assert (i == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("model_sorted,gate", [(False, 2e-5), (True, None)])
def test_fused_search_matches_plain(cuda, model_sorted, gate):
    """``nn_match`` (one host call) against its plain version on a planned
    search: best_d, corr, wgt and n_matched equal, with and without the
    model permutation and the wildcard gate (as a device scalar)."""
    data, dpart, verts, part, visible = synthetic_nn_stats_inputs(
        2048, seed=11, device=cuda)
    if model_sorted:
        order = torch.argsort(part, stable=True)
        verts, part, visible = verts[order], part[order], visible[order]
    plan = correspond.make_nn_plan(data, dpart, part,
                                   num_parts=SMPL24_NUM_GROUPS,
                                   model_sorted=model_sorted)
    gate = None if gate is None else torch.tensor(gate, device=cuda)
    center = verts.mean(0)
    before = nn_kernel.LAUNCHES["nn_argmin_ranges"]
    got = nn_kernel.nn_match(plan.match, verts, center, visible,
                             SMPL24_NUM_GROUPS, gate)
    torch.cuda.synchronize()
    assert nn_kernel.LAUNCHES["nn_argmin_ranges"] == before + 1
    ref = nn_kernel.nn_match_ref(plan.match, verts, center, visible,
                                 SMPL24_NUM_GROUPS, gate)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert float(got[3]) > 400 and (got[1] >= 0).sum() == int(got[3])
    if gate is not None:
        wild_rows = plan.dpart == SMPL24_NUM_GROUPS
        assert (got[1][wild_rows] == -1).any(), "the gate bites"


# ---------------------------------------------------------------------------
# the forest trainer's passes (torch code, no hand-written kernel): the
# card against the CPU on the same inputs
# ---------------------------------------------------------------------------


def _trainer_inputs(seed=0, n_img=6, H=60, W=80, M=5000, NC=7, F=16):
    """A uint16-mm frame cache with background, samples on foreground
    pixels, a node slot per sample (-1: skip) and per-node features."""
    rng = np.random.default_rng(seed)
    mm = rng.integers(500, 60000, (n_img, H, W)).astype(np.uint16)
    mm[rng.random(mm.shape) < 0.3] = 0
    mm[0, 0, :5] = [0, 1, 32767, 32768, 65535]
    img = rng.integers(0, n_img, M)
    sx, sy = rng.integers(0, W, M), rng.integers(0, H, M)
    nl = rng.integers(-1, NC, M).astype(np.int32)
    nl[mm[img, sy, sx] == 0] = -1
    return dict(
        bits=torch.from_numpy(mm.reshape(-1).view(np.int16)), mm=mm,
        pos=torch.as_tensor(img * (H * W)), sx=torch.as_tensor(sx),
        sy=torch.as_tensor(sy), nl=torch.as_tensor(nl),
        part=torch.as_tensor(rng.integers(0, 14, M)),
        fu=torch.as_tensor(rng.uniform(-70, 70, (NC, F, 2)),
                           dtype=torch.float32),
        fv=torch.as_tensor(rng.uniform(-70, 70, (NC, F, 2)),
                           dtype=torch.float32),
        H=H, W=W, NC=NC)


@pytest.mark.cuda
def test_frame_cache_gather_on_card(cuda):
    """The uint16-mm cache kept as int16 bits: written, indexed and
    decoded on the card, every value comes back (0, 1, 32767, 32768 and
    65535 mm among them)."""
    from avatar_tpu_torch.train import forest

    d = _trainer_inputs()
    metres = torch.as_tensor(d["mm"].astype(np.float32) * 1e-3, device=cuda)
    cache = torch.zeros(d["mm"].shape, dtype=torch.int16, device=cuda)
    forest._cache_write(cache[:4], metres[:4], 0)
    forest._cache_write(cache, metres[4:], 4)
    assert torch.equal(cache.cpu().reshape(-1), d["bits"])
    idx = torch.randint(0, cache.numel(), (4096, 3), device=cuda)
    got = torch.round(forest._decode_mm(cache.reshape(-1)[idx]) * 1000)
    want = d["mm"].reshape(-1)[idx.cpu().numpy()].astype(np.float32)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert got[0:0].dtype == torch.float32


@pytest.mark.cuda
def test_trainer_passes_on_card_match_cpu(cuda):
    """Scores, min/max, counts, assignment and split decisions on the card
    equal the CPU's on the same inputs (gains to rounding), with and
    without deterministic algorithms."""
    from avatar_tpu_torch.train import forest

    d = _trainer_inputs()
    H, W, NC, T, P = d["H"], d["W"], d["NC"], 16, 14
    out = {}
    for dev in ("cpu", cuda):
        t = {k: (v.to(dev) if torch.is_tensor(v) else v)
             for k, v in d.items()}
        flat = (t["bits"], t["pos"], t["sx"], t["sy"])
        live = t["nl"] >= 0
        fu_s, fv_s = forest._per_sample(t["fu"], t["fv"], t["nl"])
        scores = forest._flat_scores(t["bits"], H, W, t["pos"], t["sx"],
                                     t["sy"], live, fu_s, fv_s)
        smin, smax = forest.pass_minmax_flat(*flat, t["nl"], t["fu"],
                                             t["fv"], H, W, NC)
        counts = forest.pass_counts_flat(*flat, t["part"], t["nl"], t["fu"],
                                         t["fv"], smin, smax, H, W, NC, T, P)
        decide = forest.split_decide(counts, smin, smax, T)
        n_nodes = 2 * NC + 1
        node = torch.where(live, t["nl"], -1)
        f_best = decide[1].long()
        pick = lambda a: a[torch.arange(NC, device=dev), f_best]
        pad = lambda a: torch.cat([a, torch.zeros(
            (n_nodes - NC,) + a.shape[1:], dtype=a.dtype, device=dev)])
        child = forest.pass_assign_flat(
            *flat, node, pad(pick(t["fu"])), pad(pick(t["fv"])),
            pad(decide[2]), pad(torch.arange(NC, device=dev,
                                             dtype=torch.int32) + NC),
            pad(torch.arange(NC, device=dev, dtype=torch.int32) + 2 * NC),
            pad(torch.ones(NC, dtype=torch.bool, device=dev)), H, W)
        out[str(dev)] = [x.cpu() for x in (scores, smin, smax, counts,
                                           *decide, child)]
    names = ("scores", "smin", "smax", "counts", "gain", "f_best", "thresh",
             "range", "n", "part_hist", "child")
    for name, a, b in zip(names, out["cpu"], out[str(cuda)]):
        if name == "gain":
            torch.testing.assert_close(b, a, rtol=2e-3, atol=1e-2)
        elif name == "thresh":
            torch.testing.assert_close(b, a, rtol=1e-6, atol=0.0)
        else:
            assert torch.equal(a, b), name
    assert out["cpu"][3].sum() == int((d["nl"] >= 0).sum()) * 16
    assert (out["cpu"][10] != d["nl"]).sum() > 1000

    # the count scatter is exact, so deterministic mode changes nothing
    idx = torch.randint(0, 5000, (1 << 18,), device=cuda)
    free = forest._count(idx, 5000)
    torch.use_deterministic_algorithms(True)
    try:
        det = forest._count(idx, 5000)
        assert torch.are_deterministic_algorithms_enabled()
        forest.split_gains(out[str(cuda)][3].to(cuda))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(free, det)
    assert torch.equal(free.cpu(), torch.bincount(
        idx.cpu(), minlength=5000).float())


@pytest.mark.cuda
def test_device_sampler_with_cuda_generator(cuda):
    """``sample_pixels_device`` on the card with a CUDA generator: the
    same seed gives the same draw; no pixel twice; every valid draw is
    foreground with its own label; a frame with fewer than S foreground
    pixels and an empty frame are handled."""
    from avatar_tpu_torch.train import forest

    rng = np.random.default_rng(3)
    B, H, W, S = 4, 48, 64, 500
    mask = rng.integers(0, 14, (B, H, W)).astype(np.uint8)
    mask[:, :, :20] = 255
    mask[2, :, 22:] = 255                       # 96 foreground pixels
    mask[3] = 255                               # none
    depth = np.where(mask != 255, 2.0, 0.0).astype(np.float32)
    depth_t, mask_t = (torch.as_tensor(a, device=cuda) for a in (depth, mask))
    draws = []
    for _ in range(2):
        gen = torch.Generator(device=cuda).manual_seed(11)
        draws.append(forest.sample_pixels_device(depth_t, mask_t, S, 14,
                                                 0.5, gen))
    for a, b in zip(*draws):
        assert torch.equal(a, b)
    x, y, part, valid = (a.cpu() for a in draws[0])
    assert valid.sum(1).tolist() == [S, S, 96, 0]
    for k in range(B):
        pix = (y[k].long() * W + x[k])[valid[k]]
        assert pix.unique().numel() == pix.numel()
        assert (mask[k][y[k][valid[k]], x[k][valid[k]]] ==
                part[k][valid[k]].numpy()).all()
    assert (part[~valid] == 0).all()


@pytest.mark.cuda
def test_trainer_with_cache_left_on_host(cuda, monkeypatch):
    """A host-made frame cache larger than half of the card's free memory
    stays on the host, and the flat mode then scans image batches uploaded
    one by one: the same tree as with the cache on the card."""
    from avatar_tpu_torch.train import forest

    rng = np.random.default_rng(5)
    n_img, H, W = 12, 48, 64
    mask = np.full((n_img, H, W), 255, np.uint8)
    depth = np.zeros((n_img, H, W), np.float32)
    for i in range(n_img):          # a body of 6 bands at changing depth
        x0 = int(rng.integers(5, 20))
        for part in range(6):
            mask[i, 8 * part:8 * part + 8, x0:x0 + 30] = part
        depth[i][mask[i] != 255] = 1.5 + 0.2 * i
        depth[i] += np.where(mask[i] != 255, 0.05 * mask[i], 0.0
                             ).astype(np.float32)

    class Source:
        def size(self):
            return n_img

        def load_batch(self, ids):
            return depth[np.asarray(ids)], mask[np.asarray(ids)]

    kw = dict(num_parts=6, num_images=n_img, num_points_per_image=200,
              num_features=16, max_probe_offset=30.0, min_samples=8,
              max_tree_depth=5, image_batch=5, seed=2, frame_source=Source())
    on_card = forest.ForestTrainer(None, None, (H, W), device=cuda, **kw)
    fd = on_card.train()
    assert on_card._depth_cache.is_cuda and (fd.leafid < 0).sum() >= 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1024, 1024))
    on_host = forest.ForestTrainer(None, None, (H, W), device=cuda, **kw)
    fd_host = on_host.train()
    assert not on_host._depth_cache.is_cuda
    for f in ("u", "v", "thresh", "lnode", "rnode", "leafid", "leaf_data"):
        np.testing.assert_array_equal(getattr(fd_host, f), getattr(fd, f))


@pytest.mark.cuda
def test_stage_clock_reads_a_known_length(cuda):
    """The stage clock around device work of a known length (a spin of
    ``torch.cuda._sleep`` cycles, timed by CUDA events on its own): each
    scope reads its own length within 10%, nested scopes nest, nothing is
    read before the clock's one synchronise, and with no clock active a
    scope makes no event."""
    from avatar_tpu_torch import profiling

    def spin(ms_at_2ghz):
        torch.cuda._sleep(int(ms_at_2ghz * 2.0e6))

    spin(1.0)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    spin(10.0)
    b.record()
    b.synchronize()
    unit = a.elapsed_time(b) / 10.0          # ms per nominal ms of spin
    made = []
    real = profiling._new_event
    profiling._new_event = lambda: made.append(1) or real()
    try:
        with profiling.scope("frame"):
            spin(1.0)
        assert not made
        with profiling.stage_clock(cuda) as clock:
            with profiling.scope("frame"):
                with profiling.scope("fit"):
                    spin(20.0)
                    with profiling.scope("nn"):
                        spin(10.0)
                with profiling.scope("glue/diag"):
                    spin(5.0)
            assert not clock.stages
    finally:
        profiling._new_event = real
    assert 0 < len(made) <= 8
    st = clock.stages
    assert {k: (v["entries"], v["depth"]) for k, v in st.items()} == {
        "frame": (1, 0), "fit": (1, 1), "fit/nn": (1, 2),
        "glue/diag": (1, 1)}
    for name, want in (("fit/nn", 10.0), ("fit", 30.0), ("glue/diag", 5.0),
                       ("frame", 35.0)):
        got = st[name]["elapsed_ms"]
        assert abs(got - want * unit) <= 0.1 * want * unit, (name, got, unit)
    # the host only queued the spins: its own time is far below the device's
    assert st["frame"]["host_ms"] < 0.5 * st["frame"]["elapsed_ms"]
    assert st["fit"]["elapsed_ms"] >= st["fit/nn"]["elapsed_ms"]
    # the timers: a blocked call holds the spin, queued calls run back to back
    jit = profiling.time_jitted(spin, 5.0, iters=5, warmup=1, device=cuda)
    assert abs(jit["p50_ms"] - 5.0 * unit) <= 0.1 * 5.0 * unit + 0.05
    am = profiling.time_amortized(spin, 5.0, iters=5, warmup=1, device=cuda)
    assert abs(am["ms"] - 5.0 * unit) <= 0.1 * 5.0 * unit + 0.05


@pytest.mark.cuda
def test_trace_attribution_on_card(cuda, tmp_path):
    """``device_trace`` on the card: kernels are attributed, through the
    correlation id of their launches, to the scope that queued them even
    when they run after the host has left it."""
    from avatar_tpu_torch import profiling

    x = torch.ones((2048, 2048), device=cuda)
    (x @ x).sum().item()
    with profiling.device_trace(str(tmp_path), cuda):
        for _ in range(2):
            with profiling.scope("frame"):
                with profiling.scope("fit"):
                    for _ in range(8):
                        y = x @ x             # queued here, runs later
                with profiling.scope("sync"):
                    float(y[0, 0])
    out = profiling.trace_attribution(str(tmp_path), 2)
    assert out["on_device"] and out["total_ms"] > 0
    assert out["scopes"]["fit"]["launches"] >= 8
    assert out["stages"]["fit"] > 0.8 * out["total_ms"]
    assert abs(sum(out["stages"].values()) - out["total_ms"]) <= 0.01


@pytest.mark.cuda
def test_synthetic_camera_on_card_matches_cpu(cuda):
    """The synthetic camera rendering on the card against the same camera
    on the CPU, from one seed: foreground masks differ on at most 3 edge
    pixels per frame, XYZ within 1e-5 m where both are body, RGB within 1
    grey level."""
    from avatar_tpu_torch.io.camera import SyntheticCamera

    size = (360, 640)
    card = SyntheticCamera(image_size=size, seed=7, device=cuda)
    cpu = SyntheticCamera(image_size=size, seed=7, device="cpu")
    for _ in range(4):
        (xg, rg), (xc, rc) = card.next_frame(), cpu.next_frame()
        fg, fc = xg[..., 2] < card.wall_depth, xc[..., 2] < cpu.wall_depth
        assert fc.sum() > 1000 and (fg != fc).sum() <= 3
        np.testing.assert_allclose(xg[fg & fc], xc[fg & fc], rtol=0,
                                   atol=1e-5)
        assert np.abs(rg.astype(int) - rc.astype(int)).max() <= 1


@pytest.mark.cuda
def test_native_library_builds_into_build_dir(cuda):
    """The host library builds with the card machine's C++ compiler into
    ``avatar_tpu_torch/_build/`` and is what serves the codec."""
    from pathlib import Path

    from avatar_tpu_torch.native import build, rle

    path = Path(build.build(verbose=False))
    assert path.parent.name == "_build" and path.exists()
    assert rle._load_native()._name == str(path)
    d = np.zeros((6, 7), np.float32)
    d[2:4, 3:] = 1.5
    np.testing.assert_array_equal(rle.decode(rle.encode(d)), d)


@pytest.mark.cuda
def test_demo_on_card_launches_b1(cuda, tmp_path):
    """``demo.main`` on the card (its default device) at 160x160, host and
    fused, over frames rendered and a forest trained on the card."""
    from avatar_tpu_torch.io.calibration import CameraIntrin
    from avatar_tpu_torch.io.dataset import DatasetWriter
    from avatar_tpu_torch.testing import synthetic_model
    from avatar_tpu_torch.tools import demo, rtree_train
    from avatar_tpu_torch.train import synth

    cam = ["--width", "160", "--height", "160", "--fx", "140", "--fy",
           "140", "--cx", "80", "--cy", "80"]
    model = synthetic_model(detail=1, device=cuda)
    intrin = CameraIntrin(fx=140.0, fy=140.0, cx=80.0, cy=80.0)
    src = synth.make_source(model, intrin, n_images=3, seed=0)
    depth, _, _ = synth.render_batch(src, model.parents, [0, 1, 2], 0, 160,
                                     160, model.num_shape_keys())
    ds = str(tmp_path / "ds")
    w = DatasetWriter(ds, intrin, pad=8)
    for i in range(3):
        w.write_depth(i, depth[i].cpu().numpy())
    tree = str(tmp_path / "t.srtr")
    rtree_train.main([tree, "--synthetic-model", "1", "--images", "10",
                      "--pixels", "200", "--features", "16", "--depth", "5",
                      "--min-samples", "20", "--probe", "70", *cam, "-q"])
    for fused in ([], ["--fused"]):
        before = nn_kernel.LAUNCHES["nn_argmin_ranges"]
        demo.main([ds, tree, "-i", "0", "-p", "8", "--synthetic-model", "1",
                   "-I", "2", "-M", "100", "--max-frames", "3", *fused])
        torch.cuda.synchronize()
        assert nn_kernel.LAUNCHES["nn_argmin_ranges"] > before


@pytest.mark.cuda
def test_mesh_world_of_one_on_card(cuda):
    """A world of one over NCCL: the sharded passes equal the local ones
    on the card to the bit, and the mesh trainer grows batch mode's
    tree."""
    import torch.distributed as dist

    from avatar_tpu_torch.io.calibration import CameraIntrin
    from avatar_tpu_torch.parallel import training as ptrain
    from avatar_tpu_torch.testing import synthetic_model
    from avatar_tpu_torch.train import forest, synth

    model = synthetic_model(detail=1, device=cuda)
    intrin = CameraIntrin(fx=120.0, fy=120.0, cx=48.0, cy=48.0)
    src = synth.make_source(model, intrin, n_images=16, seed=2)
    depth, mask, _ = synth.render_batch(src, model.parents, np.arange(8), 2,
                                        96, 96, model.num_shape_keys())
    gen = torch.Generator(device=cuda).manual_seed(0)
    sx, sy, part, valid = forest.sample_pixels_device(depth, mask, 64, 24,
                                                      0.5, gen)
    nl = torch.where(valid, torch.randint(0, 2, valid.shape, device=cuda,
                                          generator=gen), -1).to(torch.int32)
    fu = torch.rand((12, 2), device=cuda, generator=gen) * 80 - 40
    fv = torch.rand((12, 2), device=cuda, generator=gen) * 80 - 40
    kw = dict(num_parts=24, num_images=16, num_points_per_image=150,
              num_features=16, max_probe_offset=48.0, min_samples=16,
              max_tree_depth=5, image_batch=8, seed=9)
    with ptrain.make_mesh(1) as mesh:
        assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
        mn, mx = ptrain.sharded_pass_minmax(mesh, depth, sx, sy, valid, nl,
                                            fu, fv, 2)
        counts = ptrain.sharded_pass_counts(mesh, depth, sx, sy, part, valid,
                                            nl, fu, fv, mn, mx, 2, 8, 24)
        fd_m = forest.ForestTrainer(model, intrin, (96, 96), mesh=mesh,
                                    **kw).train()
    rmn, rmx = forest.pass_minmax(depth, sx, sy, valid, nl, fu, fv, 2)
    assert torch.equal(mn, rmn) and torch.equal(mx, rmx)
    assert torch.equal(counts, forest.pass_counts(
        depth, sx, sy, part, valid, nl, fu, fv, rmn, rmx, 2, 8, 24))
    fd_b = forest.ForestTrainer(model, intrin, (96, 96), pass_mode="batch",
                                **kw).train()
    for f in ("u", "v", "thresh", "lnode", "rnode", "leafid", "leaf_data"):
        np.testing.assert_array_equal(getattr(fd_m, f), getattr(fd_b, f))
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_optim_tool_on_card_launches_b1(cuda):
    """``optim_tool`` on the card (its default device), the reference
    test's flow: the fit recovers the pose through B1."""
    from avatar_tpu_torch.tools import optim_tool

    before = nn_kernel.LAUNCHES["nn_argmin_ranges"]
    post = optim_tool.main(["--synthetic-model", "1", "--size", "192x192",
                            "--icp-iters", "3", "--interval", "2"])
    torch.cuda.synchronize()
    assert post < 0.08
    assert nn_kernel.LAUNCHES["nn_argmin_ranges"] > before


@pytest.fixture
def deterministic(monkeypatch):
    """Deterministic algorithms (the scatter-adds' sorted paths), as
    ``chip_smoke.py`` runs: without them two runs of a frame differ in the
    last bits."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.cuda
def test_track_batch_on_card_equals_frame_chain(cuda, deterministic):
    """``FusedTracker.track_batch`` on the card (the detail-2 model at
    256x256, the 3-tree r5 forest, bgsub, the tracked window, 14 groups)
    against ``_fused_frame_impl`` called frame by frame with the batch's
    arguments from the same state, with deterministic algorithms: poses,
    part centres and results equal to the bit, and B1 launched."""
    from avatar_tpu_torch.core import rotation
    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.io.calibration import CameraIntrin
    from avatar_tpu_torch.perception.partgroups import SMPL24_GROUP_LUT
    from avatar_tpu_torch.perception.rtree import RTree
    from avatar_tpu_torch.render.renderer import AvatarRenderer
    from avatar_tpu_torch.testing import synthetic_model
    from avatar_tpu_torch.tracking import TrackerConfig
    from avatar_tpu_torch.tracking_fused import (FusedTracker,
                                                 _fused_frame_impl,
                                                 unpack_diag)

    size, wall = (256, 256), 6.0
    intrin = CameraIntrin(fx=606.438, fy=606.351, cx=128.0, cy=128.0)
    model = synthetic_model(detail=2, device=cuda)
    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 4.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    step = rotation.so3_exp(torch.as_tensor(np.random.default_rng(8).normal(
        0, 0.03, (24, 3)), dtype=torch.float32)).numpy()
    frames = []
    for _ in range(5):
        gt.update()
        depth = AvatarRenderer(gt, intrin).render_depth(size)
        frames.append((np.where(depth > 0, depth, wall) * 1000).astype(
            np.uint16))
        gt.r = np.einsum("jab,jbc->jac", step, gt.r)
        gt.p = gt.p + np.array([0.02, 0.0, 0.01])
    trees = [RTree(f"data/bench_forest_r5{s}.srtr", device=cuda)
             for s in ("", "_1", "_2")]
    for t in trees:
        t.partmap_type = 0
    cfg = TrackerConfig(data_interval=3, min_points=300, rtree_interval=3,
                        frame_icp_iters=1, reinit_icp_iters=1,
                        initial_icp_iters=1, iters_per_icp=3,
                        reinit_seeds=2, label_conf_thresh=0.55,
                        beta_pose=0.3, seg_window=(252, 210),
                        part_groups=tuple(SMPL24_GROUP_LUT))
    tracker = FusedTracker(model, intrin, size, rtree=trees, config=cfg)
    tracker.set_background(np.full(size, wall, np.float32))
    assert tracker.track(frames[0]).ok
    kw = tracker._frame_kwargs(cfg.frame_icp_iters * cfg.iters_per_icp)
    th_prev = kw.pop("theta_prev")
    th, com = tracker._theta, tracker.com_pre
    before = nn_kernel.LAUNCHES["nn_argmin_ranges"]
    results = tracker.track_batch(frames[1:])
    torch.cuda.synchronize()
    assert nn_kernel.LAUNCHES["nn_argmin_ranges"] > before
    for i, (frame, res) in enumerate(zip(frames[1:], results)):
        out = _fused_frame_impl(
            tracker._ctx, tracker._ctx_fit, tracker._tree, model.parents,
            tracker._upload(tracker._pre_stride(frame)),
            tracker._zero_labels, tracker._bg, tracker._intrin4, th, com,
            theta_prev=th_prev, **kw)
        th_prev, th, com = th, out.theta, out.com_pre
        for a, b in zip(tracker.batch_thetas, out.theta):
            assert torch.equal(a[i], b), f"frame {i + 1}"
        diag = unpack_diag(out.host_diag, tracker.num_parts)
        assert (res.n_points, res.fit_info) == (
            diag.n_points, tracker._fit_info(diag))
    assert all(r.ok for r in results)
    assert torch.equal(tracker.com_pre, com)


def _card_fit_inputs(cuda, n_rows):
    """A detail-2 model's fit context on the card (6 parts), a start near a
    random pose and 700 noisy samples of it (the last 60 wildcards) in
    ``n_rows`` rows, numpy-seeded."""
    from avatar_tpu_torch.core import rotation
    from avatar_tpu_torch.optim import gauss_newton as gn
    from avatar_tpu_torch.testing import synthetic_model

    model = synthetic_model(detail=2, device=cuda)
    part = torch.as_tensor((model.main_joint % 6).astype(np.int32),
                           device=cuda)
    pp = model.pose_prior
    ctx = gn.FitContext(
        lbs=model.params, anc_mask=torch.as_tensor(
            model.ancestor_mask, dtype=torch.float32, device=cuda),
        faces=torch.as_tensor(model.faces, dtype=torch.int32, device=cuda),
        model_part=part, prior=gn.PriorData(pp.means, pp.prec_cho,
                                            pp.consts_log))
    rng = np.random.default_rng(31)
    J, K = model.num_joints(), model.num_shape_keys()
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    gt = gn.Theta(p=f32([0.05, -0.02, 2.6]), rots=rotation.so3_exp(
        f32(rng.normal(0, 0.25, (J, 3)))), w=f32(rng.normal(0, 0.3, K)))
    x = gn._forward(ctx, model.parents, gt, True)[0].cpu().numpy()
    pick = rng.choice(x.shape[0], 700, replace=False)
    pts = np.zeros((n_rows, 3), np.float32)
    pts[:700] = x[pick] + rng.normal(0, 0.003, (700, 3))
    parts = np.full(n_rows, -1, np.int32)
    parts[:700] = part.cpu().numpy()[pick]
    parts[640:700] = 6
    theta0 = gn.Theta(p=gt.p + f32([0.03, 0.02, -0.02]), rots=torch.einsum(
        "jab,jbc->jac", rotation.so3_exp(f32(rng.normal(0, 0.05, (J, 3)))),
        gt.rots), w=torch.zeros(K, device=cuda))
    return model, ctx, f32(pts), torch.as_tensor(parts, device=cuda), theta0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fit_planned", "fit_unplanned", "refine"])
def test_graphed_fit_equals_eager_fit(cuda, deterministic, case):
    """A fit whose LM steps replay captured CUDA graphs equals the same fit
    run uncaptured (``eager_steps``) to the bit: theta, cost, matches,
    accepted steps, last correspondences and part counts; a second graphed
    fit with other prior weights reuses the program and equals its eager
    fit too; every replay counts the searches it launched."""
    from avatar_tpu_torch.optim import gauss_newton as gn
    from avatar_tpu_torch.optim.surface import vertex_face_rings

    model, ctx, pts, parts, theta0 = _card_fit_inputs(
        cuda, 1000 if case == "fit_unplanned" else 1024)
    ring = torch.as_tensor(vertex_face_rings(model.faces,
                                             model.num_points()), device=cuda)
    name = "nn_argmin" if case == "fit_unplanned" else "nn_argmin_ranges"

    def run(bp):
        if case == "refine":
            return gn.fit_refine(ctx, model.parents, ring, pts, parts, theta0,
                                 bp, bp, n_steps=12, num_parts=6, wild=6,
                                 wild_gate2=torch.tensor(0.04, device=cuda),
                                 freeze_shape=True, programs=programs)
        return gn.fit(ctx, model.parents, pts, parts, theta0, bp, 0.12,
                      n_steps=20, num_parts=6, robust_per_part=True,
                      freeze_shape=True, beta_temp=0.3, clamp_angle=0.25,
                      wild_gate=0.2, wild_weight=0.7, programs=programs)

    programs = {}
    for first, bp in ((True, 0.03), (False, 0.3)):
        before = nn_kernel.LAUNCHES[name]
        with gn.eager_steps():
            eager = run(bp)
        torch.cuda.synchronize()
        n_eager = nn_kernel.LAUNCHES[name] - before
        graphed = run(bp)                    # the first captures
        graphed = run(bp)
        torch.cuda.synchronize()
        n_graphed = nn_kernel.LAUNCHES[name] - before - n_eager
        (prog,) = programs.values()
        assert prog.graphs is not None
        for a, b in zip((*eager[0], *eager[1]), (*graphed[0], *graphed[1])):
            assert a.dtype == b.dtype and torch.equal(a, b)
        # two graphed fits of the eager one's steps, and the capture's one
        # uncaptured run of each step function before the first
        assert n_eager > 0 and n_graphed == 2 * n_eager + first


@pytest.mark.cuda
def test_eager_lm_step_does_not_synchronise(cuda):
    """Both step functions of a fit's program run under
    ``set_sync_debug_mode("error")``: no synchronising copy or read."""
    from avatar_tpu_torch.optim import gauss_newton as gn

    model, ctx, pts, parts, theta0 = _card_fit_inputs(cuda, 1024)
    programs = {}
    with gn.eager_steps():
        gn.fit(ctx, model.parents, pts, parts, theta0, 0.03, 0.12, n_steps=3,
               num_parts=6, robust_per_part=True, freeze_shape=True,
               programs=programs)
    (prog,) = programs.values()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prog.fns["lin"]()
        prog.fns["step"]()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

