"""Random-forest training (counterpart of ``avatar_tpu/train/forest.py``:
breadth-first, tensorized; reference trainers RTree.cpp:551-2948).

Per level, per chunk of frontier nodes:

    pass 1: feature scores of every (sample, feature) -> segment min/max
    pass 2: bucket the scores into T bins -> scatter-add counts
            [node, feature, bucket, part]
    gains:  entropy sweep over bucket prefix sums
    split:  best (feature, threshold) per node; samples reassigned by one
            more scoring pass

Synthetic frames render on the device from their image ids
(``train/synth.py``) and are cached there as 16-bit millimetres; frames
of a host source (files, or any object with ``size()`` and
``load_batch(ids)``) are sampled on the host with numpy.

What keeps a tree equal to the reference's on the same frames and samples:
the probe offset is ``round(fu / z)`` (half to even) and the bucket is
``((s - mn) / max(rg, 1e-6) * T)`` truncated, both in float32 and in the
reference's operation order; the histogram counts are whole numbers in
float32, exact in any order of addition; ``argmax`` takes the first
maximum.  The gains go through ``log`` and a sum over parts, so two
implementations agree on them to rounding only, and a near-tie of two
gains may pick another feature.

Checkpoints are npz files with the reference's keys: one written by
either package resumes in the other when the frames come from a shared
frame source (the two packages' synthetic generators draw from different
random streams).

Over several devices (``mesh``, from ``parallel/training.py``; ``devices``)
every rank of the process group holds rank 0's frame cache and samples,
each image batch is split over the ranks, and the per-rank min/max and
counts are all-reduced, so every rank grows the one-device tree.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from avatar_tpu_torch.device import get_device
from avatar_tpu_torch.io import formats
from avatar_tpu_torch.train import synth

BACKGROUND_DEPTH = 20.0
_BIG = 3e38


def _placed(dev: torch.device) -> torch.device:
    """``dev`` with the index a bare ``cuda`` stands for."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Samples(NamedTuple):
    """Per-image fixed-size pixel samples ([N_img, S] each, on the
    trainer's device)."""
    x: torch.Tensor      # int32
    y: torch.Tensor      # int32
    part: torch.Tensor   # int32 (ground-truth body part)
    valid: torch.Tensor  # bool


# ---------------------------------------------------------------------------
# the frame cache: uint16 millimetres, kept as their bits in int16 (every
# device indexes and gathers int16)
# ---------------------------------------------------------------------------


def _encode_mm(depth_m: torch.Tensor) -> torch.Tensor:
    """f32 metres -> uint16 millimetres, as int16 bits."""
    return torch.round(depth_m * 1000.0).to(torch.int32).to(torch.int16)


def _decode_mm(bits: torch.Tensor) -> torch.Tensor:
    """int16 bits of uint16 millimetres -> f32 metres."""
    return (bits.to(torch.int32) & 0xFFFF).to(torch.float32) * 1e-3


def _cache_write(cache: torch.Tensor, depth_m: torch.Tensor,
                 start: int) -> None:
    """Fill one batch of rendered frames (f32 metres) into the preallocated
    frame cache in place: one cache copy is the memory ceiling."""
    cache[start:start + depth_m.shape[0]] = _encode_mm(depth_m)


@contextlib.contextmanager
def _any_order_sums(t: torch.Tensor):
    """Let a CUDA scatter-add take its atomic path inside the block even
    under ``torch.use_deterministic_algorithms(True)``.  Only for sums of
    whole numbers below 2^24 in float32: those are exact, so the order of
    the additions cannot change the result."""
    on = t.is_cuda and torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    if on:
        torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        if on:
            torch.use_deterministic_algorithms(True, warn_only=warn_only)


def _count(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Histogram of ``idx`` (any shape, values in [0, size)) as float32
    [size]: a scatter-add of ones."""
    idx = idx.reshape(-1)
    with _any_order_sums(idx):
        return torch.zeros(size, dtype=torch.float32,
                           device=idx.device).scatter_add_(
            0, idx, torch.ones(1, dtype=torch.float32,
                               device=idx.device).expand(idx.shape[0]))


# ---------------------------------------------------------------------------
# level passes
# ---------------------------------------------------------------------------


def _flat_scores(cache_flat, H: int, W: int, pos, sx, sy, live, fu, fv):
    """Depth-probe scores for selected samples: [M, F].

    cache_flat: [N_img*H*W] int16 bits of uint16 millimetres (or f32
    metres); pos [M] flat offset of the sample's image (image id * H*W);
    sx/sy [M]; live [M] bool; fu/fv [F,2] shared pool or [M,F,2] per-sample
    sets.  Probe semantics: getDepth with image bounds (RTree.cpp:40-68).
    """
    HW = H * W
    pos, sx, sy = pos.long(), sx.long(), sy.long()

    def rd(idx):
        v = cache_flat[idx]
        return _decode_mm(v) if v.dtype == torch.int16 else v

    z = rd(pos + sy * W + sx)                                   # [M]
    z = torch.where(live & (z > 0), z, 1.0)

    def probe(off):                                             # [M,F,2]
        px = sx[:, None] + off[..., 0]
        py = sy[:, None] + off[..., 1]
        inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        pz = rd(pos[:, None] + torch.clamp(py * W + px, 0, HW - 1))
        pz = torch.where(pz == 0.0, BACKGROUND_DEPTH, pz)
        return torch.where(inside, pz, BACKGROUND_DEPTH)

    u_off = torch.round(fu / z[:, None, None]).long()
    v_off = torch.round(fv / z[:, None, None]).long()
    return probe(u_off) - probe(v_off)                          # [M,F]


def _per_sample(fu, fv, node_local):
    """Per-node feature sets [NC,F,2] gathered to each sample's node."""
    if fu.ndim == 3:
        nl = torch.clamp(node_local, 0, fu.shape[0] - 1).long()
        return fu[nl], fv[nl]
    return fu, fv


def pass_minmax_flat(cache_flat, pos, sx, sy, node_local, fu, fv,
                     H: int, W: int, n_chunk: int):
    """Per (chunk-node, feature) score min/max over selected samples.

    fu/fv: [F,2] shared pool or [NC,F,2] per-node feature sets;
    node_local [M], -1 for rows to skip.
    """
    F = fu.shape[-2]
    live = node_local >= 0
    fu, fv = _per_sample(fu, fv, node_local)
    s = _flat_scores(cache_flat, H, W, pos, sx, sy, live, fu, fv)
    nl = torch.where(live, node_local, n_chunk).long()
    idx = (nl[:, None] * F + torch.arange(F, device=s.device)).reshape(-1)
    s_min = torch.where(live[:, None], s, _BIG).reshape(-1)
    s_max = torch.where(live[:, None], s, -_BIG).reshape(-1)
    smin = torch.full(((n_chunk + 1) * F,), _BIG, device=s.device
                      ).scatter_reduce_(0, idx, s_min, "amin")
    smax = torch.full(((n_chunk + 1) * F,), -_BIG, device=s.device
                      ).scatter_reduce_(0, idx, s_max, "amax")
    return (smin[: n_chunk * F].reshape(n_chunk, F),
            smax[: n_chunk * F].reshape(n_chunk, F))


def pass_counts_flat(cache_flat, pos, sx, sy, part, node_local, fu, fv,
                     smin, smax, H: int, W: int, n_chunk: int,
                     n_buckets: int, n_parts: int):
    """Histogram counts [n_chunk, F, n_buckets, n_parts] over selected
    samples."""
    F = fu.shape[-2]
    live = node_local >= 0
    fu, fv = _per_sample(fu, fv, node_local)
    s = _flat_scores(cache_flat, H, W, pos, sx, sy, live, fu, fv)
    nl = torch.where(live, node_local, n_chunk).long()
    nl_safe = torch.clamp(nl, max=n_chunk - 1)
    mn = smin[nl_safe]                                          # [M,F]
    rg = (smax - smin)[nl_safe]
    # a float32 divide and multiply, truncated: kept in this order
    bucket = torch.clamp(((s - mn) / torch.clamp(rg, min=1e-6) *
                          n_buckets).to(torch.int32), 0, n_buckets - 1)
    f_ids = torch.arange(F, device=s.device)
    idx = ((nl[:, None] * F + f_ids) * n_buckets + bucket) * n_parts + \
        part.long()[:, None]
    n_cells = n_chunk * F * n_buckets * n_parts
    idx = torch.where(live[:, None], idx, n_cells)
    return _count(idx, n_cells + 1)[:-1].reshape(n_chunk, F, n_buckets,
                                                 n_parts)


def pass_assign_flat(cache_flat, pos, sx, sy, node, best_u, best_v,
                     best_thresh, lchild, rchild, is_split,
                     H: int, W: int):
    """Route selected samples through their node's chosen split: [M].

    node [M] global node ids (-1 for rows to skip); best_* indexed by
    global node id.
    """
    nd = torch.clamp(node, min=0).long()
    live = node >= 0
    s = _flat_scores(cache_flat, H, W, pos, sx, sy, live,
                     best_u[nd][:, None], best_v[nd][:, None])[:, 0]
    child = torch.where(s < best_thresh[nd], lchild[nd], rchild[nd])
    return torch.where(is_split[nd] & live, child.to(node.dtype), node)


# The batch-major passes take one image batch (depth [B,H,W] f32 metres,
# samples [B,S]) and scan all of it for every node chunk; they are the
# flat passes over the batch's flattened samples.


def _batch_pos(depth, sx):
    B, H, W = depth.shape
    pos = torch.arange(B, device=depth.device)[:, None] * (H * W)
    return pos.expand(sx.shape).reshape(-1)


def _feature_scores(depth, sx, sy, valid, fu, fv, node_local=None):
    """Depth-probe scores for every (sample, feature) of an image batch.

    depth [B,H,W]; sx/sy/valid [B,S]; fu/fv either [F,2] (feature pool
    shared by all nodes) or [NC,F,2] (per-node feature sets, gathered
    through node_local [B,S]) -> scores [B,S,F].
    """
    B, H, W = depth.shape
    if fu.ndim == 3:
        fu, fv = _per_sample(fu, fv, node_local.reshape(-1))
    s = _flat_scores(depth.reshape(-1), H, W, _batch_pos(depth, sx),
                     sx.reshape(-1), sy.reshape(-1), valid.reshape(-1),
                     fu, fv)
    return s.reshape(B, sx.shape[1], -1)


def _valid_only(node, valid):
    """The batch's node ids (local or global), -1 where not valid: [B*S]."""
    return torch.where(valid, node, -1).reshape(-1)


def pass_minmax(depth, sx, sy, valid, node_local, fu, fv, n_chunk: int):
    """Per (chunk-node, feature) score min/max for one image batch.

    fu/fv: [F,2] shared pool or [NC,F,2] per-node feature sets.
    """
    _, H, W = depth.shape
    return pass_minmax_flat(
        depth.reshape(-1), _batch_pos(depth, sx), sx.reshape(-1),
        sy.reshape(-1), _valid_only(node_local, valid), fu, fv, H, W,
        n_chunk)


def pass_counts(depth, sx, sy, part, valid, node_local, fu, fv, smin, smax,
                n_chunk: int, n_buckets: int, n_parts: int):
    """Histogram counts [n_chunk, F, n_buckets, n_parts] for one batch.

    fu/fv: [F,2] shared pool or [NC,F,2] per-node feature sets.
    """
    _, H, W = depth.shape
    return pass_counts_flat(
        depth.reshape(-1), _batch_pos(depth, sx), sx.reshape(-1),
        sy.reshape(-1), part.reshape(-1), _valid_only(node_local, valid),
        fu, fv, smin, smax, H, W, n_chunk, n_buckets, n_parts)


def pass_assign(depth, sx, sy, valid, node, best_u, best_v, best_thresh,
                lchild, rchild, is_split):
    """Reassign the samples of one image batch to children through their
    node's chosen split.

    node [B,S] global node ids; best_* indexed by global node id.
    """
    _, H, W = depth.shape
    out = pass_assign_flat(
        depth.reshape(-1), _batch_pos(depth, sx), sx.reshape(-1),
        sy.reshape(-1), _valid_only(node, valid), best_u, best_v,
        best_thresh, lchild, rchild, is_split, H, W)
    return torch.where(valid, out.reshape(node.shape), node)


def sample_pixels_device(depth, mask, S: int, num_parts: int, balance,
                         generator: torch.Generator):
    """Weighted foreground pixel sampling on the frames' device.

    Gumbel top-k draws S pixels per image without replacement from the
    blended uniform/inverse-part-frequency distribution of
    ``_sample_pixels``; ``generator`` lives on that device.  Returns
    (x, y, part, valid), each [B, S]; an image with fewer than S
    foreground pixels has ``valid`` false on the rest.
    """
    B, H, W = depth.shape
    dev = depth.device
    fg = ((mask != 255) & (depth > 0)).reshape(B, -1)
    mask = mask.reshape(B, -1).long()
    lab = torch.where(fg, mask, num_parts)
    rows = torch.arange(B, device=dev)[:, None] * (num_parts + 1)
    cnt = _count(rows + lab, B * (num_parts + 1)).reshape(B, num_parts + 1)
    cnt = cnt[:, :num_parts]
    n_fg = cnt.sum(dim=1)
    n_present = torch.clamp((cnt > 0).sum(dim=1).to(torch.float32), min=1.0)
    inv = torch.where(cnt > 0, 1.0 / cnt, 0.0)
    inv = torch.cat([inv, torch.zeros((B, 1), device=dev)], dim=1)
    w = ((1.0 - balance) / torch.clamp(n_fg, min=1.0)[:, None] +
         balance * torch.gather(inv, 1, lab) / n_present[:, None])
    logw = torch.where(fg, torch.log(torch.clamp(w, min=1e-30)), -torch.inf)
    u = torch.rand(logw.shape, device=dev, generator=generator)
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-10)))
    idx = torch.topk(logw + g, S, dim=1).indices                # [B, S]
    valid = torch.gather(fg, 1, idx)
    # rows of -inf still return S indices: gate on the gathered foreground
    # flag and zero the part, so that scatter indices stay in range
    part = torch.where(valid, torch.gather(mask, 1, idx), 0)
    return ((idx % W).to(torch.int32), (idx // W).to(torch.int32),
            part.to(torch.int32), valid)


def split_gains(counts):
    """Entropy info gain over bucket prefix sums.

    counts [NC, F, T, P] -> (gains [NC, F, T-1], totals [NC, P]).
    Matches optimalInformationGain3's sweep (RTree.cpp:2782-2850): the
    candidate thresholds are the T-1 bucket boundaries; the gain is the
    (unnormalized) reduction n*H(total) - nl*H(l) - nr*H(r).
    """
    # the prefix sums one bucket at a time: a float cumsum has no
    # deterministic CUDA kernel, and T is small
    run = counts[:, :, 0]
    left = [run]
    for t in range(1, counts.shape[2] - 1):
        run = run + counts[:, :, t]
        left.append(run)
    left = torch.stack(left, dim=2)                             # [NC,F,T-1,P]
    total = counts.sum(dim=2)                                   # [NC,F,P]
    right = total[:, :, None] - left

    def ent(c):  # unnormalized: n*H = n log n - sum c log c
        n = c.sum(dim=-1)
        return n * torch.log(torch.clamp(n, min=1e-12)) - torch.sum(
            c * torch.log(torch.clamp(c, min=1e-12)), dim=-1)

    gains = ent(total[:, :, None]) - ent(left) - ent(right)
    return gains, total[:, 0]                                   # same per f


def split_decide(counts, smin, smax, n_buckets: int):
    """Per-node best split on the device; the first maximum wins a tie.

    Returns (gain, f_best, thresh, score_range, n, part_hist), [NC] each
    (part_hist [NC, P]).
    """
    gains, _ = split_gains(counts)                              # [NC,F,T-1]
    NC, F, Tm1 = gains.shape
    flat = gains.reshape(NC, F * Tm1)
    best = torch.argmax(flat, dim=1)
    gain = torch.gather(flat, 1, best[:, None])[:, 0]
    f_best = best // Tm1
    t_best = best % Tm1
    mn = torch.gather(smin, 1, f_best[:, None])[:, 0]
    mx = torch.gather(smax, 1, f_best[:, None])[:, 0]
    thresh = mn + (mx - mn) * (t_best + 1).to(torch.float32) / n_buckets
    part_hist = counts.sum(dim=(1, 2)) / F                      # [NC,P]
    n = part_hist.sum(dim=1)
    return gain, f_best.to(torch.int32), thresh, mx - mn, n, part_hist


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


class _TreeBuilder:
    """Host-side growing node arrays."""

    def __init__(self, num_parts: int):
        self.u = []
        self.v = []
        self.thresh = []
        self.lnode = []
        self.rnode = []
        self.leafid = []
        self.leaf_data = []
        self.num_parts = num_parts

    def add_node(self) -> int:
        self.u.append((0.0, 0.0))
        self.v.append((0.0, 0.0))
        self.thresh.append(0.0)
        self.lnode.append(-1)
        self.rnode.append(-1)
        self.leafid.append(-1)
        return len(self.thresh) - 1

    def make_leaf(self, nid: int, dist: np.ndarray) -> None:
        tot = dist.sum()
        self.leaf_data.append(dist / tot if tot > 0 else
                              np.full_like(dist, 1.0 / len(dist)))
        self.leafid[nid] = len(self.leaf_data) - 1

    def make_split(self, nid: int, u, v, thresh) -> Tuple[int, int]:
        self.u[nid] = tuple(np.asarray(u, np.float64))
        self.v[nid] = tuple(np.asarray(v, np.float64))
        self.thresh[nid] = float(thresh)
        l = self.add_node()
        r = self.add_node()
        self.lnode[nid] = l
        self.rnode[nid] = r
        return l, r

    def to_forest(self) -> formats.ForestData:
        n = len(self.thresh)
        leaf_data = (np.stack(self.leaf_data) if self.leaf_data
                     else np.zeros((0, self.num_parts), np.float32))
        return formats.ForestData(
            np.asarray(self.u, np.float32).reshape(n, 2),
            np.asarray(self.v, np.float32).reshape(n, 2),
            np.asarray(self.thresh, np.float32),
            np.asarray(self.lnode, np.int32),
            np.asarray(self.rnode, np.int32),
            np.asarray(self.leafid, np.int32),
            leaf_data.astype(np.float32), self.num_parts)


def _sample_pixels(depth: np.ndarray, mask: np.ndarray, S: int,
                   rng: np.random.Generator,
                   balance: float = 0.5) -> Tuple[np.ndarray, ...]:
    """Choose up to S foreground pixels of one frame on the host.

    ``balance`` blends uniform-over-foreground sampling (0.0, the
    reference's strategy) with equal-per-part sampling (1.0): small parts
    (hands, feet) cover <1% of the foreground, and uniformly sampled trees
    never gather enough of their samples to split them out.
    """
    fg = (mask != 255) & (depth > 0)
    ys, xs = np.nonzero(fg)
    n = len(ys)
    if n == 0:
        z = np.zeros(S, np.int32)
        return z, z, z, np.zeros(S, bool)
    labels = mask[ys, xs].astype(np.int64)
    parts, counts = np.unique(labels, return_counts=True)
    # per-pixel weight: (1-b) * uniform + b * (1 / part frequency)
    inv = 1.0 / counts.astype(np.float64)
    wmap = {p: (1.0 - balance) / n + balance * inv[i] / len(parts)
            for i, p in enumerate(parts)}
    w = np.asarray([wmap[l] for l in labels])
    w /= w.sum()
    take = min(S, n)
    idx = rng.choice(n, size=take, replace=False, p=w)
    x = np.zeros(S, np.int32)
    y = np.zeros(S, np.int32)
    p = np.zeros(S, np.int32)
    val = np.zeros(S, bool)
    x[:take] = xs[idx]
    y[:take] = ys[idx]
    p[:take] = mask[ys[idx], xs[idx]]
    val[:take] = True
    return x, y, p, val


class FileFrameSource:
    """Depth + part-mask frame pairs read from two directories.

    Rebuild of the reference's FileDataSource (RTree.cpp:351-420): both
    directories are listed and sorted; pair i is (depth_paths[i],
    mask_paths[i]).  Depth frames may be .exr / .depth (formats.read_depth)
    or any OpenCV-readable image (integer images are taken as millimeters);
    part masks are 8-bit grayscale with 255 = background.
    """

    def __init__(self, depth_dir: str, part_mask_dir: str):
        self.depth_paths = sorted(
            os.path.join(depth_dir, f) for f in os.listdir(depth_dir))
        self.mask_paths = sorted(
            os.path.join(part_mask_dir, f) for f in os.listdir(part_mask_dir))
        if len(self.depth_paths) != len(self.mask_paths):
            raise ValueError(
                f"depth/part-mask count mismatch: {len(self.depth_paths)} vs "
                f"{len(self.mask_paths)}")
        if not self.depth_paths:
            raise ValueError(f"no depth frames found in {depth_dir}")

    def size(self) -> int:
        return len(self.depth_paths)

    def _read_depth(self, path: str) -> np.ndarray:
        if path.endswith(".exr") or path.endswith(".depth"):
            m = formats.read_depth(path)
            return m[..., 2] if m.ndim == 3 else m
        import cv2

        m = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(path)
        if np.issubdtype(m.dtype, np.integer):
            return m.astype(np.float32) * 1e-3  # millimeters -> meters
        return np.asarray(m, np.float32)

    def _read_mask(self, path: str) -> np.ndarray:
        import cv2

        m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(path)
        return np.asarray(m, np.uint8)

    def image_size(self):
        d = self._read_depth(self.depth_paths[0])
        return d.shape[:2]

    def load_batch(self, ids: np.ndarray):
        depth = np.stack([self._read_depth(self.depth_paths[i])
                          for i in ids]).astype(np.float32)
        mask = np.stack([self._read_mask(self.mask_paths[i]) for i in ids])
        return depth, mask


class ForestTrainer:
    """Breadth-first forest trainer (synthetic renders or a frame source).

    Key hyperparameters follow rtree-train defaults (rtree-train.cpp:26-52):
    num_images, num_points_per_image, num_features, max_probe_offset,
    min_samples, max_tree_depth, threshes (buckets).  Trains on the
    model's device; with a frame source and no model, on ``device`` (the
    card unless the caller asks for the CPU).  ``frame_source`` is any
    object with ``size()`` and ``load_batch(ids) -> (depth [B,H,W] f32
    metres, part mask [B,H,W] uint8)``.

    ``level_stats`` holds one record per trained level: its frontier
    nodes, the samples in them, probe evaluations (sample x feature scores
    computed) and wall seconds; ``init_seconds`` is the wall time of
    rendering (or loading) and sampling the frames.

    With a ``mesh`` (``parallel.training.make_mesh``) every rank of its
    process group runs this trainer with the same arguments on its own
    device: rank 0 renders and samples the frames and every rank receives
    them, the passes run image-major (``"auto"`` means ``"batch"``) with
    the image batch rounded up to a multiple of the mesh size and split
    over the ranks, and only rank 0 writes checkpoints and handles SIGINT.
    """

    def __init__(self, model, intrin, image_size, num_parts: int,
                 part_map=None, pose_seq=None, num_images: int = 500,
                 num_points_per_image: int = 1000, num_features: int = 128,
                 max_probe_offset: float = 170.0, min_samples: int = 64,
                 max_tree_depth: int = 13, n_buckets: int = 16,
                 image_batch: int = 16, node_chunk: int = 512,
                 seed: int = 0, verbose: bool = False,
                 checkpoint_path: str = "", mesh: Optional[object] = None,
                 frame_source=None, num_features_filtered: int = 0,
                 filter_subsample: int = 4, filter_buckets: int = 8,
                 feature_block: int = 256, sample_balance: float = 0.5,
                 pass_mode: str = "auto",
                 device: str | torch.device | None = None):
        if device is None:
            device = model.device if model is not None else "cuda"
        self.device = get_device(device)
        self.mesh = mesh
        if mesh is not None and _placed(self.device) != _placed(mesh.device):
            raise ValueError(f"the trainer's device {self.device} is not the "
                             f"mesh rank's device {mesh.device}")
        self.model = model
        self.H, self.W = image_size
        self.num_parts = num_parts
        self.num_images = num_images
        self.S = num_points_per_image
        self.F = num_features
        # TrainerV2's two-stage feature selection (RTree.cpp:1396-2335,
        # proposal ~1455-1550; rtree-train.cpp:33-35): propose num_features,
        # score them SPARSELY (every filter_subsample-th sample or image
        # batch, filter_buckets-bin histograms), keep the top
        # num_features_filtered PER NODE, then dense-count only the
        # survivors.  0 disables the filter stage (one stage, shared pool).
        self.F_filtered = (num_features_filtered
                           if 0 < num_features_filtered < num_features else 0)
        self.filter_subsample = max(filter_subsample, 1)
        self.T_sparse = filter_buckets
        self.Fb = feature_block
        self.max_probe = max_probe_offset
        self.min_samples = min_samples
        self.max_depth = max_tree_depth
        self.T = n_buckets
        self.B = image_batch
        self.node_chunk = node_chunk
        self.seed = seed
        self.verbose = verbose
        self.checkpoint_path = checkpoint_path
        self.frame_source = frame_source
        self.sample_balance = sample_balance
        if frame_source is None:
            self.src = synth.make_source(model, intrin, part_map, pose_seq,
                                         n_images=num_images, seed=seed)
        else:
            self.src = None
            self.num_images = min(num_images, frame_source.size()) \
                if num_images else frame_source.size()
        self._rng = np.random.default_rng(seed)
        self._panic = False
        # pass_mode: "flat" (sample-major: a level costs live samples x
        # features whatever the frontier's size) / "batch" (image-major:
        # every node chunk scans every cached image; shards over a mesh) /
        # "auto" (flat unless a mesh is given).  The flat passes index the
        # flattened cache with int64, so no cache is too large for them.
        if pass_mode not in ("auto", "flat", "batch"):
            raise ValueError(f"unknown pass_mode {pass_mode!r}")
        if pass_mode == "auto":
            pass_mode = "batch" if mesh is not None else "flat"
        if mesh is not None and pass_mode == "flat":
            raise ValueError("mesh training requires pass_mode='batch' "
                             "(image batches shard over the mesh)")
        self.pass_mode = pass_mode
        if mesh is not None:
            # every sharded pass splits the image batch over the ranks
            self.B = -(-self.B // mesh.size) * mesh.size
        # sample-block sizes for the flat passes (the scores [BLK, F] and
        # the probe index tensors bound peak memory)
        self._blk_dense = 1 << 17
        self._blk_filter = 1 << 16
        self._depth_cache = None
        self.level_stats = []
        self.init_seconds = 0.0
        self._probe_evals = self._frontier_samples = 0

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def _lead(self) -> bool:
        """Rank 0 of the mesh, or the one trainer without one."""
        return self.mesh is None or self.mesh.rank == 0

    # -- data -----------------------------------------------------------------

    def _render_batch(self, ids: np.ndarray):
        if self.frame_source is not None:
            return self.frame_source.load_batch(ids)
        depth, mask, _ = synth.render_batch(
            self.src, self.model.parents, ids, self.seed, self.H, self.W,
            self.model.num_shape_keys())
        return depth, mask

    def _new_cache(self) -> torch.Tensor:
        return torch.zeros((self.num_images, self.H, self.W),
                           dtype=torch.int16, device=self.device)

    def _batches(self):
        for start in range(0, self.num_images, self.B):
            yield start, np.arange(start,
                                   min(start + self.B, self.num_images))

    def _init_samples(self):
        """Render every image once, sample S foreground pixels each
        (AvatarTrainerV3::initTraining, RTree.cpp:2424-2497).

        Device-rendered synthetic frames never leave the device: the cache
        is filled in place and the weighted pixel sampling runs there.
        Frames of a host source use the host sampler.  Over a mesh, rank 0
        does this and the other ranks receive its frames and samples.
        """
        if not self._lead:
            self._empty_frames(samples=True)
            self._share_frames(samples=True)
            self._init_node_of()
            return
        on_device = self.frame_source is None
        xs, ys, ps, vs = [], [], [], []
        cache = []
        if on_device:
            self._depth_cache = self._new_cache()
            gen = torch.Generator(device=self.device)
        for start, ids in self._batches():
            depth, mask = self._render_batch(ids)
            if on_device:
                # keyed on (seed, batch start), not drawn from one stream
                gen.manual_seed(int(np.random.SeedSequence(
                    (self.seed ^ 0x5EED, start)).generate_state(1)[0]))
                bx, by, bp, bv = sample_pixels_device(
                    depth, mask, self.S, self.num_parts,
                    self.sample_balance, gen)
                xs.append(bx)
                ys.append(by)
                ps.append(bp)
                vs.append(bv)
                _cache_write(self._depth_cache, depth, start)
            else:
                depth_np = np.asarray(depth)
                mask_np = np.asarray(mask)
                cache.append(np.round(depth_np * 1000.0).astype(np.uint16))
                for k in range(len(ids)):
                    x, y, p, v = _sample_pixels(
                        depth_np[k], mask_np[k], self.S, self._rng,
                        self.sample_balance)
                    xs.append(x)
                    ys.append(y)
                    ps.append(p)
                    vs.append(v)
            if self.verbose and (start // self.B) % 8 == 0:
                print(f"[forest] rendered {start + len(ids)}"
                      f"/{self.num_images} images")
        if on_device:
            self.samples = Samples(x=torch.cat(xs), y=torch.cat(ys),
                                   part=torch.cat(ps), valid=torch.cat(vs))
        else:
            self._set_depth_cache(np.concatenate(cache, axis=0))
            self.samples = Samples(
                x=self._t(np.stack(xs)), y=self._t(np.stack(ys)),
                part=self._t(np.stack(ps)), valid=self._t(np.stack(vs)))
        if self.mesh is not None:
            self._share_frames(samples=True)
        self._init_node_of()

    def _init_node_of(self) -> None:
        self.node_of = np.zeros((self.num_images, self.S), np.int32)
        self.node_of[~self.samples.valid.cpu().numpy()] = -1

    def _empty_frames(self, samples: bool) -> None:
        """A frame cache (and samples) of the right shapes and places, for
        a rank that receives rank 0's."""
        if self.frame_source is None:
            self._depth_cache = self._new_cache()
        else:
            self._set_depth_cache(np.zeros(
                (self.num_images, self.H, self.W), np.uint16))
        if samples:
            z = lambda dt: torch.zeros((self.num_images, self.S), dtype=dt,
                                       device=self.device)
            self.samples = Samples(x=z(torch.int32), y=z(torch.int32),
                                   part=z(torch.int32), valid=z(torch.bool))

    def _share_frames(self, samples: bool) -> None:
        """Rank 0's frame cache (and samples) on every rank, in place: the
        ranks train on one set of frames, so the host bookkeeping runs the
        same on each from the reduced counts."""
        from avatar_tpu_torch.parallel.training import broadcast_

        for t in (self._depth_cache, *(self.samples if samples else ())):
            broadcast_(self.mesh, t)

    # -- checkpointing (RTREE_V2/V3-style resumable state) ---------------------

    def save_checkpoint(self, path: Optional[str] = None) -> None:
        """Write the resumable state (over a mesh, rank 0 alone writes;
        every rank can resume from the file)."""
        path = path or self.checkpoint_path
        if not path or not self._lead:
            return
        fd = self.tree.to_forest()
        tmp = path + ".partial"
        host = lambda a, dt: a.cpu().numpy().astype(dt)
        np.savez(
            tmp, u=fd.u, v=fd.v, thresh=fd.thresh, lnode=fd.lnode,
            rnode=fd.rnode, leafid=fd.leafid, leaf_data=fd.leaf_data,
            num_parts=fd.num_parts, node_of=self.node_of,
            frontier=np.asarray(self.frontier, np.int32),
            frontier_depth=np.asarray(self.frontier_depth, np.int32),
            level=self.level, seed=self.seed,
            sx=host(self.samples.x, np.int32),
            sy=host(self.samples.y, np.int32),
            spart=host(self.samples.part, np.int32),
            svalid=host(self.samples.valid, bool))
        os.replace(tmp + ".npz", path)
        if self.verbose:
            print(f"[forest] checkpoint saved to {path}")

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as z:
            self.tree = _TreeBuilder(int(z["num_parts"]))
            self.tree.u = [tuple(r) for r in z["u"]]
            self.tree.v = [tuple(r) for r in z["v"]]
            self.tree.thresh = list(z["thresh"])
            self.tree.lnode = list(z["lnode"])
            self.tree.rnode = list(z["rnode"])
            self.tree.leafid = list(z["leafid"])
            self.tree.leaf_data = list(z["leaf_data"])
            self.node_of = z["node_of"]
            self.frontier = list(z["frontier"])
            self.frontier_depth = list(z["frontier_depth"])
            self.level = int(z["level"])
            self.samples = Samples(
                x=self._t(z["sx"], torch.int32),
                y=self._t(z["sy"], torch.int32),
                part=self._t(z["spart"], torch.int32),
                valid=self._t(z["svalid"], torch.bool))
        # the depth cache is regenerated from the image ids (xorKey-style
        # resume)
        self._depth_cache = None

    # -- main loop --------------------------------------------------------------

    def train(self, resume_from: str = "") -> formats.ForestData:
        if resume_from and os.path.exists(resume_from):
            self.load_checkpoint(resume_from)
            self._rebuild_depth_cache()
        else:
            t0 = time.perf_counter()
            self._init_samples()
            self._sync()
            self.init_seconds = time.perf_counter() - t0
            self.tree = _TreeBuilder(self.num_parts)
            root = self.tree.add_node()
            self.frontier = [root]
            self.frontier_depth = [self.max_depth]
            self.level = 0

        # over a mesh, rank 0 handles SIGINT and the others ignore it
        old_handler = signal.signal(
            signal.SIGINT, self._sigint if self._lead else signal.SIG_IGN)
        try:
            while self.frontier:
                self._train_level()
                self.level += 1
                self.save_checkpoint()
                if self._stop_requested():
                    break
        finally:
            signal.signal(signal.SIGINT, old_handler)
        return self.tree.to_forest()

    def _sigint(self, signum, frame):
        # cooperative panic-save (reference RTree.cpp:2950-2957)
        print("[forest] SIGINT: saving checkpoint after this level...")
        self._panic = True

    def _stop_requested(self) -> bool:
        """The SIGINT flag; over a mesh, rank 0's, so that every rank stops
        after the same level."""
        if self.mesh is None:
            return self._panic
        from avatar_tpu_torch.parallel.training import broadcast_

        flag = torch.tensor([int(self._panic)], dtype=torch.int32,
                            device=self.mesh.device)
        return bool(broadcast_(self.mesh, flag).item())

    def _set_depth_cache(self, cache_np: np.ndarray) -> None:
        """Put a host-made uint16-mm frame cache on the device when it
        fits in half of the card's free memory, else keep it on the host
        and upload each image batch as it is scanned (batch-major passes
        only).  Every level scans the same frames many times, so the
        device is where the cache belongs (the reference keeps all frames
        in RAM as SparseImages, RTree.cpp:2941)."""
        bits = torch.from_numpy(np.ascontiguousarray(cache_np).view(np.int16))
        if self.device.type == "cuda" and cache_np.nbytes > \
                torch.cuda.mem_get_info(self.device)[0] // 2:
            self._depth_cache = bits
        else:
            self._depth_cache = bits.to(self.device)

    def _rebuild_depth_cache(self):
        if not self._lead:
            self._empty_frames(samples=False)
            self._share_frames(samples=False)
            return
        on_device = self.frame_source is None
        caches = []
        if on_device:
            self._depth_cache = self._new_cache()
        for start, ids in self._batches():
            depth, _ = self._render_batch(ids)
            if on_device:
                _cache_write(self._depth_cache, depth, start)
            else:
                caches.append(np.round(np.asarray(depth) * 1000.0)
                              .astype(np.uint16))
            if self.verbose and (start // self.B) % 8 == 0:
                print(f"[forest] re-rendered {start + len(ids)}"
                      f"/{self.num_images} images (resume)")
        if not on_device:
            self._set_depth_cache(np.concatenate(caches, axis=0))
        if self.mesh is not None:
            self._share_frames(samples=False)

    def _cache_slab(self, sl) -> torch.Tensor:
        """f32-metre view on the device of a slab of cached frames."""
        return _decode_mm(self._depth_cache[sl].to(self.device))

    # -- mesh dispatch: image batches shard over the ranks -------------------
    #
    # With a mesh, every level pass runs on each rank's block of the image
    # batch and the per-rank min/max/counts are all-reduced (MIN, MAX,
    # SUM): the reduction TrainerV2 does with a mutex (RTree.cpp:1700-1704).
    # The counts are whole numbers in float32, so their sum is exact and
    # the tree equals the one-device tree.

    def _pad_b(self, a: torch.Tensor, fill=0) -> torch.Tensor:
        """Pad a batch-leading tensor (a short last batch) to a multiple of
        the mesh size; the padded rows are not valid samples."""
        n = a.shape[0]
        pad = -n % self.mesh.size
        if pad == 0:
            return a
        return torch.cat([a, a.new_full((pad, *a.shape[1:]), fill)])

    def _p_minmax(self, slab, sx, sy, valid, nl, fu, fv, NC: int):
        if self.mesh is None:
            return pass_minmax(slab, sx, sy, valid, nl, fu, fv, NC)
        from avatar_tpu_torch.parallel import training as ptrain

        return ptrain.sharded_pass_minmax(
            self.mesh, self._pad_b(slab), self._pad_b(sx), self._pad_b(sy),
            self._pad_b(valid), self._pad_b(nl, -1), fu, fv, NC,
            axis=self.mesh.axis)

    def _p_counts(self, slab, sx, sy, part, valid, nl, fu, fv, smin, smax,
                  NC: int, T: int, P: int):
        if self.mesh is None:
            return pass_counts(slab, sx, sy, part, valid, nl, fu, fv,
                               smin, smax, NC, T, P)
        from avatar_tpu_torch.parallel import training as ptrain

        return ptrain.sharded_pass_counts(
            self.mesh, self._pad_b(slab), self._pad_b(sx), self._pad_b(sy),
            self._pad_b(part), self._pad_b(valid), self._pad_b(nl, -1),
            fu, fv, smin, smax, NC, T, P, axis=self.mesh.axis)

    def _p_assign(self, slab, sx, sy, valid, node, bu, bv, bt, bl, br,
                  isp):
        if self.mesh is None:
            return pass_assign(slab, sx, sy, valid, node, bu, bv, bt, bl,
                               br, isp)
        from avatar_tpu_torch.parallel import training as ptrain

        out = ptrain.sharded_pass_assign(
            self.mesh, self._pad_b(slab), self._pad_b(sx), self._pad_b(sy),
            self._pad_b(valid), self._pad_b(node), bu, bv, bt, bl, br, isp,
            axis=self.mesh.axis)
        return out[:slab.shape[0]]

    def _train_level(self):
        frontier = self.frontier
        depths = self.frontier_depth
        t0 = time.perf_counter()
        live = int((self.node_of >= 0).sum())
        self._probe_evals = self._frontier_samples = 0
        if self.verbose:
            print(f"[forest] level {self.level}: {len(frontier)} nodes, "
                  f"{live} live samples")
        new_frontier = []
        new_depths = []
        process = (self._process_chunk_flat if self.pass_mode == "flat"
                   else self._process_chunk)
        for c0 in range(0, len(frontier), self.node_chunk):
            chunk = frontier[c0:c0 + self.node_chunk]
            chunk_depths = depths[c0:c0 + self.node_chunk]
            process(chunk, chunk_depths, new_frontier, new_depths)
        self.frontier = new_frontier
        self.frontier_depth = new_depths
        self._sync()
        wall = time.perf_counter() - t0
        self.level_stats.append(dict(
            level=self.level, nodes=len(frontier),
            frontier_samples=self._frontier_samples,
            probe_evals=self._probe_evals, wall_s=wall))
        if self.verbose:
            print(f"[forest] level {self.level} took {wall:.2f}s")

    def _node_local(self, chunk) -> np.ndarray:
        """Slot of each sample's node in the chunk, -1 outside it (one
        gather through a global-id -> slot map)."""
        gmap = np.full(len(self.tree.thresh) + 1, -1, np.int32)
        gmap[np.asarray(chunk, np.int32)] = np.arange(len(chunk),
                                                      dtype=np.int32)
        node_local = gmap[np.maximum(self.node_of, 0)]
        node_local[self.node_of < 0] = -1
        self._frontier_samples += int((node_local >= 0).sum())
        return node_local

    def _feature_pool(self, chunk):
        """The chunk's random feature pool (V3 samples per node; a pool
        shared by the chunk is the tensor-friendly equivalent).  Keyed on
        (seed, level, chunk) rather than drawn from a stateful generator,
        so a resumed run proposes the same features as an uninterrupted
        one (the reference's xorKey-seeded resume is deterministic the
        same way, RTree.cpp:2649-2702)."""
        frng = np.random.default_rng(
            (self.seed, self.level, int(chunk[0])))
        fu = frng.uniform(-self.max_probe, self.max_probe,
                          (self.F, 2)).astype(np.float32)
        fv = frng.uniform(-self.max_probe, self.max_probe,
                          (self.F, 2)).astype(np.float32)
        return fu, fv

    def _filter_features(self, node_local_np, fu_pool, fv_pool,
                         NC: int) -> np.ndarray:
        """Sparse scoring pass: approximate info gain of every pool feature
        on a subsample of image batches, returning the per-node indices of
        the top F_filtered features (TrainerV2's filter,
        RTree.cpp:1455-1550).

        Memory is bounded by scoring the pool in feature blocks of self.Fb
        with self.T_sparse histogram buckets.
        """
        F = fu_pool.shape[0]
        gains_pool = np.zeros((NC, F), np.float32)
        slabs = [slice(start, start + len(ids))
                 for start, ids in self._batches()][::self.filter_subsample]
        node_local = self._t(node_local_np)
        for fb in range(0, F, self.Fb):
            fu_b = self._t(fu_pool[fb:fb + self.Fb])
            fv_b = self._t(fv_pool[fb:fb + self.Fb])
            Fb = fu_b.shape[0]
            _, _, counts = self._batch_histogram(
                slabs, node_local, fu_b, fv_b, NC, self.T_sparse)
            g, _ = split_gains(counts)                          # [NC,Fb,Ts-1]
            gains_pool[:, fb:fb + Fb] = g.max(dim=2).values.cpu().numpy()
        # top F_filtered per node by sparse gain
        return np.argsort(-gains_pool, axis=1)[:, :self.F_filtered]

    def _batch_histogram(self, slabs, node_local, fu, fv, NC: int, T: int):
        """Score min/max, then counts [NC,F,T,P], accumulated over the
        image batches ``slabs`` on the device."""
        F = fu.shape[-2]
        s = self.samples
        smin = torch.full((NC, F), _BIG, device=self.device)
        smax = torch.full((NC, F), -_BIG, device=self.device)
        for sl in slabs:
            mn, mx = self._p_minmax(self._cache_slab(sl), s.x[sl], s.y[sl],
                                    s.valid[sl], node_local[sl], fu, fv, NC)
            smin = torch.minimum(smin, mn)
            smax = torch.maximum(smax, mx)
        counts = torch.zeros((NC, F, T, self.num_parts), device=self.device)
        for sl in slabs:
            counts = counts + self._p_counts(
                self._cache_slab(sl), s.x[sl], s.y[sl], s.part[sl],
                s.valid[sl], node_local[sl], fu, fv, smin, smax, NC, T,
                self.num_parts)
        self._probe_evals += 2 * F * sum(
            (sl.stop - sl.start) * self.S for sl in slabs)
        return smin, smax, counts

    def _process_chunk(self, chunk, chunk_depths, new_frontier, new_depths):
        NC = len(chunk)
        node_local_np = self._node_local(chunk)
        fu_pool, fv_pool = self._feature_pool(chunk)
        if self.F_filtered:
            top = self._filter_features(node_local_np, fu_pool, fv_pool, NC)
            fu = fu_pool[top]                            # [NC, Ff, 2]
            fv = fv_pool[top]
        else:
            fu, fv = fu_pool, fv_pool
        slabs = [slice(start, start + len(ids))
                 for start, ids in self._batches()]
        smin, smax, counts = self._batch_histogram(
            slabs, self._t(node_local_np), self._t(fu), self._t(fv), NC,
            self.T)
        split = self._decide_splits(chunk, chunk_depths, counts, smin, smax,
                                    fu, fv, new_frontier, new_depths)
        if split is None:
            return
        split_t = [self._t(a) for a in split]

        # reassignment pass
        s = self.samples
        for sl in slabs:
            node = self._t(np.maximum(self.node_of[sl], 0))
            new_node = self._p_assign(self._cache_slab(sl), s.x[sl],
                                      s.y[sl], s.valid[sl], node, *split_t)
            upd = new_node.cpu().numpy()
            live = self.node_of[sl] >= 0
            block = self.node_of[sl]
            block[live] = upd[live]
        self._probe_evals += self.num_images * self.S

    # -- sample-major (flat) chunk processing -------------------------------

    def _flat_blocks(self, sel, nl, pos, blk: int):
        """Device blocks of at most ``blk`` of the chunk's selected
        samples: (pos, x, y, part, node_local, slice into sel)."""
        s = self.samples
        sxf, syf, spf = (s.x.reshape(-1), s.y.reshape(-1),
                         s.part.reshape(-1))
        out = []
        for b0 in range(0, len(sel), blk):
            sl = slice(b0, min(b0 + blk, len(sel)))
            sidx = self._t(sel[sl])
            out.append((self._t(pos[sl]), sxf[sidx], syf[sidx], spf[sidx],
                        self._t(nl[sl]), sl))
        return out

    def _flat_histogram(self, cache_flat, blocks, fu, fv, NC: int, T: int):
        """Score min/max, then counts [NC,F,T,P], accumulated over the
        sample blocks on the device."""
        F = fu.shape[-2]
        smin = torch.full((NC, F), _BIG, device=self.device)
        smax = torch.full((NC, F), -_BIG, device=self.device)
        for pos_b, sx_b, sy_b, _, nl_b, _ in blocks:
            mn, mx = pass_minmax_flat(cache_flat, pos_b, sx_b, sy_b, nl_b,
                                      fu, fv, self.H, self.W, NC)
            smin = torch.minimum(smin, mn)
            smax = torch.maximum(smax, mx)
        counts = torch.zeros((NC, F, T, self.num_parts), device=self.device)
        for pos_b, sx_b, sy_b, part_b, nl_b, _ in blocks:
            counts = counts + pass_counts_flat(
                cache_flat, pos_b, sx_b, sy_b, part_b, nl_b, fu, fv,
                smin, smax, self.H, self.W, NC, T, self.num_parts)
        self._probe_evals += 2 * F * sum(b[0].shape[0] for b in blocks)
        return smin, smax, counts

    def _filter_features_flat(self, cache_flat, blocks, NC: int):
        """TrainerV2 filter stage over the flat sample blocks (sparse
        score pass at 1/filter_subsample of the selected samples)."""
        F = self._fu_pool.shape[0]
        Ts, P = self.T_sparse, self.num_parts
        # cap the feature block so the sparse count tensor stays < ~0.5 GB
        Fb_cap = max(32, min(self.Fb, (1 << 27) // max(1, NC * Ts * P)))
        gains_pool = np.zeros((NC, F), np.float32)
        for fb in range(0, F, Fb_cap):
            fu_b = self._t(self._fu_pool[fb:fb + Fb_cap])
            fv_b = self._t(self._fv_pool[fb:fb + Fb_cap])
            _, _, counts = self._flat_histogram(cache_flat, blocks, fu_b,
                                                fv_b, NC, Ts)
            g, _ = split_gains(counts)
            gains_pool[:, fb:fb + fu_b.shape[0]] = \
                g.max(dim=2).values.cpu().numpy()
        return np.argsort(-gains_pool, axis=1)[:, :self.F_filtered]

    def _process_chunk_flat(self, chunk, chunk_depths, new_frontier,
                            new_depths):
        if self._depth_cache.device.type != self.device.type:
            # host-resident cache: no device tensor to flatten
            return self._process_chunk(chunk, chunk_depths, new_frontier,
                                       new_depths)
        NC = len(chunk)
        nl_flat = self._node_local(chunk).ravel()
        sel = np.nonzero(nl_flat >= 0)[0]
        nl = nl_flat[sel]
        pos = (sel // self.S) * (self.H * self.W)               # int64
        cache_flat = self._depth_cache.reshape(-1)

        # the same keyed feature pools as the batch path
        self._fu_pool, self._fv_pool = self._feature_pool(chunk)
        if self.F_filtered:
            sub = self.filter_subsample
            fblocks = self._flat_blocks(sel[::sub], nl[::sub], pos[::sub],
                                        self._blk_filter)
            top = self._filter_features_flat(cache_flat, fblocks, NC)
            del fblocks
            fu = self._fu_pool[top]                       # [NC, Ff, 2]
            fv = self._fv_pool[top]
        else:
            fu, fv = self._fu_pool, self._fv_pool

        blocks = self._flat_blocks(sel, nl, pos, self._blk_dense)
        smin, smax, counts = self._flat_histogram(
            cache_flat, blocks, self._t(fu), self._t(fv), NC, self.T)
        split = self._decide_splits(chunk, chunk_depths, counts, smin, smax,
                                    fu, fv, new_frontier, new_depths)
        if split is None:
            return
        split_t = [self._t(a) for a in split]
        node_sel = self.node_of.ravel()[sel]
        out = np.empty(len(sel), np.int32)
        for pos_b, sx_b, sy_b, _, _, sl in blocks:
            child = pass_assign_flat(cache_flat, pos_b, sx_b, sy_b,
                                     self._t(node_sel[sl]), *split_t,
                                     self.H, self.W)
            out[sl] = child.cpu().numpy()
        self.node_of.reshape(-1)[sel] = out
        self._probe_evals += len(sel)

    def _decide_splits(self, chunk, chunk_depths, counts, smin, smax,
                       fu, fv, new_frontier, new_depths):
        """Pick per-node best splits (argmax on the device, [NC]-sized
        downloads) and update the host-side tree; returns the split arrays
        for the reassignment pass or None when every node became a leaf."""
        gain, f_best, thresh_a, rngs, totals, part_hist = (
            a.cpu().numpy() for a in split_decide(counts, smin, smax,
                                                  self.T))

        # arrays indexed by global node id for reassignment
        n_nodes_upper = len(self.tree.thresh) + 2 * len(chunk) + 2
        bu = np.zeros((n_nodes_upper, 2), np.float32)
        bv = np.zeros((n_nodes_upper, 2), np.float32)
        bt = np.zeros(n_nodes_upper, np.float32)
        bl = np.zeros(n_nodes_upper, np.int32)
        br = np.zeros(n_nodes_upper, np.int32)
        is_split = np.zeros(n_nodes_upper, bool)

        for i, gid in enumerate(chunk):
            depth_left = chunk_depths[i]
            # leaf criteria (RTree.cpp:2506-2521 + zero-gain rule)
            if (depth_left <= 1 or totals[i] <= self.min_samples or
                    gain[i] <= 1e-6 or rngs[i] < 1e-9):
                self.tree.make_leaf(gid, part_hist[i].astype(np.float64))
                continue
            fu_i = fu[i, f_best[i]] if fu.ndim == 3 else fu[f_best[i]]
            fv_i = fv[i, f_best[i]] if fv.ndim == 3 else fv[f_best[i]]
            l, r = self.tree.make_split(gid, fu_i, fv_i, thresh_a[i])
            bu[gid] = fu_i
            bv[gid] = fv_i
            bt[gid] = thresh_a[i]
            bl[gid] = l
            br[gid] = r
            is_split[gid] = True
            new_frontier.extend([l, r])
            new_depths.extend([depth_left - 1, depth_left - 1])

        if not is_split.any():
            return None
        return bu, bv, bt, bl, br, is_split


# ---------------------------------------------------------------------------
# RTree-facing entry points (reference trainFromAvatar / trainTransfer / train)
# ---------------------------------------------------------------------------


def train_from_avatar(rtree, avatar_model, pose_seq, intrin, image_size,
                      num_threads: int = 0, verbose: bool = False,
                      num_images: int = 500, num_points_per_image: int = 1000,
                      num_features: int = 128, num_features_filtered: int = 0,
                      max_probe_offset: float = 170.0, min_samples: int = 64,
                      max_tree_depth: int = 13,
                      min_samples_per_feature: int = 0,
                      frac_samples_per_feature: float = 0.0,
                      threshes_per_feature: int = 16, part_map=None,
                      max_images_loaded: int = 0, mem_limit_mb: int = 0,
                      train_partial_save_path: str = "",
                      seed: int = 0, devices: int = 0) -> None:
    """Train rtree from synthetic renders (reference RTree.cpp:3292-3330),
    on the avatar model's device.

    num_features_filtered > 0 enables TrainerV2's two-stage feature
    selection (sparse-score the num_features pool, dense-count only the
    per-node top survivors; RTree.cpp:1396-2335).  Thread/memory arguments
    (num_threads, max_images_loaded, mem_limit_mb) are accepted for CLI
    parity and ignored: the frame cache lives on the device.  ``devices``
    > 0 trains over the current process group, which must hold that many
    ranks (``parallel.training.run_world``), or over a world of one when
    it is 1.
    """
    if max_images_loaded or mem_limit_mb:
        import logging

        logging.getLogger(__name__).warning(
            "max_images_loaded/mem_limit_mb are ignored (the frame cache "
            "lives on the device); got %s/%s",
            max_images_loaded, mem_limit_mb)
    # frac_samples_per_feature (V2's sparse-scoring sample fraction,
    # rtree-train.cpp:37-39) maps to the filter stage's subsample rate;
    # min_samples_per_feature's histogram-sizing role is covered by the
    # fixed threshes_per_feature buckets.
    filter_subsample = (max(1, round(1.0 / frac_samples_per_feature))
                        if frac_samples_per_feature > 0 else 4)
    mesh = None
    if devices:
        from avatar_tpu_torch.parallel.training import make_mesh

        mesh = make_mesh(devices, device=getattr(avatar_model, "device",
                                                 None))
    try:
        trainer = ForestTrainer(
            avatar_model, intrin, image_size, rtree.num_parts,
            part_map=part_map, pose_seq=pose_seq, num_images=num_images,
            num_points_per_image=num_points_per_image,
            num_features=num_features, max_probe_offset=max_probe_offset,
            min_samples=min_samples, max_tree_depth=max_tree_depth,
            n_buckets=threshes_per_feature, seed=seed, verbose=verbose,
            checkpoint_path=train_partial_save_path,
            num_features_filtered=num_features_filtered,
            filter_subsample=filter_subsample, mesh=mesh)
        fd = trainer.train(resume_from=train_partial_save_path)
    finally:
        if mesh is not None:
            mesh.close()
    rtree.set_forest(fd)
    rtree.part_map = list(part_map) if part_map is not None else []


def train_transfer(rtree, avatar_model, pose_seq, intrin, image_size,
                   num_threads: int = 0, verbose: bool = False,
                   num_images: int = 100, seed: int = 0) -> None:
    """Re-estimate leaf distributions on freshly rendered frames
    (reference RTree.cpp:3332-3420): run the frozen tree over every
    foreground pixel, histogram (part, leaf) visits, renormalize;
    unvisited leaves keep their old distributions."""
    from avatar_tpu_torch.perception.rtree import forest_walk

    src = synth.make_source(avatar_model, intrin, rtree.part_map, pose_seq,
                            n_images=num_images, seed=seed)
    H, W = image_size
    n_leafs, P = rtree.forest.leaf_data.shape[0], rtree.num_parts
    counts = np.zeros((n_leafs, P), np.float64)
    B = 8
    for start in range(0, num_images, B):
        ids = np.arange(start, min(start + B, num_images))
        depth, mask, _ = synth.render_batch(
            src, avatar_model.parents, ids, seed, H, W,
            avatar_model.num_shape_keys())
        for k in range(len(ids)):
            leaf = forest_walk(rtree._tree, depth[k], rtree._max_depth, 1,
                               (0, 0), (W - 1, H - 1))
            fg = (mask[k] != 255) & (leaf >= 0)
            # whole-number counts per frame, summed in float64 on the host
            counts += _count(leaf[fg].long() * P + mask[k][fg].long(),
                             n_leafs * P).reshape(n_leafs, P).cpu().numpy()
    new_leaf = rtree.forest.leaf_data.copy()
    visited = counts.sum(1) > 0
    new_leaf[visited] = (counts[visited] /
                         counts[visited].sum(1, keepdims=True))
    if verbose and (~visited).any():
        print(f"[transfer] {int((~visited).sum())} leaves unvisited, "
              "keeping old weights")
    fd = rtree.forest
    rtree.set_forest(formats.ForestData(
        fd.u, fd.v, fd.thresh, fd.lnode, fd.rnode, fd.leafid,
        new_leaf.astype(np.float32), fd.num_parts))


def train_from_files(rtree, depth_dir: str, part_mask_dir: str,
                     num_threads: int = 0, verbose: bool = False,
                     num_images: int = 0, num_points_per_image: int = 1000,
                     num_features: int = 128, num_features_filtered: int = 0,
                     max_probe_offset: float = 170.0, min_samples: int = 64,
                     max_tree_depth: int = 13,
                     min_samples_per_feature: int = 0,
                     frac_samples_per_feature: float = 0.0,
                     threshes_per_feature: int = 16,
                     max_images_loaded: int = 0, mem_limit_mb: int = 0,
                     train_partial_save_path: str = "",
                     seed: int = 0) -> None:
    """Train rtree from recorded depth + part-mask frame pairs on disk
    (reference RTree::train with FileDataSource, RTree.cpp:3264-3290), on
    the rtree's device.

    Both directories are listed and sorted; frame i pairs depth_paths[i]
    with mask_paths[i].  The frames are read once into the dense frame
    cache (max_images_loaded, the reference's LRU size, is ignored).
    """
    src = FileFrameSource(depth_dir, part_mask_dir)
    image_size = src.image_size()
    trainer = ForestTrainer(
        None, None, image_size, rtree.num_parts,
        num_images=num_images or src.size(),
        num_points_per_image=num_points_per_image,
        num_features=num_features, max_probe_offset=max_probe_offset,
        min_samples=min_samples, max_tree_depth=max_tree_depth,
        n_buckets=threshes_per_feature, seed=seed, verbose=verbose,
        checkpoint_path=train_partial_save_path, frame_source=src,
        num_features_filtered=num_features_filtered, device=rtree.device)
    fd = trainer.train(resume_from=train_partial_save_path)
    rtree.set_forest(fd)
