"""Part-constrained nearest-neighbour correspondence (frozen copy of the port's ``optim/correspond.py``).

Every data point matches the nearest visible model vertex with the same
body-part label (the reference's findNN "invert" mode,
AvatarOptimizer.cpp:830-968).  Two entry points, as in the reference:

* ``find_nn_stats_planned``: both clouds sorted by part so each 256-row
  data tile scans only the model chunks covering its own labels
  (``nn_kernel.nn_argmin_ranges``, B1).  ``fit`` and ``fit_refine`` take it
  whenever the data rows are a multiple of 256.
* ``find_nn_stats``: the unplanned search over the whole model axis
  (``nn_kernel.nn_argmin``, B2), the reference's Pallas branch for any N:
  the data rows are padded to a multiple of 256 here instead of falling
  back to the reference's norm-expansion XLA scan, so the distances are
  direct differences on the CPU and on the card alike.

Both hand the whole search to ``nn_kernel.nn_match``: on the card one host
call that recentres, permutes and pads the clouds, scans, and applies the
match rules; on the CPU its plain version.  What stays here is the model's
mean and the per-vertex statistics.

The reference's TPU gating (``_pallas_enabled``) is not carried over.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import nn_plain as nn_kernel


class CorrStats(NamedTuple):
    cnt: torch.Tensor        # [P] f32 match counts per model point
    s: torch.Tensor          # [P, 3] sum of matched data points
    q: torch.Tensor          # scalar: sum |d - centroid|^2 over matches
    n_matched: torch.Tensor  # scalar: number of matched data points
    corr: torch.Tensor       # [N] int32 model index per data point (-1 none)


class NNPlan(NamedTuple):
    """Loop-invariant part-sorting plan (built once per fit)."""
    dpts: torch.Tensor       # [N, 3] data sorted by part (padding first)
    dpart: torch.Tensor      # [N] sorted labels (< 0 = padding)
    mperm: Optional[torch.Tensor]  # [Pp] model index per sorted slot; None
    #                          when the model axis is already part-sorted
    mpart_s: torch.Tensor    # [Pp] sorted model part (pad slots = 2^30)
    cstart: torch.Tensor     # [N // tile_n] first model chunk per data tile
    cend: torch.Tensor       # [N // tile_n] one-past-last chunk per tile
    tile_n: int
    chunk: int
    match: Optional[nn_kernel.MatchArgs] = None  # the plan as ``nn_match``
    #                          takes it, checked once (``make_nn_plan``)


def make_nn_plan(data_pts: torch.Tensor, data_part: torch.Tensor,
                 model_part: torch.Tensor, num_parts: int,
                 tile_n: int = 256, chunk: int = 512,
                 model_sorted: bool = False) -> NNPlan:
    """Build the part-sorting plan.  Sorts are stable, as ``jnp.argsort``
    is, so equal labels keep their order."""
    N = data_pts.shape[0]
    P = model_part.shape[0]
    dev = data_pts.device
    if N % tile_n:
        raise ValueError(f"N={N} is not a multiple of tile_n={tile_n}")

    order = torch.argsort(data_part, stable=True)
    dpts = data_pts[order]
    dpart = data_part[order]

    if model_sorted:
        mperm = None
        mpart_s = model_part.to(torch.int32)
    else:
        mperm = torch.argsort(model_part, stable=True).to(torch.int32)
        mpart_s = model_part[mperm.long()].to(torch.int32)
    pad = (-P) % chunk
    if pad:
        # pad slots point at vertex 0 but carry an unmatchable part label
        if mperm is not None:
            mperm = torch.cat([mperm, torch.zeros(pad, dtype=torch.int32,
                                                  device=dev)])
        mpart_s = torch.cat([mpart_s, torch.full(
            (pad,), 2 ** 30, dtype=torch.int32, device=dev)])

    # model part -> [start, end) offsets in the sorted axis
    off = torch.searchsorted(
        mpart_s[:P].contiguous(),
        torch.arange(num_parts + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    T = N // tile_n
    dps = dpart.reshape(T, tile_n)
    p_lo = torch.clamp(dps[:, 0], 0, num_parts - 1).long()
    p_hi = dps[:, -1]
    p_hic = torch.clamp(p_hi, 0, num_parts - 1).long()
    empty = p_hi < 0                      # tile is all padding
    has_wild = p_hi >= num_parts          # wildcards scan every real chunk
    n_real_chunks = (P + chunk - 1) // chunk
    zero = torch.zeros_like(p_hi)
    cstart = torch.where(empty, zero, torch.where(
        has_wild, zero, off[p_lo] // chunk)).to(torch.int32)
    cend = torch.where(empty, zero, torch.where(
        has_wild, torch.full_like(p_hi, n_real_chunks),
        (off[p_hic + 1] + chunk - 1) // chunk)).to(torch.int32)
    dpts, dpart, mpart_s = (dpts.contiguous(), dpart.contiguous(),
                            mpart_s.contiguous())
    if mperm is not None:
        mperm = mperm.contiguous()
    match = nn_kernel.prepare_match(
        "nn_argmin_ranges", dpts, dpart, N, mperm, mpart_s, P,
        mpart_s.shape[0], cstart, cend, tile_n, chunk)
    return NNPlan(dpts=dpts, dpart=dpart, mperm=mperm, mpart_s=mpart_s,
                  cstart=cstart, cend=cend, tile_n=tile_n, chunk=chunk,
                  match=match)


_zero_stats = {}     # (P, dtype, device) -> (cnt, s, q), all zero


def _no_stats(P: int, dtype, dev):
    """The statistics of a search that was not asked for them: zeros, made
    once per size and shared (read-only) by every such result."""
    key = (P, dtype, dev)
    if key not in _zero_stats:
        _zero_stats[key] = (torch.zeros(P, dtype=dtype, device=dev),
                            torch.zeros((P, 3), dtype=dtype, device=dev),
                            torch.zeros((), dtype=dtype, device=dev))
    return _zero_stats[key]


def find_nn_stats_planned(plan: NNPlan, model_cloud: torch.Tensor,
                          visible: torch.Tensor, with_stats: bool = False,
                          wild: int = -1000,
                          wild_gate2=None) -> CorrStats:
    """NN over a prebuilt plan.  ``corr`` is aligned with the plan's
    sorted data order and indexes the ORIGINAL model axis; the statistics
    (only with ``with_stats``) are in original model indexing.

    ``wild``: data label matching any model part; ``wild_gate2``: squared
    distance cap for wildcard matches.
    """
    P = model_cloud.shape[0]
    dtype = model_cloud.dtype
    dev = model_cloud.device
    center = torch.mean(model_cloud, dim=0)
    _, corr, wgt, n_matched = nn_kernel.nn_match(
        plan.match, model_cloud, center, visible, wild, wild_gate2)
    if with_stats:
        idx = torch.where(corr >= 0, corr, P).long()
        cnt = torch.zeros(P + 1, dtype=dtype, device=dev).index_add_(
            0, idx, wgt)[:P]
        s = torch.zeros((P + 1, 3), dtype=dtype, device=dev).index_add_(
            0, idx, plan.dpts * wgt[:, None])[:P]
        dpts_c = plan.dpts - center
        q = torch.sum(torch.sum(dpts_c * dpts_c, dim=-1) * wgt)
    else:
        cnt, s, q = _no_stats(P, dtype, dev)
    return CorrStats(cnt=cnt, s=s, q=q, n_matched=n_matched, corr=corr)


def backface_visibility(cloud: torch.Tensor, faces: torch.Tensor
                        ) -> torch.Tensor:
    """[P] bool: the vertex belongs to at least one front-facing triangle,
    front-facing iff ((p2 - p1) x (p1 - p3)).z > 1e-4 (reference
    AvatarOptimizer.cpp:1349-1387)."""
    f = faces.long()
    p1, p2, p3 = cloud[f[:, 0]], cloud[f[:, 1]], cloud[f[:, 2]]
    a = p2 - p1
    b = p1 - p3
    front = (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]) > 1e-4
    hits = torch.zeros(cloud.shape[0], dtype=torch.int32,
                       device=cloud.device).scatter_reduce(
        0, f.T.reshape(-1), front.to(torch.int32).repeat(3), "amax")
    return hits > 0


def unplanned_match(data_pts: torch.Tensor, data_part: torch.Tensor,
                    model_part: torch.Tensor) -> nn_kernel.MatchArgs:
    """The loop-invariant side of ``find_nn_stats`` as ``nn_match`` takes
    it (the reference's Pallas branch): the data rows padded to a multiple
    of 256 with label -1, the model axis to a multiple of 1024 with
    invisible slots of part -2, scanned whole in chunks of 1024."""
    N, P = data_pts.shape[0], model_part.shape[0]
    return nn_kernel.prepare_match(
        "nn_argmin", data_pts.contiguous(),
        data_part.to(torch.int32).contiguous(), N + (-N) % 256, None,
        model_part.to(torch.int32).contiguous(), P, P + (-P) % 1024, None,
        None, 256, 1024)


def find_nn_stats(data_pts: torch.Tensor, data_part: torch.Tensor,
                  model_cloud: torch.Tensor, model_part: torch.Tensor,
                  visible: torch.Tensor, wild: int = -1000,
                  wild_gate2=None, match=None) -> CorrStats:
    """Match every valid data point to its nearest visible same-part model
    vertex over the whole model axis; reduce to per-vertex statistics.

    data_pts [N, 3] (padding rows arbitrary), data_part [N] int32 (< 0 =
    padding), model_cloud [P, 3], model_part [P] int32, visible [P] bool.
    The kernel scans 1024-slot chunks, as the reference's Pallas branch
    does.  ``corr`` is in data order.  ``s`` sums the uncentred points, ``q`` the
    squared norms of the points recentred on the model mean.  ``match``:
    ``unplanned_match`` of the same data and model parts, when the caller
    searches more than once.
    """
    P = model_cloud.shape[0]
    dtype, dev = data_pts.dtype, data_pts.device
    if match is None:
        match = unplanned_match(data_pts, data_part, model_part)
    center = torch.mean(model_cloud, dim=0)
    _, corr, wgt, n_matched = nn_kernel.nn_match(
        match, model_cloud, center, visible, wild, wild_gate2)
    idx = torch.where(corr >= 0, corr, P).long()     # padding bucket
    cnt = torch.zeros(P + 1, dtype=dtype, device=dev).index_add_(
        0, idx, wgt)[:P]
    s = torch.zeros((P + 1, 3), dtype=dtype, device=dev).index_add_(
        0, idx, data_pts * wgt[:, None])[:P]
    data_c = data_pts - center
    q = torch.sum(torch.sum(data_c * data_c, dim=-1) * wgt)
    return CorrStats(cnt=cnt, s=s, q=q, n_matched=n_matched, corr=corr)


def matcher(data_pts: torch.Tensor, data_part: torch.Tensor,
            model_part: torch.Tensor, num_parts: int, chunk: int = 512,
            model_sorted: bool = False):
    """The NN of one fit, chosen once from N: the planned NN (B1) over a
    plan built here at N % 256 == 0, else the unplanned one of
    ``find_nn_stats`` (B2), the reference's two branches.  Returns the data
    rows as the fit must use them (part-sorted when planned), their
    labels, and the search as ``nn_kernel.nn_match`` takes it, for
    ``search``."""
    if data_pts.shape[0] % 256:
        return data_pts, data_part, unplanned_match(data_pts, data_part,
                                                    model_part)
    plan = make_nn_plan(data_pts, data_part, model_part, num_parts=num_parts,
                        tile_n=256, chunk=chunk, model_sorted=model_sorted)
    return plan.dpts, plan.dpart, plan.match


def search(match: nn_kernel.MatchArgs, model_cloud: torch.Tensor,
           visible: torch.Tensor, wild: int = -1000,
           wild_gate2=None) -> torch.Tensor:
    """``corr`` of one search of ``matcher``'s rows against the model as
    posed: what ``find_nn_stats_planned`` and ``find_nn_stats`` return under
    that name, without the per-vertex statistics."""
    center = torch.mean(model_cloud, dim=0)
    return nn_kernel.nn_match(match, model_cloud, center, visible, wild,
                              wild_gate2)[1]
