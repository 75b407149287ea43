"""Part-constrained nearest-neighbour correspondence (counterpart of
``avatar_tpu/optim/correspond.py``).

Every data point matches the nearest visible model vertex with the same
body-part label (the reference's findNN "invert" mode,
AvatarOptimizer.cpp:830-968).  The port always takes the part-sorted
planned path: both clouds sorted by part so each 256-row data tile scans
only the model chunks covering its own labels (``nn_kernel``), on the CPU
and on the card alike.  The reference's TPU gating (``_pallas_enabled``)
and its unplanned norm-expansion path are not carried over.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from avatar_tpu_torch.optim import nn_kernel


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
    return NNPlan(dpts=dpts, dpart=dpart, mperm=mperm, mpart_s=mpart_s,
                  cstart=cstart, cend=cend, tile_n=tile_n, chunk=chunk)


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
    if plan.mperm is None:
        pad = plan.mpart_s.shape[0] - P
        xs = model_cloud - center
        vis_s = visible
        if pad:
            xs = torch.cat([xs, torch.zeros((pad, 3), dtype=dtype,
                                            device=dev)])
            vis_s = torch.cat([vis_s, torch.zeros(pad, dtype=torch.bool,
                                                  device=dev)])
    else:
        perm = plan.mperm.long()
        xs = (model_cloud - center)[perm]
        vis_s = visible[perm]
    dpts_c = plan.dpts - center

    best_d, best_i = nn_kernel.nn_argmin_ranges(
        dpts_c.contiguous(), plan.dpart.contiguous(), xs.contiguous(),
        plan.mpart_s.contiguous(), vis_s.contiguous(), plan.cstart,
        plan.cend, tile_n=plan.tile_n, chunk=plan.chunk, wild=wild)

    matched = (best_i >= 0) & (plan.dpart >= 0)
    if wild_gate2 is not None:
        matched = matched & ((plan.dpart != wild) | (best_d <= wild_gate2))
    if plan.mperm is None:
        corr = torch.where(matched, best_i, -1)
    else:
        corr = torch.where(matched, plan.mperm[best_i.clamp(min=0).long()],
                           -1)
    corr = corr.to(torch.int32)
    wgt = matched.to(dtype)
    if with_stats:
        idx = torch.where(matched, corr, P).long()
        cnt = torch.zeros(P + 1, dtype=dtype, device=dev).index_add_(
            0, idx, wgt)[:P]
        s = torch.zeros((P + 1, 3), dtype=dtype, device=dev).index_add_(
            0, idx, plan.dpts * wgt[:, None])[:P]
        q = torch.sum(torch.sum(dpts_c * dpts_c, dim=-1) * wgt)
    else:
        cnt = torch.zeros(P, dtype=dtype, device=dev)
        s = torch.zeros((P, 3), dtype=dtype, device=dev)
        q = torch.zeros((), dtype=dtype, device=dev)
    return CorrStats(cnt=cnt, s=s, q=q, n_matched=torch.sum(wgt), corr=corr)
