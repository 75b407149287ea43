"""The correspondence search of the port's ``optim/nn_kernel.py`` in its
plain PyTorch version only, frozen: the same candidates, the same d2
rounding and the same tie rule as the CUDA kernel, with no kernel.
``nn_match`` is the plain ``nn_match_ref``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_INF = 3.0e38
_BIG_PART = 2 ** 30
_INVALID = -2 ** 31


def _full_range(N: int, Pp: int, tile_n: int, chunk: int, device):
    T = N // tile_n
    return (torch.zeros(T, dtype=torch.int32, device=device),
            torch.full((T,), Pp // chunk, dtype=torch.int32, device=device))


def nn_argmin_ranges_ref(data_pts, data_part, model_pts, model_part,
                         model_valid, cstart, cend, tile_n: int = 256,
                         chunk: int = 512, wild: int = -1000,
                         rows: int = 2048):
    """Plain PyTorch version of the kernel: the same candidates, the same
    d2 rounding ((dx*dx + dy*dy) + dz*dz, one rounding per op) and the same
    tie rule (``torch.argmin`` returns the first index of the minimum)."""
    N, Pp = data_pts.shape[0], model_pts.shape[0]
    dev = data_pts.device
    if cstart is None:
        cstart, cend = _full_range(N, Pp, tile_n, chunk, dev)
    col_chunk = torch.arange(Pp, device=dev) // chunk
    tile = torch.arange(N, device=dev) // tile_n
    lo, hi = cstart.long()[tile], cend.long()[tile]
    key = torch.where(model_valid, model_part.to(torch.int32),
                      torch.full_like(model_part, _INVALID, dtype=torch.int32))
    real = (key != _INVALID)[None]
    mx, my, mz = (model_pts[None, :, k] for k in range(3))
    best_d = torch.empty(N, dtype=torch.float32, device=dev)
    best_i = torch.empty(N, dtype=torch.int32, device=dev)
    for r0 in range(0, N, rows):
        sl = slice(r0, r0 + rows)
        d = data_pts[sl]
        dx = d[:, 0:1] - mx
        dy = d[:, 1:2] - my
        dz = d[:, 2:3] - mz
        d2 = dx * dx + dy * dy + dz * dz
        part = data_part[sl, None]
        ok = real & ((key[None] == part) |
                     ((part == wild) & (key[None] < _BIG_PART)))
        ok &= (col_chunk[None] >= lo[sl, None]) & (col_chunk[None] < hi[sl, None])
        d2 = torch.where(ok, d2, torch.full_like(d2, _INF))
        i = torch.argmin(d2, dim=1)
        md = torch.gather(d2, 1, i[:, None])[:, 0]
        best_d[sl] = md
        best_i[sl] = torch.where(md < _INF, i, -1).to(torch.int32)
    return best_d, best_i


def nn_argmin_ref(data_pts, data_part, model_pts, model_part, model_valid,
                  tile_n: int = 256, chunk: int = 1024, wild: int = -1000):
    """Plain PyTorch version of ``nn_argmin``."""
    return nn_argmin_ranges_ref(data_pts, data_part, model_pts, model_part,
                                model_valid, None, None, tile_n, chunk, wild)


class MatchArgs(NamedTuple):
    """The loop-invariant arguments of ``nn_match``, checked once by
    ``prepare_match``."""
    name: str                # the kernel the search counts as
    dpts: torch.Tensor       # [n_real, 3] f32 data rows (uncentred)
    dpart: torch.Tensor      # [n_real] i32 labels (< 0 = padding)
    n: int                   # rows the kernel scans (n_real padded up)
    mperm: Optional[torch.Tensor]  # [pp] i32 model row per slot, or None
    mpart: torch.Tensor      # i32 part per slot: [pp], or [p] without mperm
    p: int                   # model rows
    pp: int                  # model slots (p padded to the chunk)
    cstart: Optional[torch.Tensor]  # [n // tile_n] i32, None = every chunk
    cend: Optional[torch.Tensor]
    tile_n: int
    chunk: int
    ptrs: tuple              # data_ptr() of the tensors above (CUDA only)


def prepare_match(name: str, dpts, dpart, n: int, mperm, mpart, p: int,
                  pp: int, cstart, cend, tile_n: int, chunk: int
                  ) -> MatchArgs:
    """Check shapes, types, devices and contiguity of a search's
    loop-invariant arguments once, so ``nn_match`` checks only what changes
    from call to call."""
    n_real = dpts.shape[0]
    if not n - tile_n < n_real <= n or not 0 < p <= pp:
        raise ValueError(f"n_real={n_real}, n={n}, p={p}, pp={pp}")
    if (cstart is None) != (cend is None):
        raise ValueError("cstart and cend go together")
    if mperm is None and mpart.shape[0] not in (p, pp):
        raise ValueError(f"mpart has {mpart.shape[0]} entries, want {p} or "
                         f"{pp}")
    ptrs = tuple(None if t is None else t.data_ptr()
                 for t in (dpts, dpart, mperm, mpart, cstart, cend))
    return MatchArgs(name, dpts, dpart, n, mperm, mpart, p, pp, cstart, cend,
                     tile_n, chunk, ptrs)


_MATCH_TENSORS = ("dpts", "dpart", "mperm", "mpart", "cstart", "cend")


def static_match(m: MatchArgs) -> MatchArgs:
    """A search like ``m`` over buffers of its own, to be filled by
    ``load_match``: a CUDA graph that captured a search through it reads
    whatever plan was loaded last."""
    t = {f: None if getattr(m, f) is None else
         torch.empty_like(getattr(m, f), memory_format=torch.contiguous_format)
         for f in _MATCH_TENSORS}
    return prepare_match(m.name, t["dpts"], t["dpart"], m.n, t["mperm"],
                         t["mpart"], m.p, m.pp, t["cstart"], t["cend"],
                         m.tile_n, m.chunk)


def match_key(m: MatchArgs) -> tuple:
    """What a search's buffers and launch depend on, besides the values
    ``load_match`` copies: its kernel, sizes and tensor shapes."""
    return (m.name, m.n, m.p, m.pp, m.tile_n, m.chunk) + tuple(
        None if getattr(m, f) is None else tuple(getattr(m, f).shape)
        for f in _MATCH_TENSORS)


def load_match(dst: MatchArgs, src: MatchArgs) -> None:
    """Copy the tensors of ``src`` into the buffers of ``dst``, a
    ``static_match`` of a search with the same ``match_key``."""
    for f in _MATCH_TENSORS:
        if getattr(src, f) is not None:
            getattr(dst, f).copy_(getattr(src, f))


def match_inputs(m: MatchArgs, model_cloud, center, visible):
    """The arguments of ``nn_argmin_ranges`` that one ``nn_match`` search
    amounts to, built with plain tensor operations: the model recentred,
    then permuted (or padded with invisible slots of part -2), and the
    data rows recentred and padded with label -1."""
    dtype, dev = model_cloud.dtype, model_cloud.device
    xc = model_cloud - center
    mpart = m.mpart
    if m.mperm is None:
        pad = m.pp - m.p
        xs = torch.cat([xc, torch.zeros((pad, 3), dtype=dtype, device=dev)])
        vis_s = torch.cat([visible, torch.zeros(pad, dtype=torch.bool,
                                                device=dev)])
        if mpart.shape[0] != m.pp:
            mpart = torch.cat([mpart, torch.full(
                (pad,), -2, dtype=torch.int32, device=dev)])
    else:
        perm = m.mperm.long()
        xs, vis_s = xc[perm], visible[perm]
    rpad = m.n - m.dpts.shape[0]
    dpts_c = torch.cat([m.dpts - center,
                        torch.zeros((rpad, 3), dtype=dtype, device=dev)])
    dpart = torch.cat([m.dpart, torch.full((rpad,), -1, dtype=torch.int32,
                                           device=dev)])
    return (dpts_c.contiguous(), dpart, xs.contiguous(), mpart,
            vis_s.contiguous(), m.cstart, m.cend)


def nn_match_ref(m: MatchArgs, model_cloud, center, visible,
                 wild: int = -1000, wild_gate2=None, argmin=None):
    """Plain PyTorch version of ``nn_match``: the inputs through
    ``match_inputs``, the argmin (``nn_argmin_ranges_ref`` unless ``argmin``
    is given), then the match rules."""
    argmin = argmin or nn_argmin_ranges_ref
    n_real = m.dpts.shape[0]
    best_d, best_i = argmin(*match_inputs(m, model_cloud, center, visible),
                            tile_n=m.tile_n, chunk=m.chunk, wild=wild)
    best_d, best_i = best_d[:n_real], best_i[:n_real]
    matched = (best_i >= 0) & (m.dpart >= 0)
    if wild_gate2 is not None:
        matched = matched & ((m.dpart != wild) | (best_d <= wild_gate2))
    if m.mperm is None:
        corr = torch.where(matched, best_i, -1)
    else:
        corr = torch.where(matched, m.mperm[best_i.clamp(min=0).long()], -1)
    wgt = matched.to(model_cloud.dtype)
    return best_d, corr.to(torch.int32), wgt, torch.sum(wgt)


nn_match = nn_match_ref
