"""Part-constrained masked nearest-neighbour argmin: the hand-written CUDA
kernel (``csrc/nn_argmin.cu``) and its plain PyTorch version.

Counterpart of ``avatar_tpu/optim/nn_pallas.py``: ``nn_argmin_ranges``
replaces ``_kernel_ranges`` (B1, on every LM step of ``fit``) and
``nn_argmin`` replaces ``_kernel`` (B2), the same device code over the whole
model axis.  ``nn_match`` is one whole correspondence search (recentring,
the model's permutation and padding, the argmin, the match rules and the
match count) as one host call into the same device code; ``correspond``'s
two searches go through it.  The kernel is built with nvcc at its first
launch, into ``avatar_tpu_torch/_build/``, as a shared library with plain C
entry points bound through ctypes.

The wrappers take the plain version only for tensors on the CPU.  For CUDA
tensors they launch the kernel or raise; there is no fallback.
``LAUNCHES`` counts searches by kernel name, at the one launch site, so a
run can show that its path went through each kernel.  A search captured
into a CUDA graph (the LM step of ``gauss_newton.fit``) launches nothing
while it is captured: it is counted in the capture's ``captured_launches``
record instead, and each replay of the graph adds that record to
``LAUNCHES`` (``count_replay``).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from avatar_tpu_torch.build_cache import (BUILD, NVCC_FLAGS, build_cached,
                                          cached_path, nvcc)
from avatar_tpu_torch.device import current_stream, want as _want

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "nn_argmin.cu"
_BUILD = BUILD
_ROWS = 64           # data rows per work unit (csrc/nn_argmin.cu kRows)
_MAX_CHUNK = 3072    # csrc/nn_argmin.cu kMaxChunk
_MAX_TILES = 1024    # csrc/nn_argmin.cu kMaxTiles

_INF = 3.0e38
_BIG_PART = 2 ** 30
_INVALID = -2 ** 31

# searches launched since the last reset, by kernel name
LAUNCHES = {"nn_argmin_ranges": 0, "nn_argmin": 0}
_lib = None          # the bound library, once built
_capture = threading.local()   # .counts: the capture being recorded


def library_path() -> Path:
    """Where the built library of the current source and flags goes."""
    return cached_path(_SRC, NVCC_FLAGS, "libnn_argmin", _BUILD)


def build() -> str:
    """Compile (once per source and flags) and bind the kernel.  Returns
    the compiler's output (ptxas register and shared-memory report), or ''
    when the library was already built."""
    global _lib
    if _lib is not None:
        return ""
    lib_path, log = build_cached(
        _SRC, NVCC_FLAGS, "libnn_argmin",
        lambda out: [nvcc(), *NVCC_FLAGS, "-o", str(out), str(_SRC)],
        _BUILD)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.avatar_nn_scratch_bytes.argtypes = [i32, i32]
    lib.avatar_nn_scratch_bytes.restype = ctypes.c_longlong
    lib.avatar_nn_argmin_ranges.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.avatar_nn_argmin_ranges.restype = i32
    lib.avatar_nn_match.argtypes = (
        [ptr] * 2 + [i32] * 2 + [ptr] * 5 + [i32] * 3 + [ptr] * 2 +
        [i32] * 4 + [ctypes.c_float] + [ptr] * 7)
    lib.avatar_nn_match.restype = i32
    _lib = lib
    return log


@contextlib.contextmanager
def captured_launches():
    """Record, by kernel name, the searches captured into a CUDA graph
    inside the block (none of them launches while it is captured).  Yields
    the record; ``count_replay(record)`` after each replay of the graph
    counts what the replay launched."""
    if getattr(_capture, "counts", None) is not None:
        raise RuntimeError("captures do not nest")
    _capture.counts = counts = dict.fromkeys(LAUNCHES, 0)
    try:
        yield counts
    finally:
        _capture.counts = None


def count_replay(counts: dict) -> None:
    """Add the searches of one replay of a captured graph to
    ``LAUNCHES``."""
    for name, k in counts.items():
        LAUNCHES[name] += k


_scratch = {}        # (device index, stream) -> uint8 scratch tensor
_scratch_bytes = {}  # (n, pp) -> bytes one launch needs


def _launch(name: str, entry: str, dev: torch.device, n: int, pp: int,
            head: tuple, tail: tuple) -> None:
    """The one launch site: the C call ``entry(*head, scratch, *tail,
    stream)`` on the current stream of the tensors' device, its error
    raised, the search counted under ``name``.  The scratch (packed model,
    merge keys, tickets) is kept per device and stream: launches of one
    stream run in order, and every launch resets what it uses.  Under
    graph capture the scratch is a temporary of the capture instead (from
    the graph's pool, as every intermediate of the captured step), so no
    graph holds the address of a scratch that eager work may replace, and
    the search is counted in the capture's record."""
    build()
    capturing = torch.cuda.is_current_stream_capturing()
    counts = getattr(_capture, "counts", None)
    if capturing and counts is None:
        raise RuntimeError("a search captured outside captured_launches(): "
                           "its replays would not be counted")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    stream = current_stream(index)
    need = _scratch_bytes.get((n, pp))
    if need is None:
        need = _scratch_bytes[(n, pp)] = _lib.avatar_nn_scratch_bytes(n, pp)
    if capturing:
        scratch = torch.empty(need, dtype=torch.uint8, device=dev)
    else:
        scratch = _scratch.get((index, stream))
        if scratch is None or scratch.numel() < need:
            scratch = _scratch[(index, stream)] = torch.empty(
                need, dtype=torch.uint8, device=dev)
    fn = getattr(_lib, entry)
    if index == torch.cuda.current_device():
        rc = fn(*head, scratch.data_ptr(), *tail, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*head, scratch.data_ptr(), *tail, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    if capturing:
        counts[name] += 1
    else:
        LAUNCHES[name] += 1


def _check_sizes(N: int, Pp: int, tile_n: int, chunk: int, wild: int) -> None:
    if N <= 0 or N % tile_n or tile_n % _ROWS or N // tile_n > _MAX_TILES:
        raise ValueError(f"N={N} must be a positive multiple of tile_n="
                         f"{tile_n}, itself a multiple of {_ROWS}, in at "
                         f"most {_MAX_TILES} tiles")
    if not 0 < chunk <= _MAX_CHUNK or Pp <= 0 or Pp % chunk:
        raise ValueError(f"Pp={Pp} must be a positive multiple of chunk="
                         f"{chunk} (at most {_MAX_CHUNK})")
    if wild >= _BIG_PART:
        raise ValueError(f"wild={wild} must be below 2^30")


def nn_argmin_ranges(data_pts, data_part, model_pts, model_part, model_valid,
                     cstart, cend, tile_n: int = 256, chunk: int = 512,
                     wild: int = -1000, _name: str = "nn_argmin_ranges"):
    """Part-sorted masked NN: (best_d [N] f32, best_i [N] i32).

    data_pts [N,3] f32 / data_part [N] i32 sorted by part (< 0 = padding),
    model_pts [Pp,3] / model_part [Pp] i32 sorted by part (pad slots
    2^30), model_valid [Pp] bool; cstart/cend [N/tile_n] i32 give the model
    chunk range of each data tile (both None: every chunk).  Rows labelled
    ``wild`` match any real part.
    """
    if data_pts.device.type == "cpu":
        return nn_argmin_ranges_ref(data_pts, data_part, model_pts,
                                    model_part, model_valid, cstart, cend,
                                    tile_n, chunk, wild)
    if data_pts.device.type != "cuda":
        raise ValueError(f"no kernel for device {data_pts.device}")
    dev = data_pts.device
    N, Pp = data_pts.shape[0], model_pts.shape[0]
    _check_sizes(N, Pp, tile_n, chunk, wild)
    _want("data_pts", data_pts, dev, torch.float32, (N, 3))
    _want("data_part", data_part, dev, torch.int32, (N,))
    _want("model_pts", model_pts, dev, torch.float32, (Pp, 3))
    _want("model_part", model_part, dev, torch.int32, (Pp,))
    _want("model_valid", model_valid, dev, torch.bool, (Pp,))
    if (cstart is None) != (cend is None):
        raise ValueError("cstart and cend go together")
    if cstart is not None:
        _want("cstart", cstart, dev, torch.int32, (N // tile_n,))
        _want("cend", cend, dev, torch.int32, (N // tile_n,))
    out = torch.empty(2 * N, dtype=torch.float32, device=dev)
    best_d, best_i = out[:N], out[N:].view(torch.int32)
    _launch(_name, "avatar_nn_argmin_ranges", dev, N, Pp,
            (data_pts.data_ptr(), data_part.data_ptr(), model_pts.data_ptr(),
             model_part.data_ptr(), model_valid.data_ptr(),
             None if cstart is None else cstart.data_ptr(),
             None if cend is None else cend.data_ptr(),
             best_d.data_ptr(), best_i.data_ptr()),
            (N, Pp, tile_n, chunk, wild))
    return best_d, best_i


def nn_argmin(data_pts, data_part, model_pts, model_part, model_valid,
              tile_n: int = 256, chunk: int = 1024, wild: int = -1000):
    """Masked NN over the whole model axis (the reference's B2 kernel):
    ``nn_argmin_ranges`` with every tile scanning every chunk."""
    return nn_argmin_ranges(data_pts, data_part, model_pts, model_part,
                            model_valid, None, None, tile_n, chunk, wild,
                            _name="nn_argmin")


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


# -- the merge key of the kernel's work units ------------------------------

# the key of (3e38, -1): no candidate
NO_KEY = (int(torch.tensor(_INF, dtype=torch.float32).view(torch.int32))
          << 32) | 0xFFFFFFFF


def pack_key(d2: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The 64-bit key the kernel's work units merge through (atomicMin):
    ``(bits(d2) << 32) | index``.  d2 >= 0, so its float bits order as
    integers and the key stays below 2^63: int64 compares as the kernel's
    unsigned key does.  The smaller d2 wins, then the smaller index; (3e38,
    -1), no candidate, is above every candidate's key."""
    bits = d2.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | (index.to(torch.int64) & 0xFFFFFFFF)


def unpack_key(key: torch.Tensor):
    """(d2 f32, index i32) of a packed key."""
    low = key & 0xFFFFFFFF
    index = torch.where(low >= 2 ** 31, low - 2 ** 32, low).to(torch.int32)
    return (key >> 32).to(torch.int32).view(torch.float32), index


# -- one whole match as one host call ---------------------------------------

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
    dev = dpts.device
    if name not in LAUNCHES:
        raise ValueError(f"unknown kernel name {name}")
    n_real = dpts.shape[0]
    _check_sizes(n, pp, tile_n, chunk, -1)
    if not n - tile_n < n_real <= n or not 0 < p <= pp:
        raise ValueError(f"n_real={n_real}, n={n}, p={p}, pp={pp}")
    if (cstart is None) != (cend is None):
        raise ValueError("cstart and cend go together")
    if mperm is None and mpart.shape[0] not in (p, pp):
        raise ValueError(f"mpart has {mpart.shape[0]} entries, want {p} or "
                         f"{pp}")
    if dev.type == "cuda":      # the plain version takes what torch takes
        _want("dpts", dpts, dev, torch.float32, (n_real, 3))
        _want("dpart", dpart, dev, torch.int32, (n_real,))
        if mperm is not None:
            _want("mperm", mperm, dev, torch.int32, (pp,))
        _want("mpart", mpart, dev, torch.int32,
              (pp if mperm is not None else mpart.shape[0],))
        if cstart is not None:
            _want("cstart", cstart, dev, torch.int32, (n // tile_n,))
            _want("cend", cend, dev, torch.int32, (n // tile_n,))
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


def nn_match(m: MatchArgs, model_cloud, center, visible, wild: int = -1000,
             wild_gate2=None):
    """One correspondence search: (best_d [n_real] f32, corr [n_real] i32,
    wgt [n_real] f32, n_matched scalar f32).

    The model rows are recentred on ``center`` ([3] f32), permuted by
    ``m.mperm`` or padded to ``m.pp`` slots, the data rows recentred and
    padded to ``m.n``; ``corr`` is the nearest candidate's ORIGINAL model
    row, or -1 where the row is padding, has no candidate, or is a wildcard
    further than ``wild_gate2`` (a number or a one-element f32 tensor).
    """
    dev = m.dpts.device
    if dev.type == "cpu":
        return nn_match_ref(m, model_cloud, center, visible, wild, wild_gate2)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _want("model_cloud", model_cloud, dev, torch.float32, (m.p, 3))
    _want("center", center, dev, torch.float32, (3,))
    _want("visible", visible, dev, torch.bool, (m.p,))
    if wild >= _BIG_PART:
        raise ValueError(f"wild={wild} must be below 2^30")
    gate_mode, gate_val, gate_ptr = 0, 0.0, None
    if isinstance(wild_gate2, torch.Tensor) and wild_gate2.is_cuda:
        if wild_gate2.numel() != 1 or wild_gate2.dtype != torch.float32 \
                or wild_gate2.device != dev:
            raise ValueError("wild_gate2 must be one float32 on the data's "
                             "device")
        gate_mode, gate_ptr = 2, wild_gate2.data_ptr()
    elif wild_gate2 is not None:
        gate_mode, gate_val = 1, float(wild_gate2)
    n, n_real = m.n, m.dpts.shape[0]
    # one allocation for the four results (corr reads its part as int32)
    out = torch.empty(3 * n + 1, dtype=torch.float32, device=dev)
    best_d, wgt, n_matched = out[:n], out[2 * n:3 * n], out[3 * n]
    corr = out[n:2 * n].view(torch.int32)
    p_dpts, p_dpart, p_mperm, p_mpart, p_cstart, p_cend = m.ptrs
    _launch(m.name, "avatar_nn_match", dev, n, m.pp,
            (p_dpts, p_dpart, n_real, n, model_cloud.data_ptr(),
             center.data_ptr(), p_mperm, visible.data_ptr(), p_mpart, m.p,
             m.pp, m.mpart.shape[0], p_cstart, p_cend, m.tile_n, m.chunk,
             wild, gate_mode, gate_val, gate_ptr),
            (best_d.data_ptr(), corr.data_ptr(), wgt.data_ptr(),
             n_matched.data_ptr()))
    if n_real != n:
        best_d, corr, wgt = best_d[:n_real], corr[:n_real], wgt[:n_real]
    return best_d, corr, wgt, n_matched


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
