"""The forest walk as one hand-written CUDA kernel (``csrc/forest_walk.cu``).

``rtree.walk_pixels`` calls ``walk`` for CUDA tensors; its plain version,
``rtree.walk_pixels_plain``, serves the CPU.  The kernel replaces no TPU
kernel (the JAX package's walk is plain JAX): it walks a set of trees over
a set of pixels in one launch where the eager level loop took ~54 launches
a level.  It is built with nvcc at its first launch, into
``avatar_tpu_torch/_build/``, as a shared library with a plain C entry
point bound through ctypes.

There is no fallback: ``walk`` launches the kernel or raises on what the
kernel does not take.  ``LAUNCHES`` counts launches, and each launch
counts ``walk_launches`` in the stage clock's open scope, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from avatar_tpu_torch import profiling
from avatar_tpu_torch.build_cache import (BUILD, NVCC_FLAGS, build_cached,
                                          nvcc)
from avatar_tpu_torch.device import current_stream, want

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "forest_walk.cu"
_BUILD = BUILD
_MAX_TREES = 65535   # the grid's y axis

LAUNCHES = 0         # walks launched since the last reset
_lib = None          # the bound library, once built


def build() -> str:
    """Compile (once per source and flags) and bind the kernel.  Returns
    the compiler's output, or '' when the library was already built."""
    global _lib
    if _lib is not None:
        return ""
    lib_path, log = build_cached(
        _SRC, NVCC_FLAGS, "libforest_walk",
        lambda out: [nvcc(), *NVCC_FLAGS, "-o", str(out), str(_SRC)], _BUILD)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.avatar_forest_walk.argtypes = (
        [ptr] * 6 + [i64, i32, i32] + [ptr] * 4 + [i32, ptr] + [i64] * 6 +
        [i32, ptr, ptr])
    lib.avatar_forest_walk.restype = i32
    _lib = lib
    return log


def walk(tree, ys, xs, z, fg, probe_flat, probe_shape, max_depth: int,
         top_left, bot_right,
         trees: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``rtree.walk_pixels`` on the card: leaf ids int32, ``ys.shape`` for
    one tree or ``[t1 - t0, *ys.shape]`` for the trees ``trees = (t0, t1)``
    of a stacked forest; -1 where not ``fg``.

    Takes contiguous CUDA tensors on one device: the tree's u, v float32
    [N, 2] (stacked: [T, N, 2]), thresh float32 and lnode, rnode, leafid
    int32 [N] ([T, N]); ys, xs int64, z float32 and fg bool of one shape;
    probe_flat float32 [Hp * Wp].
    """
    global LAUNCHES
    dev = ys.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    stacked = tree.u.dim() == 3
    if stacked != (trees is not None):
        raise ValueError("a tree range goes with a stacked [T, N] forest, "
                         "and only with one")
    T = tree.u.shape[0] if stacked else 1
    t0, t1 = trees if stacked else (0, 1)
    if not 0 <= t0 < t1 <= T or t1 - t0 > _MAX_TREES:
        raise ValueError(f"tree range [{t0}, {t1}) of {T} trees")
    nodes = tuple(tree.u.shape[:-1])
    want("tree.u", tree.u, dev, torch.float32, nodes + (2,))
    want("tree.v", tree.v, dev, torch.float32, nodes + (2,))
    want("tree.thresh", tree.thresh, dev, torch.float32, nodes)
    for name in ("lnode", "rnode", "leafid"):
        want(f"tree.{name}", getattr(tree, name), dev, torch.int32, nodes)
    shape = tuple(ys.shape)
    want("ys", ys, dev, torch.int64, shape)
    want("xs", xs, dev, torch.int64, shape)
    want("z", z, dev, torch.float32, shape)
    want("fg", fg, dev, torch.bool, shape)
    Hp, Wp = (int(s) for s in probe_shape)
    want("probe_flat", probe_flat, dev, torch.float32, (Hp * Wp,))
    if tree.u.data_ptr() % 8 or tree.v.data_ptr() % 8:
        raise ValueError("tree.u and tree.v must be 8-byte aligned")
    k = ys.numel()
    if k >= 2 ** 31:
        raise ValueError(f"{k} pixels: at most 2^31 - 1")
    out = torch.empty(((t1 - t0,) if stacked else ()) + shape,
                      dtype=torch.int32, device=dev)
    build()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    (tlx, tly), (brx, bry) = top_left, bot_right
    args = (tree.u.data_ptr(), tree.v.data_ptr(), tree.thresh.data_ptr(),
            tree.lnode.data_ptr(), tree.rnode.data_ptr(),
            tree.leafid.data_ptr(), nodes[-1], t0, t1 - t0, ys.data_ptr(),
            xs.data_ptr(), z.data_ptr(), fg.data_ptr(), k,
            probe_flat.data_ptr(), Hp, Wp, int(tlx), int(tly), int(brx),
            int(bry), int(max_depth), out.data_ptr(), current_stream(index))
    if index == torch.cuda.current_device():
        rc = _lib.avatar_forest_walk(*args)
    else:
        with torch.cuda.device(index):
            rc = _lib.avatar_forest_walk(*args)
    if rc != 0:
        raise RuntimeError(f"avatar_forest_walk launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    profiling.count("walk_launches")
    return out
