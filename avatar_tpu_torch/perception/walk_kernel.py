"""The forest walk as one hand-written CUDA kernel (``csrc/forest_walk.cu``).

``rtree.walk_pixels`` calls ``walk`` for CUDA tensors; its plain version,
``rtree.walk_pixels_plain``, serves the CPU.  The kernel replaces no TPU
kernel (the JAX package's walk is plain JAX): it walks a set of trees over
a set of pixels in one launch where the eager level loop took ~54 launches
a level.  ``LIBRARY`` (``build_cache.CudaLibrary``) builds it with nvcc
at its first launch, binds its plain C entry point through ctypes and
launches it.

There is no fallback: ``walk`` launches the kernel or raises on what the
kernel does not take.  ``LAUNCHES`` counts launches, and each launch
counts ``walk_launches`` in the stage clock's open scope, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from avatar_tpu_torch import profiling
from avatar_tpu_torch.build_cache import CudaLibrary
from avatar_tpu_torch.device import want

_MAX_TREES = 65535   # the grid's y axis

LAUNCHES = 0         # walks launched since the last reset

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("forest_walk.cu", "libforest_walk", {
    "avatar_forest_walk": [_ptr] * 6 + [_i64, _i32, _i32] + [_ptr] * 4 +
                          [_i32, _ptr] + [_i64] * 6 + [_i32, _ptr, _ptr]})
build = LIBRARY.build


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
    (tlx, tly), (brx, bry) = top_left, bot_right
    LIBRARY.launch(
        "avatar_forest_walk", dev, tree.u.data_ptr(), tree.v.data_ptr(),
        tree.thresh.data_ptr(), tree.lnode.data_ptr(), tree.rnode.data_ptr(),
        tree.leafid.data_ptr(), nodes[-1], t0, t1 - t0, ys.data_ptr(),
        xs.data_ptr(), z.data_ptr(), fg.data_ptr(), k, probe_flat.data_ptr(),
        Hp, Wp, int(tlx), int(tly), int(brx), int(bry), int(max_depth),
        out.data_ptr())
    LAUNCHES += 1
    profiling.count("walk_launches")
    return out
