"""Connected components as one hand-written CUDA kernel
(``csrc/cc_label.cu``).

``cc.connected_components`` calls ``label`` for CUDA tensors; its plain
version, ``cc.connected_components_plain``, serves the CPU.  The kernel
replaces no TPU kernel (the JAX package's labelling is plain jnp): it runs
the plain loop's sweeps in one launch, with no host read, where the eager
loop took ~24 launches and one read of its ``changed`` flag a sweep.  Its
labels equal the loop's to the bit, ``max_iters`` included.  ``LIBRARY``
(``build_cache.CudaLibrary``) builds it with nvcc at its first launch,
binds its plain C entry point through ctypes and launches it.

There is no fallback: ``label`` launches the kernel or raises on what the
kernel does not take.  ``LAUNCHES`` counts launches, and each launch
counts ``cc_launches`` in the stage clock's open scope, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from avatar_tpu_torch import profiling
from avatar_tpu_torch.build_cache import CudaLibrary

_MAX_PIXELS = 1 << 30
_ALWAYS, _EQUAL, _DIST2 = 0, 1, 2   # the kernel's gates

LAUNCHES = 0         # labellings launched since the last reset

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("cc_label.cu", "libcc_label", {
    "avatar_cc_label": [_ptr, _i64, _i64, _i32, _ptr, _i64, _i64, _i64, _ptr,
                        _i32, _i32, _i32, _ptr, _ptr, _ptr]})
build = LIBRARY.build


def check(active: torch.Tensor, values: Optional[torch.Tensor],
          thresh: Optional[torch.Tensor]) -> int:
    """Raise unless the kernel takes these arguments; returns its gate.

    ``active``: bool [H, W], any strides.  ``values``: None (every edge
    between active pixels is open), uint8 [H, W] (equal values join) or
    float32 [H, W, 3] XYZ (squared distance at most ``thresh`` joins), any
    strides.  ``thresh``: a one-element float32 tensor with the float32
    values, None otherwise.  All on ``active``'s device."""
    dev = active.device
    if active.dtype != torch.bool or active.dim() != 2:
        raise ValueError(f"active: want a 2-D bool tensor, got "
                         f"{active.dtype} {tuple(active.shape)}")
    H, W = active.shape
    if H * W > _MAX_PIXELS:
        raise ValueError(f"{H}x{W} pixels: the kernel takes at most 2^30")
    if values is None:
        gate = _ALWAYS
    elif values.dtype == torch.uint8 and tuple(values.shape) == (H, W):
        gate = _EQUAL
    elif values.dtype == torch.float32 and tuple(values.shape) == (H, W, 3):
        gate = _DIST2
    else:
        raise ValueError(f"values: want uint8 ({H}, {W}) or float32 ({H}, "
                         f"{W}, 3), got {values.dtype} "
                         f"{tuple(values.shape)}")
    if values is not None and values.device != dev:
        raise ValueError(f"values is on {values.device}, not on {dev}")
    if (gate == _DIST2) != (thresh is not None):
        raise ValueError("a distance threshold goes with float32 XYZ "
                         "values, and only with them")
    if thresh is not None:
        if not isinstance(thresh, torch.Tensor) or \
                thresh.dtype != torch.float32 or thresh.numel() != 1:
            raise ValueError("thresh: want a one-element float32 tensor, the "
                             "kernel reads it on the device")
        if thresh.device != dev:
            raise ValueError(f"thresh is on {thresh.device}, not on {dev}")
    return gate


def label(active: torch.Tensor, values: Optional[torch.Tensor] = None,
          thresh: Optional[torch.Tensor] = None,
          max_iters: int = 64) -> torch.Tensor:
    """``cc.connected_components`` on the card: [H, W] int32 labels, the
    flat index of the component's first pixel, -1 where not active.
    Arguments as ``check`` takes them."""
    global LAUNCHES
    gate = check(active, values, thresh)
    dev = active.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not 0 <= max_iters < 2 ** 31:
        raise ValueError(f"max_iters {max_iters}: want 0 to 2^31 - 1")
    H, W = active.shape
    n = H * W
    out = torch.empty((H, W), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    # the pointer-jump table (n + 1), the changed flag (1), edge bits (n B)
    scratch = torch.empty(n + 2 + (n + 3) // 4, dtype=torch.int32,
                          device=dev)
    v_sy = v_sx = v_sc = 0
    if values is not None:
        v_sy, v_sx = values.stride()[:2]
        v_sc = values.stride(2) if gate == _DIST2 else 0
    LIBRARY.launch(
        "avatar_cc_label", dev, active.data_ptr(), *active.stride(), gate,
        None if values is None else values.data_ptr(), v_sy, v_sx, v_sc,
        None if thresh is None else thresh.data_ptr(), H, W, int(max_iters),
        out.data_ptr(), scratch.data_ptr())
    LAUNCHES += 1
    profiling.count("cc_launches")
    return out
