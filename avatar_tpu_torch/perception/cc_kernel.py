"""Connected components as one hand-written CUDA kernel
(``csrc/cc_label.cu``).

``cc.connected_components`` calls ``label`` for CUDA tensors; its plain
version, ``cc.connected_components_plain``, serves the CPU.  The kernel
replaces no TPU kernel (the JAX package's labelling is plain jnp): it runs
the plain loop's sweeps in one launch, with no host read, where the eager
loop took ~24 launches and one read of its ``changed`` flag a sweep.  Its
labels equal the loop's to the bit, ``max_iters`` included.  It is built
with nvcc at its first launch, into ``avatar_tpu_torch/_build/``, as a
shared library with a plain C entry point bound through ctypes.

There is no fallback: ``label`` launches the kernel or raises on what the
kernel does not take.  ``LAUNCHES`` counts launches, and each launch
counts ``cc_launches`` in the stage clock's open scope, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from avatar_tpu_torch import profiling
from avatar_tpu_torch.build_cache import (BUILD, NVCC_FLAGS, build_cached,
                                          nvcc)
from avatar_tpu_torch.device import current_stream

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "cc_label.cu"
_MAX_PIXELS = 1 << 30
_ALWAYS, _EQUAL, _DIST2 = 0, 1, 2   # the kernel's gates

LAUNCHES = 0         # labellings launched since the last reset
_lib = None          # the bound library, once built


def build() -> str:
    """Compile (once per source and flags) and bind the kernel.  Returns
    the compiler's output, or '' when the library was already built."""
    global _lib
    if _lib is not None:
        return ""
    lib_path, log = build_cached(
        _SRC, NVCC_FLAGS, "libcc_label",
        lambda out: [nvcc(), *NVCC_FLAGS, "-o", str(out), str(_SRC)], BUILD)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.avatar_cc_label.argtypes = [ptr, i64, i64, i32, ptr, i64, i64, i64,
                                    ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.avatar_cc_label.restype = i32
    _lib = lib
    return log


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
    build()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    v_sy = v_sx = v_sc = 0
    if values is not None:
        v_sy, v_sx = values.stride()[:2]
        v_sc = values.stride(2) if gate == _DIST2 else 0
    args = (active.data_ptr(), *active.stride(), gate,
            None if values is None else values.data_ptr(), v_sy, v_sx, v_sc,
            None if thresh is None else thresh.data_ptr(), H, W,
            int(max_iters), out.data_ptr(), scratch.data_ptr(),
            current_stream(index))
    if index == torch.cuda.current_device():
        rc = _lib.avatar_cc_label(*args)
    else:
        with torch.cuda.device(index):
            rc = _lib.avatar_cc_label(*args)
    if rc != 0:
        raise RuntimeError(f"avatar_cc_label launch failed: CUDA error {rc}")
    LAUNCHES += 1
    profiling.count("cc_launches")
    return out
