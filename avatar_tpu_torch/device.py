"""Device selection and the float32 policy.

The reference runs every contraction at ``Precision.HIGHEST`` (full f32:
``core/lbs.py``, ``core/rotation.py``, ``optim/gauss_newton.py``).  On the
card a float32 matmul is full f32 by default but a float32 convolution
goes through cuDNN in TF32; both are pinned to full f32 here, when this
module is imported, so every module of the port that builds tensors on a
device sees the same policy.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def get_device(name: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``name``, the card unless the caller asks for
    the CPU.  Raises when CUDA is requested and not available: there is no
    silent CPU fallback."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available")
    return dev


def current_stream(index: int) -> int:
    """The raw handle of the current CUDA stream of device ``index``, for a
    kernel launched through ctypes."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:         # the same handle, without building a Stream
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def want(name: str, t: torch.Tensor, dev, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev``: what a hand-written kernel's wrapper checks before it passes
    the tensor's pointer."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, not on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
