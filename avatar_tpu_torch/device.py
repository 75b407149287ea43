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


def get_device(name: str | torch.device = "cpu") -> torch.device:
    """``torch.device`` for ``name``.  Raises when CUDA is requested and
    not available: there is no silent CPU fallback."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available")
    return dev
