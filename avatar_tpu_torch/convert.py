"""Carry weights and state across from the JAX reference.

``from_reference`` turns the reference's containers — ``LBSParams``,
``PriorData``, ``FitContext``, ``TreeTensors``, ``Theta`` — into the port's
containers of the same name, field for field, through numpy
(``np.array``: a copy, with the dtype kept).  It needs no JAX: any object
whose class has one of those names and the same fields converts.  The
parity tests use it to give both packages identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from avatar_tpu_torch.core.lbs import LBSParams
from avatar_tpu_torch.optim.gauss_newton import FitContext, PriorData, Theta
from avatar_tpu_torch.perception.rtree import TreeTensors

_TYPES = {cls.__name__: cls for cls in
          (LBSParams, PriorData, FitContext, TreeTensors, Theta)}


def from_reference(obj, device: str | torch.device = "cpu"):
    """Port counterpart of a reference container (or array)."""
    if obj is None:
        return None
    cls = _TYPES.get(type(obj).__name__)
    if cls is not None:
        return cls(*(from_reference(getattr(obj, f), device)
                     for f in cls._fields))
    return torch.as_tensor(np.array(obj), device=device)
