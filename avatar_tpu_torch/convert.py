"""Carry weights and state across from the JAX reference.

``from_reference`` turns the reference's containers — ``LBSParams``,
``PriorData``, ``FitContext``, ``TreeTensors``, ``Theta``,
``RasterOutput`` — into the port's containers of the same name, field for
field, through numpy (``np.array``: a copy, with the dtype kept), and a
reference ``Avatar``'s state (``w``, ``p``, ``r``) into a port ``Avatar``
of a given model.  It needs no JAX: any object whose class has one of
those names and the same fields converts.  The parity tests use it to give
both packages identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from avatar_tpu_torch.core.lbs import LBSParams
from avatar_tpu_torch.core.model import Avatar, AvatarModel
from avatar_tpu_torch.optim.gauss_newton import FitContext, PriorData, Theta
from avatar_tpu_torch.perception.rtree import TreeTensors
from avatar_tpu_torch.render.raster import RasterOutput

_TYPES = {cls.__name__: cls for cls in
          (LBSParams, PriorData, FitContext, TreeTensors, Theta,
           RasterOutput)}


def from_reference(obj, device: str | torch.device = "cpu",
                   model: AvatarModel | None = None):
    """Port counterpart of a reference container (or array).  A reference
    ``Avatar`` needs the port's ``model`` to attach its state to; its
    ``cloud`` stays empty until ``update()``."""
    if obj is None:
        return None
    name = type(obj).__name__
    if name == "Avatar":
        if model is None:
            raise ValueError("converting an Avatar needs the port's model")
        ava = Avatar(model)
        ava.w, ava.p, ava.r = (np.array(obj.w, np.float64),
                               np.array(obj.p, np.float64),
                               np.array(obj.r, np.float64))
        return ava
    cls = _TYPES.get(name)
    if cls is not None:
        return cls(*(from_reference(getattr(obj, f), device)
                     for f in cls._fields))
    return torch.as_tensor(np.array(obj), device=device)
