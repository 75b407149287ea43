"""Carry weights and state across from the JAX reference.

``from_reference`` turns the reference's containers — ``LBSParams``,
``PriorData``, ``FitContext``, ``TreeTensors``, ``Theta``,
``RasterOutput``, ``SynthSource`` — into the port's containers of the same
name, field for field, through numpy (``np.array``: a copy, with the dtype
kept), a ``ForestData`` into the port's (numpy copies), and a
reference ``Avatar``'s state (``w``, ``p``, ``r``) into a port ``Avatar``
of a given model, and the state of a reference ``Tracker`` or
``AvatarOptimizer`` into the port's.  It needs no JAX: any object whose
class has one of those names and the same fields converts.  The parity
tests use it to give both packages identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from avatar_tpu_torch.core.lbs import LBSParams
from avatar_tpu_torch.core.model import Avatar, AvatarModel
from avatar_tpu_torch.device import get_device
from avatar_tpu_torch.io.formats import ForestData
from avatar_tpu_torch.optim.gauss_newton import FitContext, PriorData, Theta
from avatar_tpu_torch.perception.rtree import TreeTensors
from avatar_tpu_torch.render.raster import RasterOutput
from avatar_tpu_torch.train.synth import SynthSource

_TYPES = {cls.__name__: cls for cls in
          (LBSParams, PriorData, FitContext, TreeTensors, Theta,
           RasterOutput, SynthSource)}


# the host objects' state carried by ``into=``: the avatar's pose and
# shape, plus these attributes (copied as numpy or plain values)
_OPTIMIZER_STATE = ("beta_pose", "beta_shape", "nn_step", "max_iters_per_icp",
                    "enable_occlusion", "robust", "point_weight",
                    "plane_weight", "huber_k", "robust_per_part")
_TRACKER_STATE = ("com_pre", "reinit", "first_init")


def _copy_pose(src, ava: Avatar) -> Avatar:
    ava.w, ava.p, ava.r = (np.array(src.w, np.float64),
                           np.array(src.p, np.float64),
                           np.array(src.r, np.float64))
    return ava


def from_reference(obj, device: str | torch.device = "cuda",
                   model: AvatarModel | None = None, into=None):
    """Port counterpart of a reference container (or array).

    A reference ``Avatar`` needs the port's ``model`` to attach its state
    to; its ``cloud`` stays empty until ``update()``.  A reference
    ``Tracker`` or ``AvatarOptimizer`` is carried ``into`` a port object of
    the same class: the avatar's pose and shape (``ava.update()`` is left
    to the caller) and the state listed in ``_TRACKER_STATE`` /
    ``_OPTIMIZER_STATE``.  Returns ``into``.
    """
    if obj is None:
        return None
    name = type(obj).__name__
    if name == "Avatar":
        if model is None:
            raise ValueError("converting an Avatar needs the port's model")
        return _copy_pose(obj, Avatar(model))
    if name in ("Tracker", "AvatarOptimizer"):
        if type(into).__name__ != name:
            raise ValueError(f"converting a {name} needs the port's {name} "
                             "as ``into``")
        _copy_pose(obj.ava, into.ava)
        for attr in (_TRACKER_STATE if name == "Tracker"
                     else _OPTIMIZER_STATE):
            v = getattr(obj, attr)
            setattr(into, attr, np.array(v) if isinstance(v, np.ndarray)
                    else v)
        return into
    if name == "ForestData":
        return ForestData(*(np.array(getattr(obj, f)) for f in (
            "u", "v", "thresh", "lnode", "rnode", "leafid", "leaf_data")),
            int(obj.num_parts))
    device = get_device(device)
    cls = _TYPES.get(name)
    if cls is not None:
        return cls(*(from_reference(getattr(obj, f), device)
                     for f in cls._fields))
    return torch.as_tensor(np.array(obj), device=device)
