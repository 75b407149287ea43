"""SMPL-family body model data (counterpart of
``avatar_tpu/core/model.py::AvatarModel``).

Loaded on the host with numpy (float64 masters, from ``model.npz`` or from
in-memory arrays) and exposed to the tensor code as an :class:`LBSParams`
of torch tensors on ``device``, plus static metadata (``parents`` tuple,
``faces``).  The reference's legacy text model format and the stateful
``Avatar`` wrapper are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from avatar_tpu_torch.core.lbs import LBSParams
from avatar_tpu_torch.core.pose_prior import GaussianMixture


class AvatarModel:
    """Attributes (numpy float64 masters; torch mirrors in ``.params``):
    v_template [P,3], shapedirs [P,3,K], weights_np [P,J], joint_reg_np
    [J,P], parent [J] (parent[0] == -1), faces [F,3], joint_shape_reg_base
    [J,3], joint_shape_reg [J,3,K], main_joint [P], ancestor_mask [J,J],
    pose_prior (GaussianMixture or None)."""

    def __init__(self, model_dir: str = "", dtype=torch.float32,
                 device: str | torch.device = "cpu", *,
                 arrays: Optional[dict] = None,
                 pose_prior: Optional[GaussianMixture] = None):
        if arrays is None:
            arrays = _load_model_dir(model_dir)
            pose_prior = GaussianMixture.load(
                os.path.join(model_dir, "pose_prior.txt"), dtype, device)
        self.model_dir = model_dir
        self.dtype = dtype
        self.device = torch.device(device)
        self.pose_prior = pose_prior

        self.v_template = np.asarray(arrays["v_template"], np.float64)
        self.shapedirs = np.asarray(arrays["shapedirs"], np.float64)
        self.weights_np = np.asarray(arrays["weights"], np.float64)
        self.joint_reg_np = np.asarray(arrays["joint_reg"], np.float64)
        self.parent = np.asarray(arrays["parent"], np.int32)
        self.faces = np.asarray(arrays["faces"], np.int32)
        self.use_joint_shape_regressor = bool(arrays.get("use_jsr", True))

        J = self.parent.shape[0]
        if "joint_shape_reg_base" in arrays:
            self.joint_shape_reg_base = np.asarray(
                arrays["joint_shape_reg_base"], np.float64)
            self.joint_shape_reg = np.asarray(arrays["joint_shape_reg"],
                                              np.float64)
        else:
            # J(w) = Jreg v_template + (Jreg shapedirs) w
            # (reference AvatarModel.cpp:111-127)
            self.joint_shape_reg_base = self.joint_reg_np @ self.v_template
            self.joint_shape_reg = np.einsum(
                "jp,pck->jck", self.joint_reg_np, self.shapedirs)

        # main assigned joint per point: the model part labels
        # (reference AvatarOptimizer.cpp:1227-1243)
        self.main_joint = np.argmax(self.weights_np, axis=1).astype(np.int32)

        # anc[j, k] = 1 iff j is on the path from k to the root
        anc = np.zeros((J, J), np.float64)
        for k in range(J):
            a = k
            while a != -1:
                anc[a, k] = 1.0
                a = self.parent[a]
        self.ancestor_mask = anc

        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.params = LBSParams(
            v_template=t(self.v_template), shapedirs=t(self.shapedirs),
            weights=t(self.weights_np), joint_reg=t(self.joint_reg_np),
            joint_shape_reg_base=t(self.joint_shape_reg_base),
            joint_shape_reg=t(self.joint_shape_reg))
        self.parents: Tuple[int, ...] = tuple(int(x) for x in self.parent)

    def num_joints(self) -> int:
        return int(self.parent.shape[0])

    def num_points(self) -> int:
        return int(self.v_template.shape[0])

    def num_shape_keys(self) -> int:
        return int(self.shapedirs.shape[2])


def _load_model_dir(model_path: str) -> dict:
    npz_path = os.path.join(model_path, "model.npz")
    if not os.path.exists(npz_path):
        raise FileNotFoundError(
            f"no avatar model found at {model_path!r}: expected model.npz "
            "(the legacy text model format is not ported)")
    return _load_npz(npz_path)


def _load_npz(npz_path: str) -> dict:
    """Load the SMPL ``model.npz``: v_template [N,3], kintree_table [2,J],
    f [F,3], J_regressor [J,N], weights [N,J], shapedirs [N,3,K]."""
    with np.load(npz_path, allow_pickle=False) as npz:
        kintree = np.asarray(npz["kintree_table"])
        parent = kintree[0].astype(np.int64)
        # SMPL stores parent[0] as 2^32-1 / -1
        parent = np.where(parent > kintree.shape[1], -1, parent).astype(
            np.int32)
        parent[0] = -1
        return dict(v_template=np.asarray(npz["v_template"], np.float64),
                    parent=parent, faces=np.asarray(npz["f"], np.int32),
                    joint_reg=np.asarray(npz["J_regressor"], np.float64),
                    weights=np.asarray(npz["weights"], np.float64),
                    shapedirs=np.asarray(npz["shapedirs"], np.float64),
                    use_jsr=True)
