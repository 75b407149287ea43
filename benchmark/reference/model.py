"""The port's ``AvatarModel`` (built from arrays) and ``Avatar``, frozen."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import rotation
from .lbs import LBSParams, lbs
from .pose_prior import GaussianMixture
from torch import device as get_device


class AvatarModel:
    """Attributes (numpy float64 masters; torch mirrors in ``.params``):
    v_template [P,3], shapedirs [P,3,K], weights_np [P,J], joint_reg_np
    [J,P], parent [J] (parent[0] == -1), faces [F,3], joint_shape_reg_base
    [J,3], joint_shape_reg [J,3,K], initial_joint_pos [J,3], main_joint
    [P], ancestor_mask [J,J], pose_prior (GaussianMixture or None)."""

    def __init__(self, model_dir: str = "", dtype=torch.float32,
                 device: str | torch.device = "cuda", *,
                 arrays: Optional[dict] = None,
                 pose_prior: Optional[GaussianMixture] = None,
                 limit_one_joint_per_point: bool = False):
        self.device = get_device(device)
        self.model_dir = model_dir
        self.dtype = dtype
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
        self.initial_joint_pos = self.joint_shape_reg_base.copy()

        # main assigned joint per point: the model part labels
        # (reference AvatarOptimizer.cpp:1227-1243)
        self.main_joint = np.argmax(self.weights_np, axis=1).astype(np.int32)
        if limit_one_joint_per_point and "joint_shape_reg_base" not in arrays:
            w1 = np.zeros_like(self.weights_np)
            w1[np.arange(len(w1)), self.main_joint] = 1.0
            self.weights_np = w1

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

    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def has_mesh(self) -> bool:
        return self.num_faces() > 0

    def has_pose_prior(self) -> bool:
        return self.pose_prior is not None


def _so3_exp_f32(aa: np.ndarray) -> np.ndarray:
    """Rodrigues in float32, as the reference evaluates its host draws
    (``jnp.asarray`` of a float64 array is float32 there)."""
    return rotation.so3_exp(torch.as_tensor(
        np.asarray(aa), dtype=torch.float32)).numpy()


class Avatar:
    """Pose/shape state of one avatar instance (reference Avatar,
    Avatar.h:155).

    State: ``w`` [K] shape weights, ``p`` [3] root position, ``r``
    [J,3,3] local joint rotations (numpy float64 on the host).
    ``update()`` runs LBS on the model's device and fills ``cloud`` [P,3],
    ``joint_pos`` [J,3] and ``joint_rot_global`` [J,3,3] (numpy).
    """

    def __init__(self, model: AvatarModel):
        self.model = model
        self.w = np.zeros(model.num_shape_keys())
        self.p = np.zeros(3)
        self.r = np.tile(np.eye(3), (model.num_joints(), 1, 1))
        self.cloud: Optional[np.ndarray] = None
        self.joint_pos: Optional[np.ndarray] = None
        self.joint_rot_global: Optional[np.ndarray] = None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.model.dtype,
                               device=self.model.device)

    def update(self) -> None:
        """LBS forward pass (reference Avatar.cpp:22-75)."""
        m = self.model
        cloud, tg, Rg, _ = lbs(m.params, m.parents, self._tensor(self.w),
                               self._tensor(self.p), self._tensor(self.r),
                               use_jsr=m.use_joint_shape_regressor)
        self.cloud = cloud.cpu().numpy()
        self.joint_pos = tg.cpu().numpy()
        self.joint_rot_global = Rg.cpu().numpy()
