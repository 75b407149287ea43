"""AvatarOptimizer: the public pose/shape fitting API (counterpart of
``avatar_tpu/optim/optimizer.py``; reference AvatarOptimizer.h:11-61).

Construct with an ``Avatar``, camera intrinsics, image size, body-part
count and joint->part map; ``optimize(data_cloud, data_part_labels,
icp_iters)`` fits the avatar's (p, r, w) to a labelled point cloud on the
model's device.  ``num_threads`` is accepted for API parity and ignored.
Data clouds are padded to power-of-two buckets of at least 1024 rows, as
the reference pads them, so the fit takes the planned NN path.  Every copy
between host and device is a counted read (``profiling.host_read``,
``to_device``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from avatar_tpu_torch.optim.gauss_newton import (FitContext, PriorData, Theta,
                                                 fit)
from avatar_tpu_torch.profiling import host_read, to_device


def _bucket(n: int, lo: int = 1024) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class AvatarOptimizer:
    def __init__(self, ava, intrin=None, image_size=None, num_parts: int = 0,
                 part_map: Optional[Sequence[int]] = None):
        self.ava = ava
        self.intrin = intrin
        self.image_size = image_size
        model = ava.model
        self.device = model.device
        self.num_parts = num_parts or model.num_joints()

        # the reference's tuned defaults (AvatarOptimizer.h:27-39)
        self.beta_pose = 0.1
        self.beta_shape = 1.0
        # nn_step k > 1 keeps every k-th model vertex as an NN candidate
        self.nn_step = 1
        self.max_iters_per_icp = 10
        self.enable_occlusion = True
        # Huber IRLS and the optional point-to-plane mix (reference extras)
        self.robust = True
        self.point_weight = 1.0
        self.plane_weight = 0.0
        self.huber_k = 1.5
        self.robust_per_part = False

        if part_map is None or len(part_map) == 0:
            part_map_arr = np.arange(model.num_joints(), dtype=np.int32)
        else:
            part_map_arr = np.asarray(part_map, np.int32)
        self.part_map = part_map_arr
        # body part of each vertex = part_map[main assigned joint]
        # (reference AvatarOptimizer.cpp:1307-1311)
        model_part = part_map_arr[model.main_joint]

        if model.pose_prior is None:
            raise ValueError("AvatarOptimizer requires a model pose prior")
        pp = model.pose_prior
        tt = lambda a, dtype=model.dtype: torch.as_tensor(
            a, dtype=dtype, device=self.device)
        self._ctx = FitContext(
            lbs=model.params, anc_mask=tt(model.ancestor_mask),
            faces=tt(model.faces, torch.int32),
            model_part=tt(model_part, torch.int32),
            prior=PriorData(pp.means, pp.prec_cho, pp.consts_log))
        self._programs = {}     # the fit's LM programs (gauss_newton.fit)
        self._dtype = model.dtype

    # C++-style attribute aliases
    @property
    def betaPose(self):
        return self.beta_pose

    @betaPose.setter
    def betaPose(self, v):
        self.beta_pose = v

    @property
    def betaShape(self):
        return self.beta_shape

    @betaShape.setter
    def betaShape(self, v):
        self.beta_shape = v

    @property
    def maxItersPerICP(self):
        return self.max_iters_per_icp

    @maxItersPerICP.setter
    def maxItersPerICP(self, v):
        self.max_iters_per_icp = v

    def optimize(self, data_cloud: np.ndarray, data_part_labels: np.ndarray,
                 icp_iters: int = 1, num_threads: int = 0) -> dict:
        """Fit the avatar to a labelled data cloud; updates ``self.ava`` in
        place, ending with ``Avatar.update()``.

        data_cloud: [N, 3] (or reference-style [3, N]) points in avatar
          space (x, -y_image, z); data_part_labels: [N] int body parts.
        """
        data_cloud = np.asarray(data_cloud, np.float64)
        if data_cloud.ndim != 2:
            raise ValueError("data_cloud must be 2D")
        if data_cloud.shape[0] == 3 and data_cloud.shape[1] != 3:
            data_cloud = data_cloud.T
        labels = np.asarray(data_part_labels, np.int32).reshape(-1)
        if labels.shape[0] != data_cloud.shape[0]:
            raise ValueError("labels length must match point count")

        N = data_cloud.shape[0]
        B = _bucket(N)
        pts = np.zeros((B, 3), np.float64)
        pts[:N] = data_cloud
        parts = np.full(B, -1, np.int32)
        parts[:N] = labels

        ctx = self._ctx
        if self.nn_step and self.nn_step > 1:
            n_model = ctx.lbs.weights.shape[0]
            mask = (np.arange(n_model) % int(self.nn_step)) == 0
            ctx = ctx._replace(cand_mask=to_device(mask, self.device))

        ava = self.ava
        t = lambda a, dtype=self._dtype: to_device(np.asarray(a),
                                                   self.device, dtype)
        theta0 = Theta(p=t(ava.p), rots=t(ava.r), w=t(ava.w))
        # the reference's budget of icp_iters NN updates x maxItersPerICP
        # solver iterations; the fit re-matches every LM step
        n_steps = int(icp_iters) * int(self.max_iters_per_icp)
        theta, diag = fit(
            ctx, ava.model.parents, t(pts), t(parts, torch.int32), theta0,
            float(self.beta_pose), float(self.beta_shape), n_steps=n_steps,
            use_jsr=ava.model.use_joint_shape_regressor,
            enable_occlusion=bool(self.enable_occlusion),
            robust=bool(self.robust), plane_weight=float(self.plane_weight),
            point_weight=float(self.point_weight),
            num_parts=int(self.num_parts), huber_k=float(self.huber_k),
            robust_per_part=bool(self.robust_per_part),
            programs=self._programs)
        ava.p = host_read(theta.p).astype(np.float64)
        ava.r = host_read(theta.rots).astype(np.float64)
        ava.w = host_read(theta.w).astype(np.float64)
        ava.update()
        return dict(cost=float(host_read(diag.cost)),
                    n_matched=int(host_read(diag.n_matched)),
                    inner_iters=int(host_read(diag.inner_iters)),
                    part_counts=host_read(diag.part_counts).tolist())
