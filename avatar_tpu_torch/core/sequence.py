"""Mocap pose bank (counterpart of ``avatar_tpu/core/sequence.py``;
reference AvatarPoseSequence, Avatar.h:223-257, AvatarPoseSequence.cpp).

The CMU ``cmu-mocap.dat`` binary holds frames of ``frame_size`` float64s:
the root position, then one quaternion per joint in Eigen coeffs order
(x, y, z, w); ``.txt`` beside it holds the subsequence table.
``pose_avatar`` writes a frame into an ``Avatar``, converting the
quaternions in float32 as the reference does; ``frames_as_arrays`` puts
the whole bank on a device for the forest trainer's frame generator.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.device import get_device
from avatar_tpu_torch.utils import resolve_root_path


class AvatarPoseSequence:
    def __init__(self, pose_sequence_path: str = ""):
        seq_path = pose_sequence_path or resolve_root_path(
            "data/avatar-mocap/cmu-mocap.dat")
        meta_path = seq_path + ".txt"
        self.sequence_path = seq_path
        self.subsequences: Dict[str, int] = {}
        self.num_frames = 0
        self.frame_size = 0
        self._data: Optional[np.ndarray] = None
        if not (os.path.exists(seq_path) and os.path.exists(meta_path)):
            return
        with open(meta_path, "r") as f:
            toks = f.read().split()
        n_subseq, self.num_frames, frame_size_bytes = (
            int(toks[0]), int(toks[1]), int(toks[2]))
        for i in range(n_subseq):
            start, name = int(toks[3 + 2 * i]), toks[4 + 2 * i]
            self.subsequences[name] = start // frame_size_bytes
        self.frame_size = frame_size_bytes // 8

    def preload(self) -> None:
        self._data = np.fromfile(self.sequence_path, dtype="<f8").reshape(
            -1, self.frame_size)[: self.num_frames]

    def get_frame(self, frame_id: int) -> np.ndarray:
        if self._data is not None:
            return self._data[frame_id]
        with open(self.sequence_path, "rb") as f:
            f.seek(frame_id * self.frame_size * 8)
            return np.frombuffer(f.read(self.frame_size * 8), dtype="<f8")

    def pose_avatar(self, ava, frame_id: int) -> None:
        """Set the avatar's pose from a frame (reference
        AvatarPoseSequence.cpp:47-64)."""
        frame = self.get_frame(frame_id)
        ava.p = frame[:3].copy()
        n_joints = ava.model.num_joints()
        quats = frame[3:3 + n_joints * 4].reshape(n_joints, 4)
        ava.r = rotation.quat_to_mat(torch.tensor(
            quats, dtype=torch.float32)).numpy()

    poseAvatar = pose_avatar

    def frames_as_arrays(self, dtype=torch.float32,
                         device: str | torch.device = "cuda"):
        """The whole bank as (pos [F,3], rots [F,J,3,3]) tensors on
        ``device``, for batched pose sampling."""
        if self._data is None:
            self.preload()
        device = get_device(device)
        pos = torch.as_tensor(self._data[:, :3], dtype=dtype, device=device)
        n_joints = (self.frame_size - 3) // 4
        quats = self._data[:, 3:3 + n_joints * 4].reshape(-1, n_joints, 4)
        rots = rotation.quat_to_mat(torch.as_tensor(
            quats.copy(), dtype=dtype, device=device))
        return pos, rots

    @staticmethod
    def write(path: str, positions: np.ndarray, quats: np.ndarray,
              subsequences: Optional[Dict[str, int]] = None) -> None:
        """Write a pose bank: positions [F,3], quats [F,J,4] (x,y,z,w)."""
        F = positions.shape[0]
        frame_size = 3 + quats.shape[1] * 4
        data = np.concatenate(
            [positions.reshape(F, 3), quats.reshape(F, -1)], axis=1
        ).astype("<f8")
        data.tofile(path)
        subsequences = subsequences or {"all": 0}
        with open(path + ".txt", "w") as f:
            f.write(f"{len(subsequences)} {F} {frame_size * 8}\n")
            for name, start in subsequences.items():
                f.write(f"{start * frame_size * 8} {name}\n")
