"""Camera intrinsics: the port's ``io/calibration.CameraIntrin`` with
its host depth-to-XYZ conversion only, frozen."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CameraIntrin:
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    # radial k1..k6 and tangential p1, p2: stored, never applied (as in
    # the reference)
    k: tuple = (0.0,) * 6
    p: tuple = (0.0, 0.0)

    def depth_to_xyz_np(self, depth: np.ndarray) -> np.ndarray:
        """Depth map [H, W] -> XYZ map [H, W, 3]: x = (c - cx) z / fx,
        y = (r - cy) z / fy; zero depth maps to (0, 0, 0)."""
        H, W = depth.shape
        cols = np.arange(W, dtype=depth.dtype)
        rows = np.arange(H, dtype=depth.dtype)
        x = (cols[None, :] - self.cx) * depth / self.fx
        y = (rows[:, None] - self.cy) * depth / self.fy
        return np.stack([x, y, depth], axis=-1)
