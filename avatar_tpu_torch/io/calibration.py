"""Camera intrinsics (counterpart of ``avatar_tpu/io/calibration.py``;
reference include/Calibration.h:11-77, Calibration.cpp).

The on-disk ``intrin.txt`` format is whitespace-separated ``tag value``
pairs with tags fx/fy/cx/cy plus distortion coefficients, read with the
reference's documented divergence: 0-based ``k0..k5`` / ``p0 p1`` tags, as
the reference's writer and its genuine artifact use them.  ``to_3d``,
``to_2d`` and ``depth_to_xyz`` take torch tensors (on any device);
``depth_to_xyz_np`` and ``intrin_from_xyz`` are host numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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

    # -- file I/O (reference Calibration.cpp:19-51, 97-112) ------------------

    @classmethod
    def from_file(cls, path: str) -> "CameraIntrin":
        intr = cls()
        k = [0.0] * 6
        p = [0.0] * 2
        good = 0
        with open(path, "r") as f:
            toks = f.read().split()
        i = 0
        while i + 1 < len(toks):
            tag = toks[i]
            if len(tag) != 2:
                i += 1
                continue
            try:
                val = float(toks[i + 1])
            except ValueError:
                i += 1
                continue
            if tag in ("fx", "fy", "cx", "cy"):
                setattr(intr, tag, val)
                good += 1
            elif tag[0] == "k" and tag[1].isdigit():
                if int(tag[1]) < 6:
                    k[int(tag[1])] = val
            elif tag[0] == "p" and tag[1].isdigit():
                if int(tag[1]) < 2:
                    p[int(tag[1])] = val
            i += 2
        intr.k = tuple(k)
        intr.p = tuple(p)
        if good != 4:
            raise ValueError(f"intrin file {path} missing fx/fy/cx/cy")
        return intr

    def write_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"fx {self.fx}\ncx {self.cx}\nfy {self.fy}\n"
                    f"cy {self.cy}\n")
            for i, v in enumerate(self.k):
                if v != 0.0:
                    f.write(f"k{i} {v}\n")
            for i, v in enumerate(self.p):
                if v != 0.0:
                    f.write(f"p{i} {v}\n")

    # -- geometry -------------------------------------------------------------

    def to_3d(self, points_2d: torch.Tensor, depth: torch.Tensor
              ) -> torch.Tensor:
        """Screen [..., 2] + depth [...] -> camera-space XYZ [..., 3]
        (reference Calibration.cpp:68-74)."""
        x = (points_2d[..., 0] - self.cx) * depth / self.fx
        y = (points_2d[..., 1] - self.cy) * depth / self.fy
        return torch.stack([x, y, depth], dim=-1)

    def to_2d(self, points_3d: torch.Tensor) -> torch.Tensor:
        """Camera-space XYZ [..., 3] -> screen [..., 2], no y-flip
        (reference Calibration.cpp:76-80)."""
        z = points_3d[..., 2]
        return torch.stack([points_3d[..., 0] * self.fx / z + self.cx,
                            points_3d[..., 1] * self.fy / z + self.cy],
                           dim=-1)

    def depth_to_xyz(self, depth: torch.Tensor) -> torch.Tensor:
        """Depth map [H, W] -> XYZ map [H, W, 3]: x = (c - cx) z / fx,
        y = (r - cy) z / fy; zero depth maps to (0, 0, 0) (reference
        Calibration.cpp:82-95)."""
        H, W = depth.shape
        cols = torch.arange(W, dtype=depth.dtype, device=depth.device)
        rows = torch.arange(H, dtype=depth.dtype, device=depth.device)
        x = (cols[None, :] - self.cx) * depth / self.fx
        y = (rows[:, None] - self.cy) * depth / self.fy
        return torch.stack([x, y, depth], dim=-1)

    def depth_to_xyz_np(self, depth: np.ndarray) -> np.ndarray:
        """Host (numpy) version of ``depth_to_xyz``."""
        H, W = depth.shape
        cols = np.arange(W, dtype=depth.dtype)
        rows = np.arange(H, dtype=depth.dtype)
        x = (cols[None, :] - self.cx) * depth / self.fx
        y = (rows[:, None] - self.cy) * depth / self.fy
        return np.stack([x, y, depth], axis=-1)


def intrin_from_xyz(xyz_map: np.ndarray) -> CameraIntrin:
    """Pinhole intrinsics of a recorded XYZ map by least squares over
    c*z = fx*x + cx*z and r*z = fy*y + cy*z (reference
    getCameraIntrinFromXYZ, Util.cpp:137-174).  Zero-depth pixels give
    zero rows."""
    m = np.asarray(xyz_map, np.float64)
    H, W = m.shape[:2]
    cols, rows = np.meshgrid(np.arange(W), np.arange(H))
    x = m[..., 0].ravel()
    y = m[..., 1].ravel()
    z = m[..., 2].ravel()
    A = np.stack([x, z], axis=1)
    fx, cx = np.linalg.lstsq(A, cols.ravel() * z, rcond=None)[0]
    A[:, 0] = y
    fy, cy = np.linalg.lstsq(A, rows.ravel() * z, rcond=None)[0]
    return CameraIntrin(fx=float(fx), fy=float(fy), cx=float(cx),
                        cy=float(cy))
