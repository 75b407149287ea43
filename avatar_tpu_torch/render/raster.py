"""Projection (counterpart of ``project_points`` in
``avatar_tpu/render/raster.py``; the rasterizer is not ported yet)."""

from __future__ import annotations

import torch


def project_points(cloud: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Pinhole projection with the avatar renderer's y-flip:
    x = X fx / Z + cx,  y = -Y fy / Z + cy."""
    z = cloud[..., 2]
    return torch.stack([cloud[..., 0] * fx / z + cx,
                        -cloud[..., 1] * fy / z + cy], dim=-1)
