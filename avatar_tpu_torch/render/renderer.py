"""AvatarRenderer: depth / part-mask / Lambert / face-id rendering
(counterpart of ``avatar_tpu/render/renderer.py``), on the exact z-buffer
rasterizer of ``raster.py``, on the avatar model's device.

Semantics of the reference kept:
  * projection with the y-flip (AvatarRenderer.cpp:16-19);
  * near-edge-on winning faces (|unit face normal z| < 0.1) render as
    background — depth 0, part 255 (AvatarRenderer.cpp:88-91, 191-194);
  * each pixel's part is that of the nearest projected corner of the
    winning face (first corner on ties), through part_map;
  * Lambert: two point lights (0.8, 1.5, -1.2) x 0.8 and (-0.2, -1.5, 0.4)
    x 0.2, vertex normals flipped toward the camera, faces with
    |normal z| <= 1e-2 not drawn (AvatarRenderer.cpp:103-172).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from avatar_tpu_torch.render import raster
from avatar_tpu_torch.render.raster import project_points


class FrameRender(NamedTuple):
    """All per-frame render products (``render_frames`` puts a batch axis
    in front of each)."""
    fid: torch.Tensor        # [H,W] int32, -1 background
    depth: torch.Tensor      # [H,W] f32, 0 background or edge-on winner
    part_mask: torch.Tensor  # [H,W] uint8, 255 background
    bary: torch.Tensor       # [H,W,3]
    n_dropped: torch.Tensor  # scalar int32


def face_normals(cloud: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unit face normals [..., F, 3] of cloud [..., P, 3]."""
    faces = faces.long()
    a, b, c = (cloud[..., faces[:, k], :] for k in range(3))
    n = torch.linalg.cross(b - a, c - a)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)


def render_frames(cloud: torch.Tensor, faces: torch.Tensor,
                  vertex_part: torch.Tensor, fx: float, fy: float, cx: float,
                  cy: float, height: int, width: int, budget: int
                  ) -> FrameRender:
    """Raster + depth + part mask for a batch of posed clouds [B, P, 3]:
    every field of the result has a leading B, and a frame's result does
    not depend on the frames beside it (``raster.rasterize_batch``).

    vertex_part: [P] int body part per vertex (part_map[main_joint]).
    """
    faces = faces.long()
    B = cloud.shape[0]
    proj = project_points(cloud, fx, fy, cx, cy)        # [B,P,2]
    z = cloud[..., 2]
    edge_on = torch.abs(face_normals(cloud, faces)[..., 2]) < 0.1   # [B,F]

    out = raster.rasterize_batch(proj, z, faces, height, width, budget)

    hit = out.fid >= 0
    f_safe = torch.clamp(out.fid, min=0).long()
    winner_edge_on = raster._per_slot(edge_on, f_safe) & hit
    depth = torch.where(winner_edge_on, 0.0, out.depth)

    # nearest-corner part assignment (paintPartsTriangleNN)
    yy = torch.arange(height, dtype=proj.dtype, device=proj.device)[:, None]
    xx = torch.arange(width, dtype=proj.dtype, device=proj.device)[None, :]
    tri = faces[f_safe]                                 # [B,H,W,3]
    pv = raster._per_slot(proj, tri)                    # [B,H,W,3,2]
    d2 = (pv[..., 0] - xx[..., None]) ** 2 + (pv[..., 1] - yy[..., None]) ** 2
    nearest = torch.argmin(d2, dim=-1)                  # first on ties
    vid = torch.gather(tri, -1, nearest[..., None])[..., 0]
    part = vertex_part[vid].to(torch.uint8)
    part = torch.where(hit & ~winner_edge_on, part,
                       torch.full_like(part, 255))
    return FrameRender(fid=out.fid, depth=depth, part_mask=part,
                       bary=out.bary, n_dropped=out.n_dropped)


def render_frame(cloud: torch.Tensor, faces: torch.Tensor,
                 vertex_part: torch.Tensor, fx: float, fy: float, cx: float,
                 cy: float, height: int, width: int, budget: int
                 ) -> FrameRender:
    """``render_frames`` for one posed cloud [P, 3]; the result has no
    leading axis."""
    out = render_frames(cloud[None], faces, vertex_part, fx, fy, cx, cy,
                        height, width, budget)
    return FrameRender(*(x[0] for x in out))


def render_lambert(cloud: torch.Tensor, faces: torch.Tensor, fx: float,
                   fy: float, cx: float, cy: float, height: int, width: int,
                   budget: int) -> torch.Tensor:
    """Grayscale two-light Lambert render (AvatarRenderer.cpp:103-172):
    [H, W] uint8, 0 = background."""
    faces = faces.long()
    proj = project_points(cloud, fx, fy, cx, cy)
    z = cloud[..., 2]
    fn = face_normals(cloud, faces)
    visible = torch.abs(fn[:, 2]) > 1e-2                # ref :131

    # vertex normals: sum of adjacent face normals, flipped toward camera
    vn = torch.zeros_like(cloud)
    for k in range(3):
        vn = vn.index_add(0, faces[:, k], fn)
    vn = vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp(min=1e-12)
    vn = torch.where(vn[:, 2:3] > 0, -vn, vn)           # ref :134-137

    def intensity(light, w):
        lv = torch.as_tensor(light, dtype=cloud.dtype,
                             device=cloud.device) - cloud
        lv = lv / torch.linalg.norm(lv, dim=-1, keepdim=True).clamp(
            min=1e-12)
        return torch.sum(lv * vn, dim=-1) * w

    lum = torch.clamp((intensity([0.8, 1.5, -1.2], 0.8) +
                       intensity([-0.2, -1.5, 0.4], 0.2)) * 255.0,
                      min=0.0)                          # [P]

    out = raster.rasterize(proj, z, faces, height, width, budget,
                           face_valid=visible)
    tri = faces[torch.clamp(out.fid, min=0).long()]     # [H,W,3]
    val = torch.sum(out.bary * lum[tri], dim=-1)
    val = torch.where(out.fid >= 0, torch.clamp(val, 0.0, 255.0), 0.0)
    return val.to(torch.uint8)


class AvatarRenderer:
    """Stateful per-avatar renderer with cached products (reference
    AvatarRenderer.h:18-71 API).  Renders on the avatar model's device and
    returns numpy images."""

    def __init__(self, ava, intrin, part_map: Optional[np.ndarray] = None):
        self.ava = ava
        self.intrin = intrin
        model = ava.model
        # vertex part labels: part_map[main_joint] (identity when absent)
        vp = model.main_joint
        if part_map is not None and len(part_map) > 0:
            vp = np.asarray(part_map, np.int32)[vp]
        self._vertex_part = torch.as_tensor(vp, dtype=torch.int32,
                                            device=model.device)
        self._faces = torch.as_tensor(model.faces, dtype=torch.int32,
                                      device=model.device)
        self._cache = {}

    def update(self):
        """Invalidate the caches after the avatar's pose changed
        (AvatarRenderer.cpp:218-222)."""
        self._cache.clear()

    def _cloud(self) -> torch.Tensor:
        if self.ava.cloud is None:
            raise RuntimeError(
                "avatar cloud is empty; call Avatar.update() first")
        return torch.as_tensor(self.ava.cloud, dtype=self.ava.model.dtype,
                               device=self.ava.model.device)

    def get_projected_points(self) -> np.ndarray:
        if "proj" not in self._cache:
            i = self.intrin
            self._cache["proj"] = project_points(
                self._cloud(), i.fx, i.fy, i.cx, i.cy).cpu().numpy()
        return self._cache["proj"]

    def get_projected_joints(self) -> np.ndarray:
        if "proj_joints" not in self._cache:
            i = self.intrin
            joints = torch.as_tensor(self.ava.joint_pos,
                                     dtype=self.ava.model.dtype,
                                     device=self.ava.model.device)
            self._cache["proj_joints"] = project_points(
                joints, i.fx, i.fy, i.cx, i.cy).cpu().numpy()
        return self._cache["proj_joints"]

    def _frame(self, image_size: Tuple[int, int]) -> FrameRender:
        H, W = image_size
        key = ("frame", H, W)
        if key not in self._cache:
            i = self.intrin
            budget = raster.default_budget(H, W, int(self._faces.shape[0]))
            self._cache[key] = render_frame(
                self._cloud(), self._faces, self._vertex_part,
                i.fx, i.fy, i.cx, i.cy, H, W, budget)
        return self._cache[key]

    def render_depth(self, image_size) -> np.ndarray:
        return self._frame(tuple(image_size)).depth.cpu().numpy()

    def render_part_mask(self, image_size, part_map=None) -> np.ndarray:
        # part_map is fixed at construction; argument kept for API parity
        return self._frame(tuple(image_size)).part_mask.cpu().numpy()

    def render_faces(self, image_size) -> np.ndarray:
        return self._frame(tuple(image_size)).fid.cpu().numpy()

    def render_lambert(self, image_size) -> np.ndarray:
        H, W = tuple(image_size)
        key = ("lambert", H, W)
        if key not in self._cache:
            i = self.intrin
            budget = raster.default_budget(H, W, int(self._faces.shape[0]))
            self._cache[key] = render_lambert(
                self._cloud(), self._faces, i.fx, i.fy, i.cx, i.cy, H, W,
                budget)
        return self._cache[key].cpu().numpy()

    # C++ method-name aliases
    renderDepth = render_depth
    renderPartMask = render_part_mask
    renderFaces = render_faces
    renderLambert = render_lambert
