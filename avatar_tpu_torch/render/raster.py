"""Exact z-buffer triangle rasterization (counterpart of
``avatar_tpu/render/raster.py``).

Static shapes, as in the reference:

  1. every face gets a clipped integer bbox;
  2. a fixed sample budget S is spread over the faces by an exclusive scan
     of bbox areas — slot s maps to (face, dx, dy) with one searchsorted
     and a div/mod;
  3. each slot tests barycentric coverage of its pixel and scatter-mins a
     key (quantized depth << face-id bits | face id) into the flat image.

17 bits of depth over [0, z_max] rank the fragments and the face id names
the winner; a per-pixel post pass recomputes the exact interpolated depth
and barycentrics from the winning face.  The key is int64, with 14 bits
of face id as the reference's int32 key has, or as many as the face
count needs: up to 2^14 faces its values, and so the fragments' order,
are the reference's.  The reference aliases face ids above 2^14
silently; here they keep their own bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

FID_BITS = 14
Z_BITS = 17
Z_MAX_DEFAULT = 20.0  # matches RTree BACKGROUND_DEPTH (RTree.cpp:325)


class RasterOutput(NamedTuple):
    # of one pose; ``rasterize_batch`` puts a batch axis in front of each
    fid: torch.Tensor        # [H, W] int32 winning face id, -1 = background
    depth: torch.Tensor      # [H, W] f32 interpolated z, 0 = background
    bary: torch.Tensor       # [H, W, 3] f32 barycentric weights of winner
    n_dropped: torch.Tensor  # scalar int32: slots lost to budget overflow


def project_points(cloud: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Pinhole projection with the avatar renderer's y-flip:
    x = X fx / Z + cx,  y = -Y fy / Z + cy."""
    z = cloud[..., 2]
    return torch.stack([cloud[..., 0] * fx / z + cx,
                        -cloud[..., 1] * fy / z + cy], dim=-1)


def _barycentric(px, py, a, b, c):
    """Barycentric weights (w_a, w_b, w_c) of pixel (px, py) wrt the 2D
    triangle a, b, c (reference AvatarHelpers.cpp:84-108)."""
    denom = (b[..., 0] - c[..., 0]) * (a[..., 1] - c[..., 1]) + (
        c[..., 1] - b[..., 1]) * (a[..., 0] - c[..., 0])
    denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    w1 = ((b[..., 0] - c[..., 0]) * (py - c[..., 1]) +
          (c[..., 1] - b[..., 1]) * (px - c[..., 0])) / denom
    w2 = ((c[..., 0] - a[..., 0]) * (py - c[..., 1]) +
          (a[..., 1] - c[..., 1]) * (px - c[..., 0])) / denom
    return w1, w2, 1.0 - w1 - w2


def _per_slot(t: torch.Tensor, face_of: torch.Tensor) -> torch.Tensor:
    """Per-face values [B, F] or [B, F, C] gathered to slots or pixels:
    ``face_of`` [B, ...] holds face ids -> [B, ..., (C)]."""
    B = t.shape[0]
    idx = face_of.reshape(B, -1)
    if t.ndim == 3:
        idx = idx[..., None].expand(B, idx.shape[1], t.shape[2])
        return torch.gather(t, 1, idx).reshape(*face_of.shape, t.shape[2])
    return torch.gather(t, 1, idx).reshape(face_of.shape)


def fragment_keys(zq: torch.Tensor, face_of: torch.Tensor, n_faces: int):
    """The scatter-min's int64 keys ``zq << fid_bits | face`` of fragments
    of quantized depth ``zq`` (``Z_BITS`` bits) on faces ``face_of``, and
    ``fid_bits``: 14, as the reference's int32 key has, or as many as
    ``n_faces`` needs.  The keys order fragments by depth, then by face
    id; up to 2^14 faces their values are the reference's int32 keys."""
    fid_bits = max(FID_BITS, (n_faces - 1).bit_length())
    return (zq.long() << fid_bits) | face_of.long(), fid_bits


def rasterize_batch(proj: torch.Tensor, z: torch.Tensor, faces: torch.Tensor,
                    height: int, width: int, budget: int,
                    z_max: float = Z_MAX_DEFAULT,
                    face_valid: Optional[torch.Tensor] = None
                    ) -> RasterOutput:
    """Exact z-buffer raster of B poses of one triangle mesh.

    proj [B, P, 2] projected vertices (pixels); z [B, P] camera-space
    depths (> 0 in front of the camera); faces [F, 3] (F < 2^31);
    ``budget`` the sample budget S of EACH
    frame — choose it >= the sum of face bbox areas, overflowing slots are
    dropped and counted in ``n_dropped``; face_valid optional [B, F] bool
    mask of faces to draw.  Every field of the result has a leading B.

    Each frame has its own slots and its own pixels of one scatter-min (the
    pixel index is offset by the frame), and everything else is
    elementwise, so a frame's result does not depend on the frames beside
    it.
    """
    F = faces.shape[0]
    if F >= 1 << 31:
        raise ValueError(f"{F} faces: face ids are int32")
    dev = proj.device
    B = proj.shape[0]
    faces = faces.long()
    fa, fb, fc = (proj[:, faces[:, k]] for k in range(3))    # [B,F,2]
    za, zb, zc = (z[:, faces[:, k]] for k in range(3))       # [B,F]

    in_front = (za > 1e-6) & (zb > 1e-6) & (zc > 1e-6)
    if face_valid is not None:
        in_front = in_front & face_valid

    xmin = torch.floor(torch.minimum(torch.minimum(fa[..., 0], fb[..., 0]),
                                     fc[..., 0]))
    xmax = torch.ceil(torch.maximum(torch.maximum(fa[..., 0], fb[..., 0]),
                                    fc[..., 0]))
    ymin = torch.floor(torch.minimum(torch.minimum(fa[..., 1], fb[..., 1]),
                                     fc[..., 1]))
    ymax = torch.ceil(torch.maximum(torch.maximum(fa[..., 1], fb[..., 1]),
                                    fc[..., 1]))
    x0 = torch.clamp(xmin, 0, width - 1).to(torch.int32)
    x1 = torch.clamp(xmax, 0, width - 1).to(torch.int32)
    y0 = torch.clamp(ymin, 0, height - 1).to(torch.int32)
    y1 = torch.clamp(ymax, 0, height - 1).to(torch.int32)
    offscreen = ((xmax < 0) | (xmin > width - 1) | (ymax < 0) |
                 (ymin > height - 1))
    ok = in_front & ~offscreen

    bw = torch.where(ok, x1 - x0 + 1, 0)
    bh = torch.where(ok, y1 - y0 + 1, 0)
    areas = (bw * bh).to(torch.int32)                       # [B,F]
    ends = torch.cumsum(areas, 1, dtype=torch.int32)        # inclusive scan
    starts = ends - areas
    total = ends[:, -1:]                                    # [B,1]
    n_dropped = torch.clamp(total[:, 0] - budget, min=0)

    # budget slot -> (face, dx, dy)
    s_idx = torch.arange(budget, dtype=torch.int32, device=dev)
    face_of = torch.searchsorted(ends, s_idx.expand(B, budget).contiguous(),
                                 right=True)
    face_of = torch.clamp(face_of, max=F - 1)               # [B,S]
    live = s_idx < total
    r = s_idx - _per_slot(starts, face_of)
    bw_f = torch.clamp(_per_slot(bw, face_of), min=1)
    dx = r % bw_f
    dy = r // bw_f
    px = _per_slot(x0, face_of) + dx
    py = _per_slot(y0, face_of) + dy

    w1, w2, w3 = _barycentric(
        px.to(proj.dtype), py.to(proj.dtype), _per_slot(fa, face_of),
        _per_slot(fb, face_of), _per_slot(fc, face_of))
    # count edge pixels on both sides (closer to the reference's
    # floor/ceil-expanded scanlines than a strict > 0)
    eps = -1e-6
    inside = (w1 >= eps) & (w2 >= eps) & (w3 >= eps) & live
    zi = (w1 * _per_slot(za, face_of) + w2 * _per_slot(zb, face_of) +
          w3 * _per_slot(zc, face_of))
    inside = inside & (zi > 0)
    # clip then truncate toward zero, as astype(int32) does
    zq = torch.clamp(zi / z_max * float(1 << Z_BITS), 1.0,
                     float((1 << Z_BITS) - 1)).to(torch.int32)
    packed, fid_bits = fragment_keys(zq, face_of, F)
    key_max = torch.iinfo(packed.dtype).max

    # one scatter-min for the batch: frame b owns pixels
    # [b * (HW + 1), (b + 1) * (HW + 1)), the last one for rejected slots
    HW = height * width
    flat_pix = torch.where(inside, py * width + px, HW).long() + (
        torch.arange(B, device=dev)[:, None] * (HW + 1))
    zbuf = torch.full((B * (HW + 1),), key_max, dtype=packed.dtype,
                      device=dev).scatter_reduce(
        0, flat_pix.reshape(-1), packed.reshape(-1), "amin",
        include_self=True).reshape(B, HW + 1)[:, :-1]

    hit = zbuf != key_max
    fid = torch.where(hit, zbuf & ((1 << fid_bits) - 1), -1).to(
        torch.int32).reshape(B, height, width)

    # post pass: exact interpolated depth and bary of the winning face
    yy = torch.arange(height, dtype=proj.dtype, device=dev)[:, None]
    xx = torch.arange(width, dtype=proj.dtype, device=dev)[None, :]
    f_safe = torch.clamp(fid, min=0).long()
    v1, v2, v3 = _barycentric(xx, yy, _per_slot(fa, f_safe),
                              _per_slot(fb, f_safe), _per_slot(fc, f_safe))
    depth = (v1 * _per_slot(za, f_safe) + v2 * _per_slot(zb, f_safe) +
             v3 * _per_slot(zc, f_safe))
    depth = torch.where(fid >= 0, torch.clamp(depth, 0.0, z_max), 0.0)
    bary = torch.stack([v1, v2, v3], dim=-1)
    bary = torch.where((fid >= 0)[..., None], bary, 0.0)
    return RasterOutput(fid=fid, depth=depth.to(proj.dtype), bary=bary,
                        n_dropped=n_dropped)


def rasterize(proj: torch.Tensor, z: torch.Tensor, faces: torch.Tensor,
              height: int, width: int, budget: int,
              z_max: float = Z_MAX_DEFAULT,
              face_valid: Optional[torch.Tensor] = None) -> RasterOutput:
    """``rasterize_batch`` for one pose: proj [P, 2], z [P], face_valid
    optional [F]; the result has no leading axis."""
    out = rasterize_batch(
        proj[None], z[None], faces, height, width, budget, z_max,
        None if face_valid is None else face_valid[None])
    return RasterOutput(*(x[0] for x in out))


def default_budget(height: int, width: int, n_faces: int) -> int:
    """Sample budget heuristic: bbox-area sum is ~4x the covered silhouette
    (front+back faces x bbox slack); a full-frame close-up is the worst
    case.  Capped below by 8 samples/face."""
    return max(height * width, 8 * n_faces)
