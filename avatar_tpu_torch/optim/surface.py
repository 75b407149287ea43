"""Point-to-mesh (triangle) correspondence for the high-exactness fit
(counterpart of ``avatar_tpu/optim/surface.py``).

After the vertex NN, each data point is matched to the closest point over
its NN vertex's one-ring faces, in closed form (branch-free Voronoi-region
classification over [N, R] candidate triangles).  The matched surface
point sum_i b_i x_{v_i} is the point a depth camera measured when the pose
is right, so ``gauss_newton.fit_refine`` converges to the sensor's
quantization floor instead of the vertex-spacing floor of ``fit``.
"""

from __future__ import annotations

import numpy as np
import torch


def vertex_face_rings(faces: np.ndarray, num_verts: int,
                      max_ring: int = 12) -> np.ndarray:
    """[P, max_ring] int32: face ids incident to each vertex, -1 padded.

    Host-side precompute (once per model), a copy of the reference's.
    Vertices with more than ``max_ring`` incident faces keep the first
    ``max_ring`` in face order.
    """
    faces = np.asarray(faces)
    ring = np.full((num_verts, max_ring), -1, np.int32)
    fill = np.zeros(num_verts, np.int32)
    for f, (a, b, c) in enumerate(faces):
        for v in (a, b, c):
            k = fill[v]
            if k < max_ring:
                ring[v, k] = f
                fill[v] = k + 1
    return ring


def closest_point_triangle(p: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, c: torch.Tensor):
    """Closest point on triangle(s) abc to point(s) p, branch-free.

    All inputs broadcastable [..., 3].  Returns (bary [..., 3], d2 [...]).
    Voronoi regions after Ericson, 'Real-Time Collision Detection'
    §5.1.5, as a where-cascade in the reference's priority order.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = torch.sum(ab * ap, -1)
    d2_ = torch.sum(ac * ap, -1)
    bp = p - b
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    cp = p - c
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2_ - d1 * d6
    vc = d1 * d4 - d3 * d2_

    eps = 1e-30

    def guard(den):
        return torch.where(torch.abs(den) < eps, 1.0, den)

    # edge parameters (guarded divisions; the region masks decide)
    v_ab = d1 / guard(d1 - d3)
    w_ac = d2_ / guard(d2_ - d6)
    w_bc = (d4 - d3) / guard((d4 - d3) + (d5 - d6))
    denom = guard(va + vb + vc)
    v_in = vb / denom
    w_in = vc / denom

    # region masks, in priority order (the last where applied wins)
    m_a = (d1 <= 0) & (d2_ <= 0)
    m_b = (d3 >= 0) & (d4 <= d3)
    m_c = (d6 >= 0) & (d5 <= d6)
    m_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    m_ac = (vb <= 0) & (d2_ >= 0) & (d6 <= 0)
    m_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    sel = torch.where
    u = 1.0 - v_in - w_in
    v = v_in
    w = w_in
    u, v, w = sel(m_bc, 0.0, u), sel(m_bc, 1.0 - w_bc, v), sel(m_bc, w_bc, w)
    u, v, w = sel(m_ac, 1.0 - w_ac, u), sel(m_ac, 0.0, v), sel(m_ac, w_ac, w)
    u, v, w = sel(m_ab, 1.0 - v_ab, u), sel(m_ab, v_ab, v), sel(m_ab, 0.0, w)
    u, v, w = sel(m_c, 0.0, u), sel(m_c, 0.0, v), sel(m_c, 1.0, w)
    u, v, w = sel(m_b, 0.0, u), sel(m_b, 1.0, v), sel(m_b, 0.0, w)
    u, v, w = sel(m_a, 1.0, u), sel(m_a, 0.0, v), sel(m_a, 0.0, w)

    bary = torch.stack([u, v, w], dim=-1)
    cp_pt = u[..., None] * a + v[..., None] * b + w[..., None] * c
    diff = p - cp_pt
    return bary, torch.sum(diff * diff, -1)


def surface_correspond(data_pts: torch.Tensor, corr_vertex: torch.Tensor,
                       x: torch.Tensor, faces: torch.Tensor,
                       ring_faces: torch.Tensor, front_margin=None):
    """Refine a vertex NN into the closest point on its one-ring surface.

    data_pts [N, 3]; corr_vertex [N] NN model vertex (< 0 unmatched);
    x [P, 3] posed vertices; faces [F, 3]; ring_faces [P, R] (-1 padded).
    With ``front_margin`` set, candidate faces must face the camera:
    normal z < margin * |normal|.

    Returns (tri_idx [N, 3] vertex ids, bary [N, 3], unit face normal
    [N, 3], valid [N] bool).  Unmatched rows carry arbitrary geometry;
    callers mask by ``valid``.  The per-face corners are packed into [F, 9]
    rows so each candidate is one gather, as in the reference.
    """
    faces = faces.long()
    cid = torch.clamp(corr_vertex, min=0).long()
    rf = ring_faces[cid]                                   # [N, R]
    has = rf >= 0
    rfc = torch.clamp(rf, min=0).long()
    xf9 = torch.cat([x[faces[:, 0]], x[faces[:, 1]], x[faces[:, 2]]],
                    dim=1)                                 # [F, 9]
    tri9 = xf9[rfc]                                        # [N, R, 9]
    a = tri9[..., 0:3]
    b = tri9[..., 3:6]
    c = tri9[..., 6:9]
    bary, d2 = closest_point_triangle(data_pts[:, None, :], a, b, c)
    if front_margin is not None:
        fn_all = torch.linalg.cross(b - a, c - a)          # [N, R, 3]
        has = has & (fn_all[..., 2] < front_margin * torch.linalg.norm(
            fn_all, dim=-1).clamp(min=1e-12))
    d2 = torch.where(has, d2, 3e38)
    best = torch.argmin(d2, dim=1)                         # first on ties
    n_ = torch.arange(data_pts.shape[0], device=data_pts.device)
    best_face = rfc[n_, best]
    tri_idx = faces[best_face]                             # [N, 3]
    bary_b = bary[n_, best]
    fn = torch.linalg.cross(b[n_, best] - a[n_, best],
                            c[n_, best] - a[n_, best])
    fn = fn / torch.linalg.norm(fn, dim=-1, keepdim=True).clamp(min=1e-12)
    valid = (corr_vertex >= 0) & torch.any(has, dim=1)
    return tri_idx, bary_b, fn, valid
