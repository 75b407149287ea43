"""SO(3) utilities (counterpart of ``avatar_tpu/core/rotation.py``).

Quaternions are (x, y, z, w), Eigen's ``coeffs()`` order.  Every function
takes leading batch dimensions.  Both branches of each ``torch.where`` are
evaluated, exactly as the reference's ``jnp.where``, so the small-angle
and near-pi switches pick the same formula on the same inputs.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product (hat) matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues)."""
    theta2 = torch.sum(v * v, dim=-1, keepdim=True)[..., None]   # [...,1,1]
    theta = torch.sqrt(theta2 + _EPS)
    K = skew(v)
    K2 = torch.matmul(K, K)
    use_taylor = theta2 < 1e-8
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    return _eye_like(K) + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3], angle in [0, pi].
    Safe near identity and near pi (same switches as the reference)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)
    small = theta < 1e-5
    near_pi = theta > math.pi - 0.05
    scale_generic = theta / torch.where(
        torch.abs(2.0 * sin_theta) < _EPS, torch.ones_like(sin_theta),
        2.0 * sin_theta)
    scale_small = 0.5 + theta * theta / 12.0
    scale = torch.where(small, scale_small, scale_generic)
    v_generic = vee * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS),
        min=0.0))
    k = torch.argmax(axis_abs, dim=-1)
    Rt = R + torch.swapaxes(R, -1, -2)
    idx = k[..., None, None].expand(*k.shape, 1, 3)
    rk = torch.gather(Rt, -2, idx)[..., 0, :]          # row k of R + R^T
    signs = torch.where(rk >= 0, 1.0, -1.0).to(R.dtype)
    sk = torch.gather(signs, -1, k[..., None])
    signs = signs * sk                                  # component k positive
    vee_norm = torch.linalg.norm(vee, dim=-1)
    theta_pi = math.pi - torch.arcsin(torch.clamp(vee_norm * 0.5, 0.0, 1.0))
    v_pi = axis_abs * signs * theta_pi[..., None]
    return torch.where(near_pi[..., None], v_pi, v_generic)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (x, y, z, w) -> rotation matrix [..., 3, 3];
    normalizes internally."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (x, y, z, w),
    branch-free Shepperd's method, w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1)
    qw = torch.clamp(qw, min=_EPS)
    t = torch.sqrt(qw)
    c0 = torch.stack([(m21 - m12), (m02 - m20), (m10 - m01), qw[..., 0]],
                     -1) / (2.0 * t[..., 0:1])
    c1 = torch.stack([qw[..., 1], (m01 + m10), (m02 + m20), (m21 - m12)],
                     -1) / (2.0 * t[..., 1:2])
    c2 = torch.stack([(m01 + m10), qw[..., 2], (m12 + m21), (m02 - m20)],
                     -1) / (2.0 * t[..., 2:3])
    c3 = torch.stack([(m02 + m20), (m12 + m21), qw[..., 3], (m10 - m01)],
                     -1) / (2.0 * t[..., 3:4])
    idx = torch.argmax(qw, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)      # [..., 4cand, 4comp]
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def so3_left_jacobian_inv(v: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3) at axis-angle v: [..., 3] ->
    [..., 3, 3]:  I - v^/2 + (1/t^2 - (1+cos t)/(2 t sin t)) v^ v^."""
    theta2 = torch.sum(v * v, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS)
    K = skew(v)
    K2 = torch.matmul(K, K)
    use_taylor = theta2 < 1e-8
    c_generic = 1.0 / theta2.clamp(min=_EPS) - (1.0 + torch.cos(theta)) / (
        2.0 * theta * torch.sin(theta) + _EPS)
    c = torch.where(use_taylor, 1.0 / 12.0 + theta2 / 720.0, c_generic)
    return _eye_like(K) - 0.5 * K + c * K2
