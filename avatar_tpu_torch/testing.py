"""Deterministic synthetic humanoid model (counterpart of
``avatar_tpu/testing.py``).

``synthetic_arrays`` and ``synthetic_pose_prior`` are pure numpy copies of
the reference's generators — the port cannot import the JAX package, and
``chip_smoke.py`` has to build the bench's detail-6 model (6624 vertices,
12420 faces) without JAX.  ``tests/test_torch_perception.py`` holds the
copies against the originals.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from avatar_tpu_torch.core.model import AvatarModel
from avatar_tpu_torch.core.pose_prior import GaussianMixture
from avatar_tpu_torch.device import get_device

# Rest-pose joint positions for an SMPL-like skeleton (meters, T-pose-ish,
# y up, pelvis at origin).  Indexed by SmplJoint ids.
_REST_JOINTS = np.array([
    [0.000, 0.000, 0.000],    # 0 pelvis
    [0.090, -0.085, 0.000],   # 1 l_hip
    [-0.090, -0.085, 0.000],  # 2 r_hip
    [0.000, 0.110, -0.010],   # 3 spine1
    [0.105, -0.480, 0.000],   # 4 l_knee
    [-0.105, -0.480, 0.000],  # 5 r_knee
    [0.000, 0.250, -0.015],   # 6 spine2
    [0.090, -0.870, -0.020],  # 7 l_ankle
    [-0.090, -0.870, -0.020], # 8 r_ankle
    [0.000, 0.310, -0.005],   # 9 spine3
    [0.110, -0.930, 0.110],   # 10 l_foot
    [-0.110, -0.930, 0.110],  # 11 r_foot
    [0.000, 0.450, -0.010],   # 12 neck
    [0.075, 0.390, -0.010],   # 13 l_collar
    [-0.075, 0.390, -0.010],  # 14 r_collar
    [0.000, 0.550, 0.010],    # 15 head
    [0.180, 0.410, -0.010],   # 16 l_shoulder
    [-0.180, 0.410, -0.010],  # 17 r_shoulder
    [0.440, 0.400, -0.010],   # 18 l_elbow
    [-0.440, 0.400, -0.010],  # 19 r_elbow
    [0.690, 0.395, -0.010],   # 20 l_wrist
    [-0.690, 0.395, -0.010],  # 21 r_wrist
    [0.780, 0.390, -0.010],   # 22 l_hand
    [-0.780, 0.390, -0.010],  # 23 r_hand
])

_PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                     16, 17, 18, 19, 20, 21], np.int32)

# Tube radius per bone (indexed by child joint id), meters.
_BONE_RADIUS = {
    1: 0.075, 2: 0.075, 3: 0.105, 4: 0.062, 5: 0.062, 6: 0.115, 7: 0.045,
    8: 0.045, 9: 0.110, 10: 0.040, 11: 0.040, 12: 0.048, 13: 0.070,
    14: 0.070, 15: 0.075, 16: 0.052, 17: 0.052, 18: 0.042, 19: 0.042,
    20: 0.034, 21: 0.034, 22: 0.030, 23: 0.030,
}


def _smoothstep(t):
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def synthetic_arrays(detail: int = 1, n_keys: int = 10, seed: int = 7) -> dict:
    """Build the raw model arrays.  detail=1 -> ~1.1k verts (tests);
    detail=3 -> ~6.6k verts (bench, SMPL-scale)."""
    rng = np.random.default_rng(seed)
    n_seg = 6 + 2 * detail          # vertices per ring
    n_rings = 4 + 2 * detail        # rings per bone
    J = 24
    joints = _REST_JOINTS.copy()

    verts = []
    weights = []
    faces = []

    for child in range(1, J):
        par = int(_PARENTS[child])
        a, b = joints[par], joints[child]
        axis = b - a
        length = np.linalg.norm(axis)
        if length < 1e-9:
            continue
        axis_n = axis / length
        # orthonormal frame
        up = np.array([0.0, 0.0, 1.0]) if abs(axis_n[2]) < 0.9 else np.array(
            [1.0, 0.0, 0.0])
        e1 = np.cross(axis_n, up)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(axis_n, e1)
        radius = _BONE_RADIUS[child]
        base = len(verts)
        for ri in range(n_rings):
            t = ri / (n_rings - 1.0)
            # taper the tube slightly toward the child end
            r = radius * (1.0 - 0.25 * t)
            center = a + axis * t
            for si in range(n_seg):
                ang = 2 * np.pi * si / n_seg
                pnt = center + r * (np.cos(ang) * e1 + np.sin(ang) * e2)
                verts.append(pnt)
                wrow = np.zeros(J)
                # blend parent-controlled bone toward child joint near its end
                s = _smoothstep((t - 0.55) / 0.45)
                wrow[par] = 1.0 - s
                wrow[child] = s
                weights.append(wrow)
        for ri in range(n_rings - 1):
            for si in range(n_seg):
                v00 = base + ri * n_seg + si
                v01 = base + ri * n_seg + (si + 1) % n_seg
                v10 = base + (ri + 1) * n_seg + si
                v11 = base + (ri + 1) * n_seg + (si + 1) % n_seg
                # winding chosen so face normals point outward (SMPL
                # convention; the optimizer's backface cull and the
                # renderer's Lambert visibility both assume it)
                faces.append([v00, v01, v10])
                faces.append([v01, v11, v10])

    verts = np.asarray(verts)
    weights = np.asarray(weights)
    faces = np.asarray(faces, np.int32)
    P = verts.shape[0]

    # Joint regressor: joints from nearby verts (inverse-distance over the
    # k closest vertices), normalized rows.
    joint_reg = np.zeros((J, P))
    for j in range(J):
        d = np.linalg.norm(verts - joints[j], axis=1)
        k = min(24, P)
        idx = np.argsort(d)[:k]
        wv = 1.0 / (d[idx] + 0.02)
        joint_reg[j, idx] = wv / wv.sum()
    # Correct the template so J_reg @ v_template == joints exactly:
    # add a rank-J correction spread over the regressor support.
    err = joints - joint_reg @ verts  # [J, 3]
    # lstsq correction: verts += joint_reg^T @ pinv(joint_reg joint_reg^T) err
    G = joint_reg @ joint_reg.T
    corr = joint_reg.T @ np.linalg.solve(G + 1e-9 * np.eye(J), err)
    verts = verts + corr

    # Shape keys: smooth low-frequency displacement fields.  Key 0 is a
    # global widen/scale direction (so shape optimization has signal).
    shapedirs = np.zeros((P, 3, n_keys))
    center = verts.mean(axis=0)
    shapedirs[:, :, 0] = (verts - center) * 0.031  # ~"PC1" overall size
    for k in range(1, n_keys):
        freq = rng.uniform(1.0, 3.0, size=(3, 3))
        phase = rng.uniform(0, 2 * np.pi, size=(3, 3))
        amp = rng.uniform(0.002, 0.01, size=(3,))
        field = np.zeros((P, 3))
        for c in range(3):
            field[:, c] = amp[c] * np.sin(verts @ freq[c] + phase[c, 0])
        shapedirs[:, :, k] = field

    return dict(v_template=verts, parent=_PARENTS.copy(), faces=faces,
                joint_reg=joint_reg, weights=weights, shapedirs=shapedirs,
                use_jsr=True)


def synthetic_pose_prior(n_joints: int = 24, n_comps: int = 4,
                         seed: int = 11, dtype=torch.float32,
                         device: str | torch.device = "cuda"
                         ) -> GaussianMixture:
    """GMM pose prior over (J-1)*3 axis-angle dims, centered near rest pose."""
    rng = np.random.default_rng(seed)
    D = (n_joints - 1) * 3
    weights = rng.uniform(0.5, 1.5, n_comps)
    weights /= weights.sum()
    means = rng.normal(0.0, 0.12, size=(n_comps, D))
    covs = np.zeros((n_comps, D, D))
    for c in range(n_comps):
        A = rng.normal(0.0, 0.05, size=(D, D))
        covs[c] = A @ A.T * 0.05 + np.eye(D) * 0.04
    return GaussianMixture(weights, means, covs, dtype, device)


def synthetic_model(detail: int = 1, n_keys: int = 10, seed: int = 7,
                    with_prior: bool = True, dtype=torch.float32,
                    device: str | torch.device = "cuda") -> AvatarModel:
    """The reference's ``synthetic_model`` with its tensors on ``device``."""
    arrays = synthetic_arrays(detail, n_keys, seed)
    prior = (synthetic_pose_prior(24, seed=seed + 1, dtype=dtype,
                                  device=device) if with_prior else None)
    return AvatarModel(arrays=arrays, pose_prior=prior, dtype=dtype,
                       device=device)


def synthetic_pose_sequence(path: str, n_frames: int = 64, n_joints: int = 24,
                            seed: int = 13) -> None:
    """Write a mocap-style .dat/.txt pose bank of smooth random poses."""
    from avatar_tpu_torch.core import rotation
    from avatar_tpu_torch.core.sequence import AvatarPoseSequence

    rng = np.random.default_rng(seed)
    # smooth trajectories: a random walk in axis-angle space
    aa = np.cumsum(rng.normal(0, 0.02, size=(n_frames, n_joints, 3)), axis=0)
    aa += rng.normal(0, 0.1, size=(1, n_joints, 3))
    aa[:, 0, :] = 0.0
    pos = np.cumsum(rng.normal(0, 0.01, size=(n_frames, 3)), axis=0)
    pos += np.array([0.0, 0.0, 2.8])
    # quaternions (x, y, z, w), in float32 as the reference computes them
    mats = rotation.so3_exp(torch.as_tensor(
        aa.reshape(-1, 3), dtype=torch.float32)).reshape(
        n_frames, n_joints, 3, 3)
    quats = rotation.mat_to_quat(mats).numpy()
    AvatarPoseSequence.write(path, pos, quats)


def write_synthetic_model_dir(out_dir: str, detail: int = 1, n_keys: int = 10,
                              seed: int = 7) -> str:
    """Materialize model.npz + pose_prior.txt in ``out_dir`` (the files
    ``AvatarModel(model_dir)`` loads)."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = synthetic_arrays(detail, n_keys, seed)
    J = arrays["parent"].shape[0]
    kintree = np.stack([
        np.where(arrays["parent"] < 0, np.uint32(0xFFFFFFFF),
                 arrays["parent"].astype(np.uint32)),
        np.arange(J, dtype=np.uint32),
    ])
    np.savez(
        os.path.join(out_dir, "model.npz"),
        v_template=arrays["v_template"],
        kintree_table=kintree,
        f=arrays["faces"].astype(np.uint32),
        J_regressor=arrays["joint_reg"],
        weights=arrays["weights"],
        shapedirs=arrays["shapedirs"],
    )
    synthetic_pose_prior(J, seed=seed + 1, device="cpu").save(
        os.path.join(out_dir, "pose_prior.txt"))
    return out_dir


def synthetic_nn_inputs(n_rows: int, detail: int = 6, n_wild: int = 992,
                        frac_labelled: float = 0.5, seed: int = 0,
                        device: str | torch.device = "cuda"):
    """Arguments of ``nn_kernel.nn_argmin_ranges`` at the fit's shapes.

    The model axis is the synthetic model's rest vertices (detail 6: 6624,
    padded to 6656), sorted by their 14 matching groups, 70% visible.  Of
    the ``n_rows`` data rows, ``n_wild`` are wildcards (label 14),
    ``frac_labelled`` of the rest are vertices plus 5 mm noise with their
    group label, and the remainder is padding (label -1).  Returns
    (data_pts, data_part, model_pts, model_part, model_valid, cstart,
    cend) on ``device``, sorted and planned as the fit plans them.
    """
    from avatar_tpu_torch.optim.correspond import make_nn_plan
    from avatar_tpu_torch.perception.partgroups import (SMPL24_GROUP_LUT,
                                                        SMPL24_NUM_GROUPS)

    device = get_device(device)
    rng = np.random.default_rng(seed)
    arrays = synthetic_arrays(detail)
    verts = arrays["v_template"]
    part = SMPL24_GROUP_LUT[np.argmax(arrays["weights"], axis=1)]
    order = np.argsort(part, kind="stable")
    verts = (verts[order] - verts.mean(0)).astype(np.float32)
    part = part[order].astype(np.int32)
    P = verts.shape[0]
    Pp = -(-P // 512) * 512
    model_pts = np.zeros((Pp, 3), np.float32)
    model_pts[:P] = verts
    valid = np.zeros(Pp, bool)
    valid[:P] = rng.random(P) < 0.7

    n_lab = int((n_rows - n_wild) * frac_labelled)
    pick = rng.integers(0, P, n_lab + n_wild)
    data = np.zeros((n_rows, 3), np.float32)
    data[:n_lab + n_wild] = verts[pick] + rng.normal(
        0, 0.005, (n_lab + n_wild, 3))
    dpart = np.full(n_rows, -1, np.int32)
    dpart[:n_lab] = part[pick[:n_lab]]
    dpart[n_lab:n_lab + n_wild] = SMPL24_NUM_GROUPS
    t = lambda a: torch.as_tensor(a, device=device)
    plan = make_nn_plan(t(data), t(dpart), t(part),
                        num_parts=SMPL24_NUM_GROUPS, model_sorted=True)
    return (plan.dpts.contiguous(), plan.dpart.contiguous(), t(model_pts),
            plan.mpart_s.contiguous(), t(valid), plan.cstart, plan.cend)


def synthetic_nn_stats_inputs(n_rows: int, detail: int = 6,
                              n_wild: int = 992, seed: int = 0,
                              device: str | torch.device = "cuda"):
    """Arguments of ``correspond.find_nn_stats`` at the host tracker's
    shapes: the synthetic model's rest vertices (detail 6: 6624, unsorted)
    with their 14 matching groups, 70% visible, and ``n_rows`` unsorted
    data rows: vertices plus 5 mm noise with their group, ``n_wild``
    wildcards (label 14), a quarter padding (label -1).  Returns
    (data_pts, data_part, model_cloud, model_part, visible) on ``device``.
    """
    from avatar_tpu_torch.perception.partgroups import (SMPL24_GROUP_LUT,
                                                        SMPL24_NUM_GROUPS)

    device = get_device(device)
    rng = np.random.default_rng(seed)
    arrays = synthetic_arrays(detail)
    verts = arrays["v_template"].astype(np.float32)
    part = SMPL24_GROUP_LUT[np.argmax(arrays["weights"], axis=1)]
    pick = rng.integers(0, verts.shape[0], n_rows)
    data = verts[pick] + rng.normal(0, 0.005, (n_rows, 3)).astype(np.float32)
    dpart = part[pick].astype(np.int32)
    dpart[rng.permutation(n_rows)[:n_wild]] = SMPL24_NUM_GROUPS
    dpart[rng.random(n_rows) < 0.25] = -1
    visible = rng.random(verts.shape[0]) < 0.7
    return tuple(torch.as_tensor(a, device=device) for a in (
        data, dpart, verts, part.astype(np.int32), visible))


def probe_samples(depth_mm: np.ndarray, mask: np.ndarray, intrin,
                  stride: int, glut=None):
    """The samples of bench.py's ``fit_rmse_mm`` probe: the oracle-labelled
    pixels of one frame at ``stride`` (uint16 mm depth, part mask with 255
    for background) back-projected with the renderer's y-flip, labels
    folded through ``glut`` (part -> group) when given, padded to a power
    of two >= 1024 with label -1.  Returns (pts [B,3] f32, parts [B] i32).
    """
    d0 = depth_mm[::stride, ::stride].astype(np.float32) * 1e-3
    m0 = np.asarray(mask)[::stride, ::stride]
    ys = np.arange(d0.shape[0]) * stride
    xs = np.arange(d0.shape[1]) * stride
    sub = np.stack([(xs[None, :] - intrin.cx) * d0 / intrin.fx,
                    -(ys[:, None] - intrin.cy) * d0 / intrin.fy, d0], -1)
    fgm = (m0 != 255) & (d0 > 0)
    n0 = int(fgm.sum())
    b0 = 1024
    while b0 < n0:
        b0 *= 2
    pts = np.zeros((b0, 3), np.float32)
    pts[:n0] = sub[fgm]
    parts = np.full(b0, -1, np.int32)
    parts[:n0] = m0[fgm] if glut is None else np.asarray(glut)[m0[fgm]]
    return pts, parts
