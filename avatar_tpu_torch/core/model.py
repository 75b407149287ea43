"""SMPL-family body model data and the avatar's pose/shape state
(counterpart of ``avatar_tpu/core/model.py``).

``AvatarModel`` is loaded on the host with numpy (float64 masters, from
``model.npz`` or from in-memory arrays) and exposed to the tensor code as
an :class:`LBSParams` of torch tensors on ``device``, plus static metadata
(``parents`` tuple, ``faces``).  ``Avatar`` is the host-side state (API
parity with the C++ class: update / randomize / smplParams / pdf /
alignToJoints); its LBS runs on the model's device.  A model directory
holds ``model.npz`` or the legacy text format (``model.pcd`` +
``skeleton.txt``), and ``pose_prior.txt`` beside either.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.core.lbs import LBSParams, lbs
from avatar_tpu_torch.core.pose_prior import GaussianMixture
from avatar_tpu_torch.device import get_device
from avatar_tpu_torch.profiling import host_read, to_device
from avatar_tpu_torch.utils import resolve_root_path


class SmplJoint:
    """SMPL joint ids in BFS order (reference Avatar.h:27-59)."""

    ROOT_PELVIS = 0
    L_HIP = 1
    R_HIP = 2
    SPINE1 = 3
    L_KNEE = 4
    R_KNEE = 5
    SPINE2 = 6
    L_ANKLE = 7
    R_ANKLE = 8
    SPINE3 = 9
    L_FOOT = 10
    R_FOOT = 11
    NECK = 12
    L_COLLAR = 13
    R_COLLAR = 14
    HEAD = 15
    L_SHOULDER = 16
    R_SHOULDER = 17
    L_ELBOW = 18
    R_ELBOW = 19
    L_WRIST = 20
    R_WRIST = 21
    L_HAND = 22
    R_HAND = 23
    COUNT = 24

    NAMES = [
        "PELVIS", "L_HIP", "R_HIP", "SPINE1", "L_KNEE", "R_KNEE", "SPINE2",
        "L_ANKLE", "R_ANKLE", "SPINE3", "L_FOOT", "R_FOOT", "NECK", "L_COLLAR",
        "R_COLLAR", "HEAD", "L_SHOULDER", "R_SHOULDER", "L_ELBOW", "R_ELBOW",
        "L_WRIST", "R_WRIST", "L_HAND", "R_HAND",
    ]


class AvatarModel:
    """Attributes (numpy float64 masters; torch mirrors in ``.params``):
    v_template [P,3], shapedirs [P,3,K], weights_np [P,J], joint_reg_np
    [J,P], parent [J] (parent[0] == -1), faces [F,3], joint_shape_reg_base
    [J,3], joint_shape_reg [J,3,K], initial_joint_pos [J,3], main_joint
    [P], ancestor_mask [J,J], pose_prior (GaussianMixture or None)."""

    def __init__(self, model_dir: str = "", dtype=torch.float32,
                 device: str | torch.device = "cuda", *,
                 arrays: Optional[dict] = None,
                 pose_prior: Optional[GaussianMixture] = None,
                 limit_one_joint_per_point: bool = False):
        self.device = get_device(device)
        if arrays is None:
            model_dir = model_dir or resolve_root_path("data/avatar-model")
            arrays = _load_model_dir(model_dir, limit_one_joint_per_point)
            pose_prior = GaussianMixture.load(
                os.path.join(model_dir, "pose_prior.txt"), dtype, self.device)
        self.model_dir = model_dir
        self.dtype = dtype
        self.pose_prior = pose_prior

        self.v_template = np.asarray(arrays["v_template"], np.float64)
        self.shapedirs = np.asarray(arrays["shapedirs"], np.float64)
        self.weights_np = np.asarray(arrays["weights"], np.float64)
        self.joint_reg_np = np.asarray(arrays["joint_reg"], np.float64)
        self.parent = np.asarray(arrays["parent"], np.int32)
        self.faces = np.asarray(arrays["faces"], np.int32)
        self.use_joint_shape_regressor = bool(arrays.get("use_jsr", True))

        J = self.parent.shape[0]
        if "joint_shape_reg_base" in arrays:
            self.joint_shape_reg_base = np.asarray(
                arrays["joint_shape_reg_base"], np.float64)
            self.joint_shape_reg = np.asarray(arrays["joint_shape_reg"],
                                              np.float64)
        else:
            # J(w) = Jreg v_template + (Jreg shapedirs) w
            # (reference AvatarModel.cpp:111-127)
            self.joint_shape_reg_base = self.joint_reg_np @ self.v_template
            self.joint_shape_reg = np.einsum(
                "jp,pck->jck", self.joint_reg_np, self.shapedirs)
        self.initial_joint_pos = self.joint_shape_reg_base.copy()

        # main assigned joint per point: the model part labels
        # (reference AvatarOptimizer.cpp:1227-1243)
        self.main_joint = np.argmax(self.weights_np, axis=1).astype(np.int32)
        if limit_one_joint_per_point and "joint_shape_reg_base" not in arrays:
            w1 = np.zeros_like(self.weights_np)
            w1[np.arange(len(w1)), self.main_joint] = 1.0
            self.weights_np = w1

        # anc[j, k] = 1 iff j is on the path from k to the root
        anc = np.zeros((J, J), np.float64)
        for k in range(J):
            a = k
            while a != -1:
                anc[a, k] = 1.0
                a = self.parent[a]
        self.ancestor_mask = anc

        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.params = LBSParams(
            v_template=t(self.v_template), shapedirs=t(self.shapedirs),
            weights=t(self.weights_np), joint_reg=t(self.joint_reg_np),
            joint_shape_reg_base=t(self.joint_shape_reg_base),
            joint_shape_reg=t(self.joint_shape_reg))
        self.parents: Tuple[int, ...] = tuple(int(x) for x in self.parent)

    def num_joints(self) -> int:
        return int(self.parent.shape[0])

    def num_points(self) -> int:
        return int(self.v_template.shape[0])

    def num_shape_keys(self) -> int:
        return int(self.shapedirs.shape[2])

    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def has_mesh(self) -> bool:
        return self.num_faces() > 0

    def has_pose_prior(self) -> bool:
        return self.pose_prior is not None


def _load_model_dir(model_path: str,
                    limit_one_joint_per_point: bool = False) -> dict:
    npz_path = os.path.join(model_path, "model.npz")
    if os.path.exists(npz_path):
        return _load_npz(npz_path)
    if not os.path.exists(os.path.join(model_path, "model.pcd")):
        raise FileNotFoundError(
            f"no avatar model found at {model_path!r}: expected model.npz "
            "(SMPL npz format) or model.pcd + skeleton.txt (legacy format)")
    return _load_legacy(model_path, limit_one_joint_per_point)


# SMPL-X (Pavlakos et al., CVPR 2019): 55 joints; ``shapedirs`` holds 300
# shape then 100 expression directions (v1.1) or 10 then 10 (v1.0), of
# which the ``smplx`` layer takes its defaults, 10 shape and 10 expression
SMPLX_NUM_JOINTS = 55
_SMPLX_EXPRESSION_START = {400: 300, 20: 10}
_SMPLX_NUM_BETAS = 10
_SMPLX_NUM_EXPRESSION = 10


def smplx_shape_columns(n_columns: int) -> np.ndarray:
    """The columns of an SMPL-X ``shapedirs`` of ``n_columns`` (400 or 20)
    that the ``smplx`` layer takes by default: the first 10 shape columns,
    then 10 expression columns from 300 (400 columns) or from 10 (20
    columns)."""
    start = _SMPLX_EXPRESSION_START[n_columns]
    return np.r_[np.arange(_SMPLX_NUM_BETAS),
                 start + np.arange(_SMPLX_NUM_EXPRESSION)]


def _load_npz(npz_path: str) -> dict:
    """Load the SMPL ``model.npz``: v_template [N,3], kintree_table [2,J],
    f [F,3], J_regressor [J,N], weights [N,J], shapedirs [N,3,K].  An
    SMPL-X file (55 joints, ``shapedirs`` of 400 or 20 columns) keeps the
    shape and expression columns ``smplx_shape_columns`` names, as shape
    keys; its pose correctives, hand PCA, landmarks and texture
    coordinates are not read."""
    with np.load(npz_path, allow_pickle=False) as npz:
        kintree = np.asarray(npz["kintree_table"])
        parent = kintree[0].astype(np.int64)
        # SMPL stores parent[0] as 2^32-1 / -1
        parent = np.where(parent > kintree.shape[1], -1, parent).astype(
            np.int32)
        parent[0] = -1
        shapedirs = np.asarray(npz["shapedirs"], np.float64)
        if kintree.shape[1] == SMPLX_NUM_JOINTS and shapedirs.ndim == 3 \
                and shapedirs.shape[2] in _SMPLX_EXPRESSION_START:
            shapedirs = shapedirs[:, :, smplx_shape_columns(
                shapedirs.shape[2])]
        return dict(v_template=np.asarray(npz["v_template"], np.float64),
                    parent=parent, faces=np.asarray(npz["f"], np.int32),
                    joint_reg=np.asarray(npz["J_regressor"], np.float64),
                    weights=np.asarray(npz["weights"], np.float64),
                    shapedirs=shapedirs, use_jsr=True)


def _read_ascii_pcd(path: str) -> np.ndarray:
    """Read an ascii PCD into a flat [3N] vector (AvatarHelpers.cpp:13-52)."""
    with open(path, "r") as f:
        n_points = -1
        for line in f:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "WIDTH":
                n_points = int(toks[1])
            elif toks[0] == "DATA":
                if toks[1] != "ascii":
                    raise ValueError(f"non-ascii PCD not supported: {path}")
                break
        vals = np.fromstring(f.read(), sep=" ", dtype=np.float64)  # noqa: NPY201
    if n_points < 0:
        raise ValueError(f"invalid PCD (no WIDTH): {path}")
    return vals[: n_points * 3]


def _load_legacy(model_path: str, limit_one_joint_per_point: bool) -> dict:
    """Legacy ad-hoc model format (reference AvatarModel.cpp:128-288):
    model.pcd + skeleton.txt + shapekey/ dir + joint[_shape]_regressor.txt +
    mesh.txt."""
    base = _read_ascii_pcd(os.path.join(model_path, "model.pcd"))
    v_template = base.reshape(-1, 3)

    with open(os.path.join(model_path, "skeleton.txt"), "r") as f:
        toks = f.read().split()
    pos = 0

    def nxt():
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    n_joints, n_points = int(nxt()), int(nxt())
    parent = np.zeros(n_joints, np.int32)
    joint_pos = np.zeros((n_joints, 3), np.float64)
    for _ in range(n_joints):
        jid = int(nxt())
        parent[jid] = int(nxt())
        nxt()  # name
        joint_pos[jid] = [float(nxt()) for _ in range(3)]
    parent[0] = -1

    weights = np.zeros((n_points, n_joints), np.float64)
    for i in range(n_points):
        n_ent = int(nxt())
        for _ in range(n_ent):
            j = int(nxt())
            wv = float(nxt())
            weights[i, j] = wv
    if limit_one_joint_per_point:
        mj = np.argmax(weights, axis=1)
        weights = np.zeros_like(weights)
        weights[np.arange(n_points), mj] = 1.0

    # Shape keys
    key_dir = os.path.join(model_path, "shapekey")
    shapedirs = np.zeros((n_points, 3, 0), np.float64)
    if os.path.isdir(key_dir):
        names = sorted(os.listdir(key_dir))
        cols = [_read_ascii_pcd(os.path.join(key_dir, n)).reshape(-1, 3)
                for n in names]
        if cols:
            shapedirs = np.stack(cols, axis=-1)

    out = dict(v_template=v_template, parent=parent, weights=weights,
               shapedirs=shapedirs)

    jsr_path = os.path.join(model_path, "joint_shape_regressor.txt")
    jr_path = os.path.join(model_path, "joint_regressor.txt")
    if os.path.exists(jsr_path):
        with open(jsr_path) as f:
            t = f.read().split()
        q = 0
        n_keys = int(t[q]); q += 1
        base_v = np.array([float(x) for x in t[q:q + n_joints * 3]]); q += n_joints * 3
        mat = np.array([float(x) for x in t[q:q + n_joints * 3 * n_keys]]).reshape(
            n_joints * 3, n_keys)
        # stored row-major as (3*J, K) with xyz interleaved per joint
        out["joint_shape_reg_base"] = base_v.reshape(n_joints, 3)
        out["joint_shape_reg"] = mat.reshape(n_joints, 3, n_keys)
        out["joint_reg"] = np.zeros((n_joints, n_points), np.float64)
        out["use_jsr"] = True
    elif os.path.exists(jr_path):
        joint_reg = np.zeros((n_joints, n_points), np.float64)
        with open(jr_path) as f:
            t = f.read().split()
        q = 0
        nj = int(t[q]); q += 1
        for j in range(nj):
            n_ent = int(t[q]); q += 1
            for _ in range(n_ent):
                pi = int(t[q]); val = float(t[q + 1]); q += 2
                joint_reg[j, pi] = val
        out["joint_reg"] = joint_reg
        out["use_jsr"] = False
    else:
        out["joint_reg"] = np.zeros((n_joints, n_points), np.float64)
        out["use_jsr"] = True
        out["joint_shape_reg_base"] = joint_pos
        out["joint_shape_reg"] = np.zeros((n_joints, 3, shapedirs.shape[2]))

    mesh_path = os.path.join(model_path, "mesh.txt")
    if os.path.exists(mesh_path):
        with open(mesh_path) as f:
            t = f.read().split()
        n_faces = int(t[0])
        faces = np.array([int(x) for x in t[1:1 + n_faces * 3]],
                         np.int32).reshape(n_faces, 3)
    else:
        faces = np.zeros((0, 3), np.int32)
    out["faces"] = faces
    return out


def _rot_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking direction a to direction b
    (Eigen Quaterniond::FromTwoVectors equivalent)."""
    a = a / (np.linalg.norm(a) + 1e-12)
    b = b / (np.linalg.norm(b) + 1e-12)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1.0 + 1e-9:
        # opposite: rotate pi about any orthogonal axis
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return np.eye(3) + 2.0 * K @ K
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K / (1.0 + c)


def _so3_exp_f32(aa: np.ndarray) -> np.ndarray:
    """Rodrigues in float32, as the reference evaluates its host draws
    (``jnp.asarray`` of a float64 array is float32 there)."""
    return rotation.so3_exp(torch.as_tensor(
        np.asarray(aa), dtype=torch.float32)).numpy()


class Avatar:
    """Pose/shape state of one avatar instance (reference Avatar,
    Avatar.h:155).

    State: ``w`` [K] shape weights, ``p`` [3] root position, ``r``
    [J,3,3] local joint rotations (numpy float64 on the host).
    ``update()`` runs LBS on the model's device and fills ``cloud`` [P,3],
    ``joint_pos`` [J,3] and ``joint_rot_global`` [J,3,3] (numpy).
    """

    def __init__(self, model: AvatarModel):
        self.model = model
        self.w = np.zeros(model.num_shape_keys())
        self.p = np.zeros(3)
        self.r = np.tile(np.eye(3), (model.num_joints(), 1, 1))
        self.cloud: Optional[np.ndarray] = None
        self.joint_pos: Optional[np.ndarray] = None
        self.joint_rot_global: Optional[np.ndarray] = None

    def _tensor(self, a) -> torch.Tensor:
        return to_device(np.asarray(a), self.model.device, self.model.dtype)

    def update(self) -> None:
        """LBS forward pass (reference Avatar.cpp:22-75); its copies are
        counted reads (``profiling``)."""
        m = self.model
        cloud, tg, Rg, _ = lbs(m.params, m.parents, self._tensor(self.w),
                               self._tensor(self.p), self._tensor(self.r),
                               use_jsr=m.use_joint_shape_regressor)
        self.cloud = host_read(cloud)
        self.joint_pos = host_read(tg)
        self.joint_rot_global = host_read(Rg)

    def smpl_params(self) -> np.ndarray:
        """Axis-angle export of the non-root rotations (Avatar.cpp:128-137)."""
        aa = rotation.so3_log(self._tensor(self.r[1:]))
        return aa.cpu().numpy().astype(np.float64).reshape(-1)

    smplParams = smpl_params

    def pdf(self) -> float:
        """GMM likelihood of the current pose (Avatar.cpp:139)."""
        prior = self.model.pose_prior
        if prior is None:
            raise ValueError("model has no pose prior")
        x = torch.as_tensor(self.smpl_params(), dtype=prior.means.dtype,
                            device=prior.means.device)
        return float(prior.pdf(x))

    def randomize(self, randomize_pose: bool = True,
                  randomize_shape: bool = True,
                  randomize_root_pos_rot: bool = True,
                  rng: Optional[np.random.Generator] = None,
                  seed: Optional[int] = None) -> None:
        """Random pose (GMM sample), shape (N(0,1)), root box + facing
        rotation; reference Avatar.cpp:77-126.  Draws from ``rng`` in the
        reference's order, so a seed gives the reference's avatar."""
        if rng is None:
            rng = np.random.default_rng(seed)
        model = self.model
        if randomize_shape:
            self.w = rng.standard_normal(model.num_shape_keys())
        if randomize_pose and model.pose_prior is not None:
            gm = model.pose_prior._np
            comp = rng.choice(gm["weights"].shape[0],
                              p=gm["weights"] / gm["weights"].sum())
            z = rng.standard_normal(gm["means"].shape[1])
            samp = gm["means"][comp] + gm["cov_cho"][comp] @ z
            aa = samp.reshape(-1, 3)
            self.r[1:1 + aa.shape[0]] = _so3_exp_f32(aa)
        if randomize_root_pos_rot:
            self.p = np.array([
                rng.uniform(-1.0, 1.0),
                rng.uniform(-0.5, 0.5),
                rng.uniform(2.2, 4.5),
            ])
            angle_up = rng.uniform(-np.pi / 3, np.pi / 3) + np.pi
            theta = rng.uniform(0, 2 * np.pi)
            phi = rng.uniform(-np.pi / 2, np.pi / 2)
            axis_perturb = np.array([
                np.sin(phi) * np.cos(theta), np.cos(phi),
                np.sin(phi) * np.sin(theta),
            ])
            angle_perturb = rng.normal(0.0, 0.2)
            up = _so3_exp_f32([0.0, angle_up, 0.0])
            pert = _so3_exp_f32(axis_perturb * angle_perturb)
            self.r[0] = pert @ up

    def random_mocap_pose(self, pose_seq=None,
                          rng: Optional[np.random.Generator] = None) -> None:
        """Pose from a random mocap-bank frame (reference
        Avatar::randomMocapPose; needs the avatar-mocap data bank)."""
        from avatar_tpu_torch.core.sequence import AvatarPoseSequence

        if pose_seq is None:
            pose_seq = AvatarPoseSequence()
        if pose_seq.num_frames == 0:
            raise FileNotFoundError(
                "no mocap bank available (data/avatar-mocap/cmu-mocap.dat)")
        rng = rng or np.random.default_rng()
        pose_seq.pose_avatar(self, int(rng.integers(pose_seq.num_frames)))

    randomMocapPose = random_mocap_pose

    def align_to_joints(self, pos: np.ndarray) -> None:
        """Heuristic pose fit so joints roughly match ``pos`` [J,3]
        (reference Avatar.cpp:141-193)."""
        model = self.model
        init = model.initial_joint_pos
        J = model.num_joints()
        assert pos.shape[0] == J
        vr = init[SmplJoint.SPINE1] - init[SmplJoint.ROOT_PELVIS]
        vrt = pos[SmplJoint.SPINE1] - pos[SmplJoint.ROOT_PELVIS]
        if not np.isnan(pos[0, 0]):
            self.p = pos[0].copy()
        if not (np.isnan(vr[0]) or np.isnan(vrt[0])):
            self.r[0] = _rot_between(vr, vrt)
        else:
            self.r[0] = np.eye(3)

        rot_trans = np.zeros((J, 3, 3))
        rot_trans[0] = self.r[0]
        scale_avg = 0.0
        for i in range(1, J):
            pi = model.parent[i]
            scale_avg += (np.linalg.norm(pos[i] - pos[pi]) /
                          (np.linalg.norm(init[i] - init[pi]) + 1e-12))
        scale_avg /= J - 1.0
        base_scale = np.linalg.norm(
            init[SmplJoint.SPINE2] - init[SmplJoint.ROOT_PELVIS]) * (
            scale_avg - 1.0)
        PC1_DIST_FACT = 32.0
        self.w[0] = base_scale * PC1_DIST_FACT
        if np.isnan(self.w[0]):
            self.w[0] = 1.5
        for i in range(1, J):
            pi = model.parent[i]
            rot_trans[i] = rot_trans[pi]
            if not np.isnan(pos[i, 0]):
                vv = init[i] - init[pi]
                vvt = pos[i] - pos[pi]
                rot_trans[i] = _rot_between(vv, vvt)
                self.r[i] = rot_trans[pi].T @ rot_trans[i]
            else:
                self.r[i] = np.eye(3)

    alignToJoints = align_to_joints
