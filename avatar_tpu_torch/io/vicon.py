"""ASF/AMC (Acclaim / CMU mocap) skeleton and motion loader (a numpy copy
of ``avatar_tpu/io/vicon.py``, held against it by
``tests/test_torch_vicon.py``).

Rebuild of reference ViconSkeleton (ViconSkeleton.h/.cpp — excluded from the
reference's own build, CMakeLists.txt:183,198; provided here for raw CMU
mocap ingestion, e.g. to build ``cmu-mocap.dat`` pose banks).

Assumptions match the reference's (satisfied by CMU data): angles in
degrees, rotation order XYZ, AMC in fully-specified mode.

Typical use: parse an .asf skeleton + .amc motion, pose frames, and map the
Acclaim joints onto SMPL joint positions (``smpl_joints``) for
Avatar.align_to_joints, or convert a whole motion to an
AvatarPoseSequence-style bank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def _rot_xyz(rx, ry, rz):
    """Rotation matrix for XYZ-order Euler angles in radians (R = Rz Ry Rx)."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclasses.dataclass
class Bone:
    name: str
    direction: np.ndarray          # unit, global rest direction
    length: float
    axis: np.ndarray               # C matrix (local axis frame)
    axis_inv: np.ndarray
    dof: List[str]                 # subset of rx, ry, rz
    parent: Optional[str] = None
    children: List[str] = dataclasses.field(default_factory=list)


class ViconSkeleton:
    """Parsed ASF skeleton with per-frame AMC posing."""

    # Acclaim bone name -> SMPL joint index (reference getSmplJoints mapping
    # intent: nearest anatomical correspondent)
    SMPL_MAP = {
        "root": 0, "lhipjoint": 1, "rhipjoint": 2, "lowerback": 3,
        "lfemur": 4, "rfemur": 5, "upperback": 6, "ltibia": 7, "rtibia": 8,
        "thorax": 9, "lfoot": 10, "rfoot": 11, "lowerneck": 12,
        "lclavicle": 13, "rclavicle": 14, "upperneck": 15, "lhumerus": 16,
        "rhumerus": 17, "lradius": 18, "rradius": 19, "lwrist": 20,
        "rwrist": 21, "lhand": 22, "rhand": 23,
    }

    def __init__(self, asf_path: str, amc_path: str = "",
                 length_scale: float = 0.056444):
        """length_scale: ASF unit -> meters (CMU: (1/0.45) inches -> m)."""
        self.length_scale = length_scale
        self.bones: Dict[str, Bone] = {}
        self.root_order: List[str] = []
        self.root_axis = np.eye(3)
        self.frames: List[Dict[str, np.ndarray]] = []
        self._parse_asf(asf_path)
        if amc_path:
            self.load_amc(amc_path)

    # -- parsing ---------------------------------------------------------------

    def _parse_asf(self, path: str) -> None:
        with open(path, "r") as f:
            lines = [ln.strip() for ln in f]
        section = ""
        bone: Optional[dict] = None
        for ln in lines:
            if not ln or ln.startswith("#"):
                continue
            if ln.startswith(":"):
                section = ln.split()[0][1:]
                continue
            toks = ln.split()
            if section == "root":
                if toks[0] == "order":
                    self.root_order = [t.lower() for t in toks[1:]]
                elif toks[0] == "axis":
                    pass  # XYZ assumed
            elif section == "bonedata":
                if toks[0] == "begin":
                    bone = dict(dof=[], axis=np.zeros(3))
                elif toks[0] == "end":
                    C = _rot_xyz(*(np.deg2rad(bone["axis"])))
                    self.bones[bone["name"]] = Bone(
                        name=bone["name"],
                        direction=np.asarray(bone["direction"], float),
                        length=float(bone["length"]) * self.length_scale,
                        axis=C, axis_inv=np.linalg.inv(C),
                        dof=bone["dof"])
                    bone = None
                elif bone is not None:
                    if toks[0] == "name":
                        bone["name"] = toks[1]
                    elif toks[0] == "direction":
                        bone["direction"] = [float(x) for x in toks[1:4]]
                    elif toks[0] == "length":
                        bone["length"] = float(toks[1])
                    elif toks[0] == "axis":
                        bone["axis"] = np.asarray(
                            [float(x) for x in toks[1:4]])
                    elif toks[0] == "dof":
                        bone["dof"] = [t.lower() for t in toks[1:]]
            elif section == "hierarchy":
                if toks[0] in ("begin", "end"):
                    continue
                parent = toks[0]
                for child in toks[1:]:
                    if child in self.bones:
                        self.bones[child].parent = parent
                    if parent in self.bones:
                        self.bones[parent].children.append(child)
                    elif parent == "root":
                        self.bones[child].parent = "root"

    def load_amc(self, path: str) -> None:
        """Parse an AMC motion file into per-frame {bone: dof values}."""
        self.frames = []
        frame: Optional[Dict[str, np.ndarray]] = None
        with open(path, "r") as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#") or ln.startswith(":"):
                    continue
                toks = ln.split()
                if len(toks) == 1 and toks[0].isdigit():
                    if frame is not None:
                        self.frames.append(frame)
                    frame = {}
                elif frame is not None:
                    frame[toks[0]] = np.asarray(
                        [float(x) for x in toks[1:]])
        if frame:
            self.frames.append(frame)

    @property
    def num_frames(self) -> int:
        return len(self.frames)

    # -- posing -----------------------------------------------------------------

    def joint_positions(self, frame_id: int = -1) -> Dict[str, np.ndarray]:
        """Global joint positions {bone_name: [3]} for a frame (or the rest
        pose when frame_id < 0).  'root' maps to the root position."""
        if frame_id >= 0:
            fr = self.frames[frame_id]
            root_vals = fr.get("root", np.zeros(6))
            vals = dict(zip(self.root_order or
                            ["tx", "ty", "tz", "rx", "ry", "rz"], root_vals))
            root_pos = np.asarray([vals.get("tx", 0), vals.get("ty", 0),
                                   vals.get("tz", 0)]) * self.length_scale
            root_rot = _rot_xyz(np.deg2rad(vals.get("rx", 0.0)),
                                np.deg2rad(vals.get("ry", 0.0)),
                                np.deg2rad(vals.get("rz", 0.0)))
        else:
            fr = {}
            root_pos = np.zeros(3)
            root_rot = np.eye(3)

        out = {"root": root_pos}
        rots = {"root": root_rot}

        def visit(name: str):
            b = self.bones[name]
            parent = b.parent or "root"
            R_parent = rots[parent]
            # local motion rotation from AMC dof values
            angles = {"rx": 0.0, "ry": 0.0, "rz": 0.0}
            if frame_id >= 0 and name in fr:
                for dof, v in zip(b.dof, fr[name]):
                    angles[dof] = np.deg2rad(v)
            M = _rot_xyz(angles["rx"], angles["ry"], angles["rz"])
            # Acclaim: global = R_parent * C * M * C^-1 applied to direction
            L = b.axis @ M @ b.axis_inv
            R = R_parent @ L
            rots[name] = R
            out[name] = out[parent] + R @ (b.direction * b.length)
            for c in b.children:
                visit(c)

        for b in self.bones.values():
            if b.parent in (None, "root"):
                visit(b.name)
        return out

    # -- posed-state navigation + joint ops -------------------------------------
    # The reference keeps a mutable posed skeleton (global joint positions)
    # with frame navigation (ViconSkeleton.cpp:253-310) and declares a
    # joint-op API -- translate/rotate/scale of a bone and its subtree
    # (ViconSkeleton.h:36-74; the .cpp never defines these, so the header
    # comments are the spec).  Here the posed state is ``self.pos``
    # {joint_name: global [3]}, created on first use at the rest pose.

    @property
    def pos(self) -> Dict[str, np.ndarray]:
        if not hasattr(self, "_pos") or self._pos is None:
            self.rest()
        return self._pos

    def load_frame(self, frame: int) -> None:
        """Set the posed state to AMC frame ``frame`` (1-based like the
        reference; 0 = rest pose).  ViconSkeleton.cpp:253-266."""
        if frame <= 0:
            self._pos = self.joint_positions(-1)
        else:
            self._pos = self.joint_positions(frame - 1)
        self._cur_frame = max(0, min(frame, self.num_frames))

    def rest(self) -> None:
        """Reset the posed state to the rest pose (= load_frame(0));
        ViconSkeleton.cpp:268-271."""
        self.load_frame(0)

    @property
    def cur_frame(self) -> int:
        return getattr(self, "_cur_frame", 0)

    def next_frame(self, num: int = 1, loop: bool = False) -> bool:
        """Advance ``num`` frames (ViconSkeleton.cpp:284-295)."""
        if not self.frames:
            return False
        nxt = self.cur_frame + num
        if nxt > self.num_frames:
            if not loop:
                return False
            nxt = (nxt - 1) % self.num_frames + 1
        self.load_frame(nxt)
        return True

    def prev_frame(self, num: int = 1, loop: bool = False) -> bool:
        """Rewind ``num`` frames (ViconSkeleton.cpp:297-308)."""
        if not self.frames:
            return False
        prv = self.cur_frame - num
        if prv < 1:
            if not loop:
                return False
            prv = (prv - 1) % self.num_frames + 1
        self.load_frame(prv)
        return True

    def _subtree(self, name: str) -> List[str]:
        """``name`` plus every descendant bone, preorder."""
        out = []
        stack = [name]
        while stack:
            n = stack.pop()
            out.append(n)
            if n == "root":
                stack.extend(b.name for b in self.bones.values()
                             if b.parent in (None, "root"))
            else:
                stack.extend(self.bones[n].children)
        return out

    def _parent_pos(self, name: str) -> np.ndarray:
        parent = self.bones[name].parent or "root"
        return self.pos[parent]

    def local_pos(self, name: str) -> np.ndarray:
        """Vector from the parent joint (global position for root);
        ViconSkeleton.h:36-38."""
        if name == "root":
            return self.pos["root"].copy()
        return self.pos[name] - self._parent_pos(name)

    def set_local_pos(self, name: str, v) -> None:
        """Set the local position, carrying the subtree along
        (ViconSkeleton.h:40-42; root sets the global position)."""
        v = np.asarray(v, float)
        if name == "root":
            self.translate("root", v - self.pos["root"])
        else:
            self.translate(name, self._parent_pos(name) + v - self.pos[name])

    def bone_length(self, name: str) -> float:
        """Current length of the bone ending at ``name``
        (ViconSkeleton.h:44-45)."""
        return float(np.linalg.norm(self.local_pos(name)))

    def translate(self, name: str, v) -> None:
        """Translate the joint and its whole subtree by ``v``
        (ViconSkeleton.h:47-48)."""
        v = np.asarray(v, float)
        for n in self._subtree(name):
            self.pos[n] = self.pos[n] + v

    def rotate(self, name: str, R) -> None:
        """Rotate the bone ending at ``name`` and its subtree by rotation
        matrix ``R`` about the parent joint (ViconSkeleton.h:50-53; no-op
        on root)."""
        if name == "root":
            return
        R = np.asarray(R, float)
        origin = self._parent_pos(name)
        for n in self._subtree(name):
            self.pos[n] = origin + R @ (self.pos[n] - origin)

    @staticmethod
    def _align_rotation(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Minimal rotation taking direction a -> direction b."""
        a = a / max(np.linalg.norm(a), 1e-12)
        b = b / max(np.linalg.norm(b), 1e-12)
        v = np.cross(a, b)
        c = float(np.dot(a, b))
        if np.linalg.norm(v) < 1e-12:
            if c > 0:
                return np.eye(3)
            # antiparallel: rotate pi about any axis orthogonal to a
            axis = np.cross(a, [1.0, 0.0, 0.0])
            if np.linalg.norm(axis) < 1e-6:
                axis = np.cross(a, [0.0, 1.0, 0.0])
            axis /= np.linalg.norm(axis)
            return 2.0 * np.outer(axis, axis) - np.eye(3)
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        return np.eye(3) + vx + vx @ vx / (1.0 + c)

    def rotate_to(self, name: str, v) -> None:
        """Rotate the bone (+ subtree) so it points along ``v``
        (ViconSkeleton.h:55-59)."""
        if name == "root":
            return
        self.rotate(name, self._align_rotation(self.local_pos(name),
                                               np.asarray(v, float)))

    def scale_one(self, name: str, scale: float) -> None:
        """Scale ONLY the bone ending at ``name``; children translate (but
        do not scale) along (ViconSkeleton.h:61-63; no-op on root)."""
        if name == "root":
            return
        old = self.pos[name].copy()
        new = self._parent_pos(name) + scale * self.local_pos(name)
        self.translate(name, new - old)

    def scale(self, name: str, scale: float) -> None:
        """Scale the bone ending at ``name`` and every bone in its subtree
        (ViconSkeleton.h:65-67; no-op on root)."""
        if name == "root":
            return
        origin = self._parent_pos(name)
        for n in self._subtree(name):
            self.pos[n] = origin + scale * (self.pos[n] - origin)

    def rotate_and_scale(self, name: str, v) -> None:
        """Rotate + scale the subtree so the bone equals vector ``v``
        exactly (ViconSkeleton.h:69-74)."""
        if name == "root":
            return
        cur = self.local_pos(name)
        v = np.asarray(v, float)
        s = np.linalg.norm(v) / max(np.linalg.norm(cur), 1e-12)
        R = self._align_rotation(cur, v)
        origin = self._parent_pos(name)
        for n in self._subtree(name):
            self.pos[n] = origin + s * (R @ (self.pos[n] - origin))

    def smpl_joints(self, frame_id: Optional[int] = -1) -> np.ndarray:
        """[24, 3] SMPL-ordered joint positions (NaN where unmapped),
        suitable for Avatar.align_to_joints (reference getSmplJoints).
        ``frame_id=None`` reads the mutable posed state (joint ops applied);
        an int recomputes that AMC frame (-1 = rest pose)."""
        pos = self.pos if frame_id is None else self.joint_positions(frame_id)
        out = np.full((24, 3), np.nan)
        for name, idx in self.SMPL_MAP.items():
            if name in pos or name == "root":
                out[idx] = pos.get(name, pos["root"])
        return out

    def to_pose_bank(self, path: str) -> None:
        """Convert the loaded AMC motion into an AvatarPoseSequence-style
        bank by heuristic alignment of every frame (root pos + identity
        rotations + per-bone alignment happens downstream via
        Avatar.align_to_joints; here we store root position and identity
        quaternions as a minimal bank)."""
        from avatar_tpu_torch.core.sequence import AvatarPoseSequence

        F = self.num_frames
        pos = np.zeros((F, 3))
        quats = np.zeros((F, 24, 4))
        quats[..., 3] = 1.0
        for i in range(F):
            pos[i] = self.joint_positions(i)["root"]
        AvatarPoseSequence.write(path, pos, quats)
