"""A tube body over SMPL-X's skeleton, frozen: the stand-in for SMPL-X
(Pavlakos et al., CVPR 2019), whose files are not in the repository.

SMPL-X's 55 joints in its order and with its parents: SMPL's pelvis and
21 body joints (0-21), the jaw (22), the eyes (23, 24), and for each hand
the index, middle, pinky, ring and thumb, three joints each, each chain
rooted at its wrist (left 25-39 at 20, right 40-54 at 21).  Joints 0-21
sit at the 24-joint tube body's rest positions with its radii
(``harness/model_arrays.py``), so that the forests trained on that body
see the body they were trained on; the jaw, eyes and fingers are placed
by hand.  Each bone is a tube of ``rings[region] = [vertices per ring,
rings]``, closed at both ends; at the configuration's sizes the body has
SMPL-X's 10,475 vertices, about half of them on the head (head, jaw,
eyes: 5,035, FLAME's head has 5,023) and 760 on each hand from the wrist
on (MANO's hand has 778), and 20,734 faces (SMPL-X: 20,908).  The shape
keys: ``shape_keys`` over the whole body, then ``expression_keys`` that
move only the head's vertices, as SMPL-X's expression directions move
only the face.  The pose prior is the synthetic GMM over the 3 x 54
axis-angle dimensions of joints 1-54.  numpy only: it imports neither the
port nor JAX.
"""

from __future__ import annotations

import numpy as np

from harness import model_arrays as ma

# the parent of each of SMPL-X's joints (its kintree_table)
PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37,
     38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],
    np.int32)

# the left hand's finger joints (index, middle, pinky, ring, thumb; three
# each), m; the right hand's mirror them in x
_LEFT_FINGERS = np.array([
    [0.775, 0.392, 0.012], [0.808, 0.390, 0.014], [0.830, 0.388, 0.015],
    [0.780, 0.392, -0.004], [0.815, 0.390, -0.004], [0.840, 0.388, -0.004],
    [0.765, 0.392, -0.035], [0.788, 0.390, -0.038], [0.805, 0.388, -0.040],
    [0.775, 0.392, -0.020], [0.805, 0.390, -0.021], [0.827, 0.388, -0.022],
    [0.715, 0.380, 0.025], [0.740, 0.376, 0.045], [0.762, 0.372, 0.058],
])
REST_JOINTS = np.concatenate([
    ma._REST_JOINTS[:22],
    [[0.000, 0.505, 0.055], [0.032, 0.585, 0.065], [-0.032, 0.585, 0.065]],
    _LEFT_FINGERS, _LEFT_FINGERS * [-1.0, 1.0, 1.0]])

# tube radius by child joint, m
RADIUS = {j: ma._BONE_RADIUS[j] for j in range(1, 22)}
RADIUS.update({22: 0.035, 23: 0.014, 24: 0.014})
RADIUS.update({f + k: r for f in range(25, 55, 3)
               for k, r in enumerate((0.010, 0.008, 0.007))})
RADIUS.update({37: 0.012, 52: 0.012})

# the region of each bone, by child joint, that names its tube's size
HEAD_REGIONS = ("head", "jaw", "eye")


def region(child: int) -> str:
    if child == 15:
        return "head"
    if child == 22:
        return "jaw"
    if child in (23, 24):
        return "eye"
    if child >= 25:
        return f"finger{(child - 25) % 3 + 1}"
    return "body"


def _cap(ring: np.ndarray, verts: np.ndarray, outward: np.ndarray):
    """Faces closing a ring of vertex ids, in strips across it (thin
    triangles span the ring's width, not its diameter squared), wound so
    that their normals point along ``outward``."""
    n = len(ring)
    order = [0]
    lo, hi = 1, n - 1
    while lo <= hi:
        order.append(lo)
        lo += 1
        if lo <= hi:
            order.append(hi)
            hi -= 1
    faces = []
    for k in range(n - 2):
        f = [ring[order[k]], ring[order[k + 1]], ring[order[k + 2]]]
        a, b, c = verts[f[0]], verts[f[1]], verts[f[2]]
        if np.dot(np.cross(b - a, c - a), outward) < 0:
            f = [f[0], f[2], f[1]]
        faces.append(f)
    return faces


def body(rings: dict, n_keys: int, n_expression: int, seed: int) -> dict:
    """The arrays of the body: ``rings`` {region: [vertices per ring,
    rings]}, ``n_keys`` shape keys over the body and ``n_expression`` over
    the head."""
    rng = np.random.default_rng(seed)
    J = len(PARENTS)
    joints = REST_JOINTS.astype(np.float64)
    verts, weights, faces, head = [], [], [], []
    for child in range(1, J):
        par = int(PARENTS[child])
        a, b = joints[par], joints[child]
        axis = b - a
        length = np.linalg.norm(axis)
        axis_n = axis / length
        up = np.array([0.0, 0.0, 1.0]) if abs(axis_n[2]) < 0.9 else np.array(
            [1.0, 0.0, 0.0])
        e1 = np.cross(axis_n, up)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(axis_n, e1)
        n_seg, n_rings = rings[region(child)]
        base = len(verts)
        for ri in range(n_rings):
            t = ri / (n_rings - 1.0)
            r = RADIUS[child] * (1.0 - 0.25 * t)
            center = a + axis * t
            for si in range(n_seg):
                ang = 2 * np.pi * si / n_seg
                verts.append(center + r * (np.cos(ang) * e1 +
                                           np.sin(ang) * e2))
                wrow = np.zeros(J)
                s = ma._smoothstep((t - 0.55) / 0.45)
                wrow[par] = 1.0 - s
                wrow[child] = s
                weights.append(wrow)
        head.extend([region(child) in HEAD_REGIONS] * (n_seg * n_rings))
        for ri in range(n_rings - 1):
            for si in range(n_seg):
                v00 = base + ri * n_seg + si
                v01 = base + ri * n_seg + (si + 1) % n_seg
                v10 = base + (ri + 1) * n_seg + si
                v11 = base + (ri + 1) * n_seg + (si + 1) % n_seg
                faces.append([v00, v01, v10])
                faces.append([v01, v11, v10])
        vv = np.asarray(verts)
        first = np.arange(base, base + n_seg)
        last = first + (n_rings - 1) * n_seg
        faces.extend(_cap(first, vv, -axis_n))
        faces.extend(_cap(last, vv, axis_n))

    verts = np.asarray(verts)
    weights = np.asarray(weights)
    faces = np.asarray(faces, np.int32)
    head = np.asarray(head)
    P = verts.shape[0]

    # joint regressor: inverse distance over each joint's 24 nearest
    # vertices, then the template moved so that it regresses the joints
    joint_reg = np.zeros((J, P))
    for j in range(J):
        d = np.linalg.norm(verts - joints[j], axis=1)
        idx = np.argsort(d)[:24]
        wv = 1.0 / (d[idx] + 0.02)
        joint_reg[j, idx] = wv / wv.sum()
    err = joints - joint_reg @ verts
    G = joint_reg @ joint_reg.T
    verts = verts + joint_reg.T @ np.linalg.solve(G + 1e-9 * np.eye(J), err)

    # shape keys: an overall size, then smooth fields over the body; the
    # expression keys are smooth fields on the head's vertices alone
    shapedirs = np.zeros((P, 3, n_keys + n_expression))
    shapedirs[:, :, 0] = (verts - verts.mean(axis=0)) * 0.031
    for k in range(1, n_keys + n_expression):
        freq = rng.uniform(1.0, 3.0, size=(3, 3))
        phase = rng.uniform(0, 2 * np.pi, size=(3, 3))
        amp = rng.uniform(0.002, 0.01, size=(3,))
        for c in range(3):
            shapedirs[:, c, k] = amp[c] * np.sin(verts @ freq[c] +
                                                 phase[c, 0])
    shapedirs[~head, :, n_keys:] = 0.0
    return dict(v_template=verts, parent=PARENTS.copy(), faces=faces,
                joint_reg=joint_reg, weights=weights, shapedirs=shapedirs,
                use_jsr=True)


def arrays(model: dict) -> dict:
    return body(model["rings"], model["shape_keys"],
                model["expression_keys"], model["seed"])


def prior_arrays(n_joints: int, model: dict):
    return ma.synthetic_pose_prior_arrays(n_joints, seed=model["prior_seed"])
