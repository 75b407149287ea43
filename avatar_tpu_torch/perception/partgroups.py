"""Body-part grouping for correspondence (numpy copy of
``avatar_tpu/perception/partgroups.py``; see its docstring).

The 24 SMPL joint parts fold into 14 left/right-preserving matching groups
before matching; leaf distributions fold group-wise before the argmax.
"""

from __future__ import annotations

import numpy as np

# SMPL 24-joint part labels -> 14 matching groups (left/right preserved):
#   0 torso {pelvis 0, spine1 3, spine2 6, spine3 9, collars 13, 14}
#   1 head  {neck 12, head 15}
#   2/3 L/R thigh {1, 2}     4/5 L/R calf {4, 5}
#   6/7 L/R foot {ankle 7/8, foot 10/11}
#   8/9 L/R upper arm {16, 17}      10/11 L/R forearm {18, 19}
#   12/13 L/R hand {wrist 20/21, hand 22/23}
SMPL24_GROUP_LUT = np.array(
    [0, 2, 3, 0, 4, 5, 0, 6, 7, 0, 6, 7, 1, 0, 0, 1, 8, 9, 10, 11, 12, 13,
     12, 13], np.int32)
SMPL24_NUM_GROUPS = 14
SMPL24_GROUP_NAMES = (
    "torso", "head", "l_thigh", "r_thigh", "l_calf", "r_calf", "l_foot",
    "r_foot", "l_uparm", "r_uparm", "l_forearm", "r_forearm", "l_hand",
    "r_hand")


# SMPL-X's 55 joints (Pavlakos et al., CVPR 2019) onto the 24 SMPL parts a
# forest labels: SMPL's joints 0-21 onto themselves, the jaw (22) and eyes
# (23, 24) onto the head (15), each hand's 15 finger joints (left 25-39,
# right 40-54) onto its hand part (22, 23).  ``data/smplx55_smpl24.partmap``
# is the same map as a file.
SMPLX55_TO_SMPL24 = np.array(
    list(range(22)) + [15, 15, 15] + [22] * 15 + [23] * 15, np.int32)


# Limb-recovery chain roots (tracking resilience, SURVEY §5.3): for each
# recoverable extremity group, the joint whose rotation re-aims the limb —
# calves re-aim at the hip, feet at the knee, forearms at the shoulder.
# Hands are deliberately NOT recoverable: forests essentially never segment
# hands reliably, so a "hand" blob is almost always a mislabel, and aiming
# the elbow at one throws the whole arm (hands follow the wrist via the
# temporal prior once the forearm recovers).
SMPL24_GROUP_CHAIN_ROOT = {
    4: 1, 5: 2,       # l/r calf    <- hip
    6: 4, 7: 5,       # l/r foot    <- knee
    10: 16, 11: 17,   # l/r forearm <- shoulder
}


def group_label_lut(lut: np.ndarray) -> np.ndarray:
    """[256] uint8 label LUT (255 background stays 255) for host/device
    mapping of part-label images."""
    full = np.full(256, 255, np.uint8)
    full[: len(lut)] = lut.astype(np.uint8)
    return full


def fold_leaf_data(leaf_data: np.ndarray, lut: np.ndarray,
                   num_groups: int) -> np.ndarray:
    """Fold [L, P] leaf part distributions into [L, G] group distributions."""
    L, P = leaf_data.shape
    out = np.zeros((L, num_groups), leaf_data.dtype)
    for p in range(P):
        out[:, lut[p]] += leaf_data[:, p]
    return out


def joint_parts(part_map, n_joints: int, n_parts: int) -> np.ndarray:
    """[n_joints] int32: the part of each of the model's joints, from a
    forest's joint-to-part map (``RTree.part_map``; empty: joint j is part
    j).  A ``ValueError`` that names the counts where the map does not
    cover the model's joints or sends one outside the forest's parts (an
    SMPL-X body on the 24-part forests needs ``SMPLX55_TO_SMPL24``)."""
    pm = (np.arange(n_joints, dtype=np.int32) if part_map is None or
          len(part_map) == 0 else np.asarray(part_map, np.int32))
    if len(pm) != n_joints:
        raise ValueError(f"the part map covers {len(pm)} joints; the model "
                         f"has {n_joints}")
    if pm.min() < 0 or pm.max() >= n_parts:
        raise ValueError(f"the part map sends joints to parts up to "
                         f"{pm.max()}; the forest has {n_parts} parts")
    return pm
