"""SMPL-X's forward pass in plain PyTorch, float32: the equations of
Pavlakos et al., "Expressive Body Capture: 3D Hands, Face, and Body from
a Single Image" (CVPR 2019), as the ``smplx`` package's ``lbs`` writes
them (``smplx/lbs.py``), less the pose-corrective blend shapes:

  1. shape and expression blend: v_shaped = v_template + S [betas; psi];
  2. rest joints: J = J_regressor v_shaped;
  3. Rodrigues of each joint's axis-angle;
  4. global transforms down ``kintree_table``, one joint at a time in
     parent order;
  5. the rest joints taken out of each transform;
  6. linear blend skinning of v_shaped, then the translation.

``load`` takes the shape and expression columns of an SMPL-X
``shapedirs`` as the ``smplx`` layer's ``SMPLX`` does: the first
``num_betas`` columns, then ``num_expression_coeffs`` from column 300 in
the 400-column layout (v1.1) or from column 10 in the 20-column layout
(v1.0).  This module imports neither the port nor JAX and shares none of
its code (the port chains joints by pointer doubling and takes its rest
joints from a joint-shape regressor); TF32 is off unless a call allows
it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SHAPE_SPACE_DIM = 300
EXPRESSION_SPACE_DIM = 100


class SmplxModel(NamedTuple):
    v_template: torch.Tensor     # [V, 3]
    shapedirs: torch.Tensor      # [V, 3, num_betas + num_expression_coeffs]
    J_regressor: torch.Tensor    # [J, V]
    weights: torch.Tensor        # [V, J]
    parents: Tuple[int, ...]     # parents[0] == -1


def load(source, num_betas: int = 10, num_expression_coeffs: int = 10,
         device="cpu") -> SmplxModel:
    """The model of an SMPL-X ``model.npz`` (a path) or of a mapping with
    its arrays (``v_template``, ``shapedirs``, ``J_regressor``,
    ``weights``, ``kintree_table``), in float32 on ``device``."""
    npz = np.load(source) if isinstance(source, str) else source
    shapedirs = np.asarray(npz["shapedirs"])
    if shapedirs.shape[-1] < SHAPE_SPACE_DIM + EXPRESSION_SPACE_DIM:
        num_betas = min(num_betas, 10)
        expr_start = 10
        num_expression_coeffs = min(num_expression_coeffs, 10)
    else:
        num_betas = min(num_betas, SHAPE_SPACE_DIM)
        expr_start = SHAPE_SPACE_DIM
        num_expression_coeffs = min(num_expression_coeffs,
                                    EXPRESSION_SPACE_DIM)
    dirs = np.concatenate([
        shapedirs[:, :, :num_betas],
        shapedirs[:, :, expr_start:expr_start + num_expression_coeffs]], -1)
    kintree = np.asarray(npz["kintree_table"]).astype(np.int64)
    parents = tuple([-1] + [int(p) for p in kintree[0, 1:]])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    return SmplxModel(v_template=t(npz["v_template"]), shapedirs=t(dirs),
                      J_regressor=t(npz["J_regressor"]),
                      weights=t(npz["weights"]), parents=parents)


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """[N, 3] axis-angle -> [N, 3, 3] rotation matrices."""
    angle = torch.norm(rot_vecs + 1e-8, dim=1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.unsqueeze(torch.cos(angle), dim=1)
    sin = torch.unsqueeze(torch.sin(angle), dim=1)
    rx, ry, rz = torch.split(rot_dir, 1, dim=1)
    zeros = torch.zeros_like(rx)
    K = torch.cat([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                  dim=1).view(-1, 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return ident + sin * K + (1 - cos) * torch.bmm(K, K)


def _transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[N, 4, 4] from [N, 3, 3] rotations and [N, 3, 1] translations."""
    top = torch.cat([R, t], dim=2)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=1)


def rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                    parents: Tuple[int, ...]):
    """The posed joints [J, 3] and the transforms [J, 4, 4] that take a
    rest vertex to its place under each joint alone."""
    J = joints.shape[0]
    j = joints[:, :, None]                                      # [J, 3, 1]
    rel = j.clone()
    rel[1:] = rel[1:] - j[list(parents[1:])]
    local = _transform_mat(rot_mats, rel)                       # [J, 4, 4]
    chain = [local[0]]
    for i in range(1, J):
        chain.append(chain[parents[i]] @ local[i])
    transforms = torch.stack(chain)
    posed_joints = transforms[:, :3, 3]
    j_homo = torch.cat([j, torch.zeros_like(j[:, :1])], dim=1)  # [J, 4, 1]
    rest = transforms @ j_homo                                  # [J, 4, 1]
    rel_transforms = transforms - torch.cat(
        [torch.zeros_like(transforms[:, :, :3]), rest], dim=2)
    return posed_joints, rel_transforms


def rest_joints(model: SmplxModel, betas: torch.Tensor,
                expression: torch.Tensor) -> torch.Tensor:
    """J_regressor on the shaped template: [J, 3]."""
    return model.J_regressor @ _shaped(model, betas, expression)


def _shaped(model, betas, expression):
    coeffs = torch.cat([betas, expression])
    return model.v_template + torch.einsum("vck,k->vc", model.shapedirs,
                                           coeffs)


def forward(model: SmplxModel, betas: torch.Tensor, expression: torch.Tensor,
            full_pose: torch.Tensor, transl: torch.Tensor,
            allow_tf32: bool = False):
    """(vertices [V, 3], joints [J, 3]) of the pose ``full_pose`` [J, 3]
    (axis-angle of every joint, the root's global orientation first) with
    shape ``betas``, expression ``expression`` and translation ``transl``
    [3].  ``allow_tf32`` runs the matrix products in TF32 on the card, for
    the control."""
    with _tf32(allow_tf32):
        v_shaped = _shaped(model, betas, expression)
        joints = model.J_regressor @ v_shaped
        rot_mats = batch_rodrigues(full_pose.reshape(-1, 3))
        posed_joints, A = rigid_transform(rot_mats, joints, model.parents)
        J = joints.shape[0]
        T = (model.weights @ A.reshape(J, 16)).reshape(-1, 4, 4)
        v_homo = torch.cat([v_shaped, torch.ones_like(v_shaped[:, :1])], 1)
        verts = (T @ v_homo[:, :, None])[:, :3, 0]
        return verts + transl, posed_joints + transl


@contextlib.contextmanager
def _tf32(allow: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
