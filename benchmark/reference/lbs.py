"""Linear-blend-skinning forward pass (frozen copy of the port's ``core/lbs.py``).

Reference semantics kept exactly:
  * the root joint's global translation is the avatar position ``p`` itself
    ("root position at center (non-standard!)", reference Avatar.cpp:49) —
    the pelvis lands at ``p`` regardless of shape;
  * the joints returned are the posed joint positions.

Row-major throughout: verts [P,3], joints [J,3], rotations [J,3,3].  All
contractions run in full float32 (``device.py`` turns TF32 off).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch




class LBSParams(NamedTuple):
    """Static per-model tensors of the LBS pass."""

    v_template: torch.Tensor        # [P, 3]
    shapedirs: torch.Tensor         # [P, 3, K]
    weights: torch.Tensor           # [P, J] dense LBS weights
    joint_reg: torch.Tensor         # [J, P] dense joint regressor
    joint_shape_reg_base: torch.Tensor  # [J, 3]
    joint_shape_reg: torch.Tensor   # [J, 3, K]


def shape_fwd(params: LBSParams, w: torch.Tensor, use_jsr: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply shape keys: (shaped verts [P,3], rest joints [J,3])."""
    shaped = params.v_template + torch.einsum("pck,k->pc", params.shapedirs, w)
    if use_jsr:
        j_init = params.joint_shape_reg_base + torch.einsum(
            "jck,k->jc", params.joint_shape_reg, w)
    else:
        j_init = torch.einsum("jp,pc->jc", params.joint_reg, shaped)
    return shaped, j_init


def shaped_dtype(params: LBSParams):
    return params.v_template.dtype


@functools.lru_cache(maxsize=32)
def _lifting_pointers(parents: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """Pointer-doubling tables for forward kinematics.

    After round k, joint j's accumulated affine covers the chain segment
    [j, ptr_k[j]) and ptr_{k+1}[j] = ptr_k[ptr_k[j]].  Slot J is the
    identity sentinel; the root's pointer starts at the sentinel.
    """
    J = len(parents)
    ptr = [J] + [0] * (J - 1) + [J]
    for j in range(1, J):
        ptr[j] = parents[j]
    rounds = []
    while any(ptr[j] != J for j in range(J)):
        rounds.append(tuple(ptr[:J]))
        ptr = [ptr[ptr[j]] if ptr[j] != J else J for j in range(J)] + [J]
    return tuple(rounds)


@functools.lru_cache(maxsize=64)
def fk_indices(parents: Tuple[int, ...], device: torch.device
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The index tensors of ``fk`` on ``device``, built once per
    ``(parents, device)``: each is a host-to-device copy, which a CUDA graph
    cannot capture and which synchronises an eager step.  (the parent of
    each joint, the root its own; one pointer table per doubling round,
    with the sentinel slot J)."""
    J = len(parents)
    par = torch.tensor([parents[i] if parents[i] >= 0 else i
                        for i in range(J)], device=device)
    return par, tuple(torch.tensor(ptr + (J,), device=device)
                      for ptr in _lifting_pointers(parents))


def fk(parents: Tuple[int, ...], rots: torch.Tensor, p: torch.Tensor,
       j_init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics by pointer doubling: ceil(log2(chain length))
    batched [J+1,3,3] matmul rounds.  Returns (Rg [J,3,3] global rotations,
    tg [J,3] posed joint positions)."""
    J = len(parents)
    dev = rots.device
    par, rounds = fk_indices(tuple(parents), dev)
    t_local = j_init - j_init[par]
    t_local = torch.cat([p[None], t_local[1:]], dim=0)
    R = torch.cat([rots, torch.eye(3, dtype=rots.dtype, device=dev)[None]])
    t = torch.cat([t_local, torch.zeros((1, 3), dtype=rots.dtype,
                                        device=dev)])
    for a in rounds:
        Ra = R[a]
        ta = t[a]
        R = torch.einsum("jab,jbc->jac", Ra, R)
        t = torch.einsum("jab,jb->ja", Ra, t) + ta
    return R[:J], t[:J]


def lbs(params: LBSParams, parents: Tuple[int, ...], w: torch.Tensor,
        p: torch.Tensor, rots: torch.Tensor, use_jsr: bool = True):
    """(w, p, R[J]) -> (cloud [P,3], joints [J,3], Rg, j_init)."""
    shaped, j_init = shape_fwd(params, w, use_jsr)
    Rg, tg = fk(parents, rots, p, j_init)
    J = len(parents)
    A = (params.weights @ Rg.reshape(J, 9)).reshape(-1, 3, 3)     # [P,3,3]
    t_eff = tg - torch.einsum("jab,jb->ja", Rg, j_init)            # [J,3]
    b = params.weights @ t_eff                                     # [P,3]
    cloud = torch.einsum("pab,pb->pa", A, shaped) + b
    return cloud, tg, Rg, j_init


def lbs_batched(params: LBSParams, parents: Tuple[int, ...], w, p, rots,
                use_jsr: bool = True):
    """``lbs`` over the leading batch axis of (w, p, rots): (cloud [B,P,3],
    joints [B,J,3], Rg [B,J,3,3], j_init [B,J,3])."""
    outs = [lbs(params, parents, w[b], p[b], rots[b], use_jsr)
            for b in range(w.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))
