"""Batched synthetic depth-frame generation (counterpart of
``avatar_tpu/train/synth.py``; reference AvatarDataSource,
RTree.cpp:421-540, and the smplsynth worker loop, smplsynth.cpp:89-168).

Image i is generated from its id alone: mocap pose frame
``frame_seq[i % N]`` with a randomized root rotation, shape N(0, 1) and
root position, so a checkpoint-resumed trainer regenerates its frame cache
from the ids.

Two parts: ``sample_pose`` makes the random draws and ``render_poses``
poses, skins and rasterizes them.  The reference draws from JAX's threefry
keys (``fold_in(PRNGKey(seed), image_id)``); here each image draws from
``np.random.default_rng((seed, image_id))`` on the host, the idiom the
trainer already uses for its feature pools.  The frames of the two packages
therefore differ, from the same distributions:

  * shape N(0, 1); root box [-1, 1] x [-0.5, 0.5] x [2.2, 4.5];
  * facing angle pi + U(-pi/3, pi/3) about y;
  * a perturbation of 0.2 * N(0, 1) rad about an axis whose spherical
    angles are BOTH driven by one uniform u (theta = 2 pi u,
    phi = pi u - pi/2): the reference draws theta and phi from the same
    key, and the joint distribution is kept as found.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.core.lbs import LBSParams, lbs
from avatar_tpu_torch.device import get_device
from avatar_tpu_torch.render import raster
from avatar_tpu_torch.render.renderer import render_frames


class SynthSource(NamedTuple):
    """Static inputs of the generator, on one device."""
    lbs: LBSParams
    faces: torch.Tensor         # [F, 3]
    vertex_part: torch.Tensor   # [P] part labels (part_map applied)
    mocap_pos: torch.Tensor     # [M, 3] mocap root positions
    mocap_rots: torch.Tensor    # [M, J, 3, 3] mocap joint rotations
    frame_seq: torch.Tensor     # [N_img] shuffled mocap frame ids
    intrin: torch.Tensor        # [4] fx, fy, cx, cy


def sample_pose(src: SynthSource, image_ids, seed: int, n_keys: int):
    """Pose and shape of each image id: (w [B,K], p [B,3], rots [B,J,3,3])
    on the source's device.  The same (seed, id) gives the same draw on
    every call (AvatarDataSource semantics: mocap pose, randomized shape
    and root position/rotation; smplsynth.cpp:106-114)."""
    ids = np.asarray(image_ids.cpu() if torch.is_tensor(image_ids)
                     else image_ids, np.int64).reshape(-1)
    B = ids.shape[0]
    w = np.empty((B, n_keys))
    p = np.empty((B, 3))
    aa = np.empty((B, 2, 3))        # axis-angle: perturbation, facing
    for k, i in enumerate(ids):
        rng = np.random.default_rng((int(seed), int(i)))
        w[k] = rng.standard_normal(n_keys)
        u = rng.random(3)
        p[k] = (u[0] * 2 - 1, u[1] - 0.5, 2.2 + u[2] * 2.3)
        angle_up = math.pi + rng.uniform(-math.pi / 3, math.pi / 3)
        u_ax = rng.random()
        theta, phi = 2 * math.pi * u_ax, math.pi * u_ax - math.pi / 2
        axis = (math.sin(phi) * math.cos(theta), math.cos(phi),
                math.sin(phi) * math.sin(theta))
        aa[k, 0] = np.asarray(axis) * (0.2 * rng.standard_normal())
        aa[k, 1] = (0.0, angle_up, 0.0)
    dev, dtype = src.mocap_rots.device, src.mocap_rots.dtype
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    ids_t = torch.as_tensor(ids, device=dev)
    M = src.mocap_pos.shape[0]
    frame = src.frame_seq[ids_t % src.frame_seq.shape[0]].long() % M
    rots = src.mocap_rots[frame].clone()
    R = rotation.so3_exp(t(aa))                       # [B, 2, 3, 3]
    rots[:, 0] = R[:, 0] @ R[:, 1]
    return t(w), t(p), rots


def render_poses(src: SynthSource, parents: Tuple[int, ...], w, p, rots,
                 height: int, width: int, budget: int = 0):
    """Pose, skin and rasterize a batch: (depth [B,H,W] f32, part_mask
    [B,H,W] uint8, joints [B,J,3]).  The poses are skinned one by one and
    rasterized together by ``render_frames``, whose frames do not depend
    on each other: a frame rendered in a batch equals the same frame
    rendered alone, pixel for pixel."""
    if budget == 0:
        budget = raster.default_budget(height, width,
                                       int(src.faces.shape[0]))
    fx, fy, cx, cy = src.intrin.unbind(0)
    posed = [lbs(src.lbs, parents, w[b], p[b], rots[b])[:2]
             for b in range(w.shape[0])]
    fr = render_frames(torch.stack([c for c, _ in posed]), src.faces,
                       src.vertex_part, fx, fy, cx, cy, height, width,
                       budget)
    return fr.depth, fr.part_mask, torch.stack([j for _, j in posed])


def render_batch(src: SynthSource, parents: Tuple[int, ...], image_ids,
                 seed: int, height: int, width: int, n_keys: int,
                 budget: int = 0):
    """Generate the synthetic frames of ``image_ids``: (depth [B,H,W],
    part_mask [B,H,W] uint8, joints [B,J,3])."""
    w, p, rots = sample_pose(src, image_ids, seed, n_keys)
    return render_poses(src, parents, w, p, rots, height, width, budget)


def make_source(model, intrin, part_map=None, pose_seq=None, n_images=1000,
                seed: int = 0) -> SynthSource:
    """Build a SynthSource from an AvatarModel (+ optional mocap bank), on
    the model's device.  Without a bank, min(n_images, 512) poses are drawn
    from the model's GMM prior."""
    dev = get_device(model.device)
    mj = model.main_joint
    if part_map is None or len(part_map) == 0:
        vertex_part = np.asarray(mj, np.int32)
    else:
        vertex_part = np.asarray(part_map, np.int32)[mj]
    if pose_seq is not None and pose_seq.num_frames > 0:
        pos, rots = pose_seq.frames_as_arrays(model.dtype, dev)
    else:
        if model.pose_prior is None:
            raise ValueError("need a mocap bank or a pose prior")
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        M = min(n_images, 512)
        aa = model.pose_prior.sample(gen, (M,)).reshape(
            M, model.num_joints() - 1, 3)
        eye = torch.eye(3, dtype=model.dtype, device=dev).expand(M, 1, 3, 3)
        rots = torch.cat([eye, rotation.so3_exp(aa)], dim=1)
        pos = torch.zeros((M, 3), dtype=model.dtype, device=dev)
    rng = np.random.default_rng(seed)
    frame_seq = (rng.permutation(np.arange(n_images, dtype=np.int32)) %
                 max(int(pos.shape[0]), 1))
    return SynthSource(
        lbs=model.params,
        faces=torch.as_tensor(model.faces, dtype=torch.int32, device=dev),
        vertex_part=torch.as_tensor(vertex_part, device=dev),
        mocap_pos=pos, mocap_rots=rots,
        frame_seq=torch.as_tensor(frame_seq, device=dev),
        intrin=torch.as_tensor([intrin.fx, intrin.fy, intrin.cx, intrin.cy],
                               dtype=model.dtype, device=dev))
