"""Fused per-frame tracker (counterpart of ``avatar_tpu/tracking_fused.py``).

One frame, on the tracker's device:

    uint16 depth -> strided XYZ -> background stencil + gated connected
    components -> foreground compacted inside the tracked window ->
    selective three-tree forest walk -> model-label splat -> per-part blob
    suppression with centre-of-mass tracking -> stride and wildcard samples
    -> ICP/LM fit (``optim/gauss_newton.fit``, whose NN runs the CUDA kernel
    of ``optim/nn_kernel.py`` on every LM step)

The reference compiles the frame into one XLA program.  Here the LM fits
run as the reference's compiled loop does, each step a replayed CUDA graph
on the card (``optim/gauss_newton``), and the rest of the frame runs
eagerly: the tracked window's origin, each connected-components sweep and
each LM step read a flag from the device, and the host reads one packed
diagnostics vector per frame.  Every synchronising copy or read of a
frame is a counted read (``profiling.host_read``, ``to_device``).  The
tracker keeps its fits' programs and graphs (``_programs``), so they go
with it; its fit contexts are built once and never replaced (a shape
refit changes theta, not the context), so no fit rebuilds a program.
The reinit / loss state machine stays on the host as in the reference.

On refine frames (``TrackerConfig.refine_every``) the same data bucket is
re-fitted against the mesh surface (``optim/gauss_newton.fit_refine``,
which runs the same NN kernel).

Top-k compactions use ``torch.argsort(-score, stable=True)[:k]``, which
orders ties toward the lower index exactly as ``lax.top_k`` does (the hash
noise has only 65536 levels, so ties occur).  The stages carry the
reference's scope names (``profiling.scope``: ``bgsub``, ``forest_walk``,
``blob_suppress``, ``fit``, ``refine``; the rest of a frame under
``glue/...``), below one ``frame`` root per ``track`` call, which holds the
upload (``upload``), every pass through the pipeline (a reinit runs one
per seed), the diagnostics read (``diag_read``) and the state update; a
batch has one root per frame.

The batch and async modes keep the reference's results and lags:
``fused_frames_batch`` runs a batch as a loop over the frame (the
reference's ``lax.scan``), ``track_batch`` / ``track_batch_async`` upload a
batch at once and read its stacked diagnostics once, and ``track_async``
returns a frame's result ``pipeline_depth`` calls late.  The frame reads
from the device many times, so a dispatched frame or batch has finished
before the call returns: these modes do not overlap host and device work.
"""

from __future__ import annotations

import json
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.core.lbs import LBSParams, lbs
from avatar_tpu_torch.core.model import Avatar, AvatarModel
from avatar_tpu_torch.optim.gauss_newton import (FitContext, PriorData, Theta,
                                                 _forward, extrapolate, fit,
                                                 fit_refine)
from avatar_tpu_torch.optim.surface import vertex_face_rings
from avatar_tpu_torch.perception import cc
from avatar_tpu_torch.perception.bgsub import _foreground_mask
from avatar_tpu_torch.perception.partgroups import (SMPL24_GROUP_CHAIN_ROOT,
                                                    fold_leaf_data,
                                                    group_label_lut,
                                                    joint_parts)
from avatar_tpu_torch.perception.rtree import (TreeTensors,
                                               suppress_part_nonmax,
                                               walk_pixels)
from avatar_tpu_torch.profiling import (FRAME_SCOPE, host_read, host_sync,
                                        scope, to_device)
from avatar_tpu_torch.render.raster import project_points
from avatar_tpu_torch.tracking import TrackerConfig, TrackResult
from avatar_tpu_torch.utils import StageTimer

_BG = 255           # background label
_IMAX = 2 ** 31 - 1


class FrameOut(NamedTuple):
    theta: Theta
    com_pre: torch.Tensor         # [2, num_parts]
    labels_strided: torch.Tensor  # [Hs, Ws] uint8
    # host diagnostics packed into one f32 vector (one device->host copy):
    #   [0] n_points  [1] cost  [2] n_matched  [3 : 3+G] part_counts
    #   [3+G : 3+3G] com_pre (2, G)  [3+3G : 3+8G] model_com (G, 5)
    #   [3+8G] root_jump (m)  [3+8G+1] n_fg  [3+8G+2] hard_overflow
    host_diag: torch.Tensor


class HostDiag(NamedTuple):
    n_points: int
    cost: float
    n_matched: int
    part_counts: np.ndarray   # [G]
    com_pre: np.ndarray       # [2, G]
    model_com: np.ndarray     # [G, 5]
    root_jump: float
    n_fg: float
    hard_overflow: float


def unpack_diag(vec, num_parts: int) -> HostDiag:
    """The packed diagnostics vector (a tensor, read with one device->host
    copy, or a row of a batch's diagnostics already read)."""
    a = vec
    if isinstance(vec, torch.Tensor):
        with scope("diag_read"):
            a = host_read(vec)
    G = num_parts
    return HostDiag(
        n_points=int(a[0]), cost=float(a[1]), n_matched=int(a[2]),
        part_counts=a[3:3 + G],
        com_pre=a[3 + G:3 + 3 * G].reshape(2, G),
        model_com=a[3 + 3 * G:3 + 8 * G].reshape(G, 5),
        root_jump=float(a[3 + 8 * G]), n_fg=float(a[3 + 8 * G + 1]),
        hard_overflow=float(a[3 + 8 * G + 2]))


def _hash_noise(n: int, mult: int, device) -> torch.Tensor:
    """((i * mult) mod 2^32) & 0xFFFF, / 65536: the reference's uint32
    tie-break noise (the low 16 bits do not depend on the wrap)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return ((i * mult) & 0xFFFF).to(torch.float32) / 65536.0


def _top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of ``lax.top_k(score, k)``: descending, ties lower index
    first."""
    return torch.argsort(-score, stable=True)[:k]


def _bg_subtract(xyz_s, bg_s, nn_t, nb_t, min_pts, cc_sub: int = 4,
                 body_z=None, body_gate=None):
    """Strided background subtraction -> foreground mask [Hs, Ws].

    The stencil runs at the strided resolution; the component min-size
    filter on a ``cc_sub``-times coarser grid.  With ``body_gate`` > 0,
    components whose mean depth is farther than that from ``body_z`` are
    rejected too (an occluder is a new component at the wrong depth).
    """
    fg = _foreground_mask(bg_s, xyz_s, nn_t)
    if cc_sub <= 1:
        fg_c, xyz_c = fg, xyz_s
    else:
        fg_c = fg[::cc_sub, ::cc_sub]
        xyz_c = xyz_s[::cc_sub, ::cc_sub]

    labels = cc.connected_components(fg_c, values=xyz_c,
                                     edge_gate_fn=cc.Dist2Gate(nb_t * cc_sub))
    sizes = cc.component_sizes(labels)
    flat = labels.reshape(-1)
    fidx = torch.clamp(flat, min=0).long()
    keep_c = (flat >= 0) & (sizes[fidx] >= min_pts)
    if body_gate is not None and body_z is not None:
        Hc, Wc = fg_c.shape
        idx = torch.where(flat >= 0, flat, Hc * Wc).long()
        zsum = torch.zeros(Hc * Wc + 1, dtype=xyz_c.dtype,
                           device=xyz_c.device).index_add_(
            0, idx, xyz_c[..., 2].reshape(-1))[:-1]
        zmean = zsum / torch.clamp(sizes.to(xyz_c.dtype), min=1)
        near = torch.abs(zmean - body_z) <= body_gate
        keep_c = keep_c & ((body_gate <= 0) | near[fidx])
    keep_c = keep_c.reshape(fg_c.shape)
    if cc_sub <= 1:
        return keep_c & fg
    keep = keep_c.repeat_interleave(cc_sub, 0).repeat_interleave(cc_sub, 1)
    return keep[: fg.shape[0], : fg.shape[1]] & fg


def _fused_frame_impl(ctx: FitContext, ctx_fit: Optional[FitContext],
                      tree: Optional[TreeTensors],
                      parents: Tuple[int, ...], depth: torch.Tensor,
                      labels_full: torch.Tensor, bg_depth: torch.Tensor,
                      intrin4: torch.Tensor, theta0: Theta, com_pre,
                      beta_pose, beta_shape, nn_t, nb_t, min_cc_pts,
                      dist_to_pre_weight, seg_stride: int,
                      data_substride: int, n_steps: int, num_parts: int,
                      max_depth: int, use_forest: bool, use_bgsub: bool,
                      use_jsr: bool, pad_n: int, seg_window=None,
                      conf_thresh=0.0, point_weight=1.0, plane_weight=0.0,
                      huber_k=1.5, robust_per_part: bool = False,
                      use_render_labels: bool = False, render_tau=0.06,
                      beta_temp=0.0, clamp_angle=0.0, boost_n: int = 0,
                      boost_groups: Tuple[int, ...] = (),
                      freeze_shape: bool = False, fit_sorted: bool = False,
                      wild_n: int = 0, wild_gate=0.12, wild_weight=1.0,
                      sel_walk: float = 0.0, body_gate=0.0,
                      ring_faces: Optional[torch.Tensor] = None,
                      refine_steps: int = 0, refine_beta=0.1,
                      theta_prev: Optional[Theta] = None,
                      extrap=0.0, programs: Optional[dict] = None
                      ) -> FrameOut:
    """One tracked frame.

    depth [H, W]: f32 meters, or uint16 millimeters bit-cast to int16 for
    the upload (converted after striding).  labels_full [H, W] uint8 oracle
    labels (used when ``use_forest`` is off); bg_depth [H, W] background
    depth (used with ``use_bgsub``); intrin4 = [fx, fy, cx, cy].
    ``programs``: the dict in which the fits keep their LM programs and
    graphs (``optim/gauss_newton``; the tracker's own).
    """
    dev = depth.device
    fx, fy, cx, cy = intrin4[0], intrin4[1], intrin4[2], intrin4[3]

    # constant-velocity warm start; the root-jump detector keeps measuring
    # against the previous fitted pose (theta_in)
    theta_in = theta0
    if theta_prev is not None:
        with scope("glue/extrapolate"):
            theta0 = extrapolate(theta0, theta_prev, extrap)

    def strided_xyz(d_full):
        d_s = d_full[::seg_stride, ::seg_stride]
        if d_s.dtype == torch.int16:        # uint16 mm, bit-cast on upload
            d_s = (d_s.to(torch.int32) & 0xFFFF).to(torch.float32) * 0.001
        Hs, Ws = d_s.shape
        xs = (torch.arange(Ws, dtype=d_s.dtype, device=dev) *
              seg_stride)[None, :]
        ys = (torch.arange(Hs, dtype=d_s.dtype, device=dev) *
              seg_stride)[:, None]
        return torch.stack([(xs - cx) * d_s / fx, (ys - cy) * d_s / fy, d_s],
                           dim=-1)

    with scope("glue/xyz"):
        xyz_s = strided_xyz(depth)                      # [Hs, Ws, 3]
        depth_s = xyz_s[..., 2]
        dtype = depth_s.dtype
        Hs, Ws = depth_s.shape

    if use_bgsub:
        with scope("bgsub"):
            bg_s = strided_xyz(bg_depth)
            # theta0.p is in model space = camera space with y negated, so
            # its z is camera depth
            fg = _bg_subtract(xyz_s, bg_s, nn_t, nb_t, min_cc_pts,
                              body_z=theta0.p[2], body_gate=body_gate)
            depth_s = torch.where(fg, depth_s, 0.0)
            xyz_s = torch.where(fg[..., None], xyz_s, 0.0)

    hard_overflow = torch.zeros((), dtype=torch.float32, device=dev)
    if use_forest:
        multi = tree.u.dim() == 3          # stacked [T, ...] bagged forest
        with scope("glue/walk_setup"):
            tree_scaled = tree._replace(u=tree.u / seg_stride,
                                        v=tree.v / seg_stride)
            bg_lab = to_device(_BG, dev, torch.uint8)

        def walk_set(pys, pxs, pz, pfg, pflat, pshape, ptl, pbr):
            """Conf-gated best label over a pixel set, and the selective
            walk's bucket overflow fraction."""
            walk = lambda ys_, xs_, z_, fg_, trees=None: walk_pixels(
                tree_scaled, ys_, xs_, z_, fg_, pflat, pshape, max_depth,
                ptl, pbr, trees)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            if not multi:
                leaf = walk(pys, pxs, pz, pfg)
                lc = torch.clamp(leaf, min=0).long()
                best1 = tree.leaf_best[lc]
                keep = (leaf >= 0) & (tree.leaf_conf[lc] >=
                                      conf_thresh[best1.long()])
                return torch.where(keep, best1, bg_lab), zero
            T = tree.u.shape[0]
            if sel_walk > 0.0:
                # Selective ensemble walk: tree 0 everywhere; only the
                # low-confidence pixels, compacted into a K/3 bucket, pay
                # for the other trees.  Overflow keeps the gated tree-0
                # label.
                leaf0 = walk(pys, pxs, pz, pfg, (0, 1))[0]
                l0 = torch.clamp(leaf0, min=0).long()
                best0 = tree.leaf_best[0][l0]
                conf0 = torch.where(leaf0 >= 0, tree.leaf_conf[0][l0], 0.0)
                easy = (leaf0 >= 0) & (conf0 >= sel_walk)
                K = leaf0.shape[0]
                K2 = max(-(-(K // 3) // 128) * 128, 128)
                hard = pfg & ~easy
                n_hard = torch.sum(hard.to(torch.float32))
                overflow = (torch.clamp(n_hard - min(K2, K), min=0.0) /
                            torch.clamp(n_hard, min=1.0))
                tie2 = _hash_noise(K, 2654435761, dev)
                hsel = _top_k(hard.to(torch.float32) * 2.0 + tie2, min(K2, K))
                hard_sel = hard[hsel]
                # trees 1..T-1 over the hard pixels: one launch
                leafs_h = walk(pys[hsel], pxs[hsel], pz[hsel], hard_sel,
                               (1, T))
                lf0_h = leaf0[hsel]
                d0_h = torch.where((lf0_h >= 0)[..., None], tree.leaf_data[0][
                    torch.clamp(lf0_h, min=0).long()], 0.0)
                dsum_h = None
                votes_h = None
                for t, lf in enumerate(leafs_h, start=1):
                    dist = torch.where((lf >= 0)[..., None], tree.leaf_data[t][
                        torch.clamp(lf, min=0).long()], 0.0)
                    v = (lf >= 0).to(d0_h.dtype)
                    dsum_h = dist if dsum_h is None else dsum_h + dist
                    votes_h = v if votes_h is None else votes_h + v
                votes_h = votes_h + (lf0_h >= 0)
                dsum_h = dsum_h + d0_h
                conf_h = torch.max(dsum_h, -1).values / torch.clamp(
                    votes_h, min=1.0)
                best_h = torch.argmax(dsum_h, -1).to(torch.uint8)
                keep_h = hard_sel & (votes_h > 0) & (
                    conf_h >= conf_thresh[best_h.long()])
                lab_h = torch.where(keep_h, best_h, bg_lab)
                keep0 = (leaf0 >= 0) & (conf0 >= conf_thresh[best0.long()])
                lab = torch.where(keep0, best0, bg_lab)
                lab[hsel] = torch.where(hard_sel, lab_h, lab[hsel])
                return lab, overflow
            # multi-tree: average leaf distributions over trees
            # (reference rtree-run.cpp:92-121), then argmax + gate
            dsum = votes = None
            for t, lf in enumerate(walk(pys, pxs, pz, pfg, (0, T))):
                dist = torch.where((lf >= 0)[..., None], tree.leaf_data[t][
                    torch.clamp(lf, min=0).long()], 0.0)
                v = (lf >= 0).to(dist.dtype)
                dsum = dist if dsum is None else dsum + dist
                votes = v if votes is None else votes + v
            conf = torch.max(dsum, -1).values / torch.clamp(votes, min=1.0)
            best = torch.argmax(dsum, -1).to(torch.uint8)
            keep = (votes > 0) & (conf >= conf_thresh[best.long()])
            return torch.where(keep, best, bg_lab), zero

        with scope("forest_walk"):
            if seg_window is not None:
                # walk only inside a window centred on the previous frame's
                # part centres
                wh, ww = seg_window
                has_com = com_pre[0] >= 0
                n_com = torch.clamp(torch.sum(has_com.to(dtype)), min=1.0)
                ccx = torch.sum(torch.where(has_com, com_pre[0], 0.0)) / n_com
                ccy = torch.sum(torch.where(has_com, com_pre[1], 0.0)) / n_com
                any_com = torch.any(has_com)
                ccx = torch.where(any_com, ccx / seg_stride, Ws / 2.0)
                ccy = torch.where(any_com, ccy / seg_stride, Hs / 2.0)
                oy = torch.clamp(ccy.to(torch.int32) - wh // 2, 0, Hs - wh)
                ox = torch.clamp(ccx.to(torch.int32) - ww // 2, 0, Ws - ww)
                with scope("sync"), host_sync():
                    oy, ox = torch.stack([oy, ox]).tolist()
                region = depth_s[oy:oy + wh, ox:ox + ww]
                roy, rox, rw = oy, ox, ww
            else:
                region, roy, rox, rw = depth_s, 0, 0, Ws
            # compact the region's foreground into a static bucket (overflow
            # drops pixels by the hash-noise tie-break) and walk only those
            WALK_K = 3072 if seg_window is not None else 4096
            rflat = region.reshape(-1).contiguous()
            rfg = rflat > 0
            tie = _hash_noise(rflat.shape[0], 2654435761, dev)
            sel = _top_k(rfg.to(torch.float32) * 2.0 + tie,
                         min(WALK_K, rflat.shape[0]))
            fg_sel = rfg[sel]
            z_sel = rflat[sel]
            ys_sel = roy + sel // rw
            xs_sel = rox + sel % rw
            if seg_window is not None:
                # probes read the window slab in window-local coordinates
                Hr = region.shape[0]
                lab_sel, hard_overflow = walk_set(
                    sel // rw, sel % rw, z_sel, fg_sel, rflat, (Hr, rw),
                    (0, 0), (rw - 1, Hr - 1))
                Hl, Wl = seg_window
                pos = torch.where(fg_sel, sel, Hl * Wl)
                lab_oy, lab_ox = roy, rox
            else:
                lab_sel, hard_overflow = walk_set(
                    ys_sel, xs_sel, z_sel, fg_sel,
                    depth_s.reshape(-1).contiguous(),
                    (Hs, Ws), (0, 0), (Ws - 1, Hs - 1))
                Hl, Wl = Hs, Ws
                pos = torch.where(fg_sel, ys_sel * Ws + xs_sel, Hs * Ws)
                lab_oy, lab_ox = 0, 0
            labels_s = torch.full((Hl * Wl + 1,), _BG, dtype=torch.uint8,
                                  device=dev).index_put_((pos,), lab_sel)[:-1]
            labels_s = labels_s.reshape(Hl, Wl)
            depth_l = region if seg_window is not None else depth_s
    else:
        labels_s = labels_full[::seg_stride, ::seg_stride]
        labels_s = torch.where(depth_s > 0, labels_s,
                               torch.full_like(labels_s, _BG))
        lab_oy, lab_ox = 0, 0
        depth_l = depth_s

    with scope("glue/centroids"):
        model_com = torch.full((num_parts, 5), -1.0, dtype=dtype, device=dev)
        if use_forest:
            # per-part model centroids at theta0 (the host-side limb
            # recovery's mis-aim test)
            x_prev0 = _forward(ctx, parents, theta0, use_jsr)[0]
            proj0 = project_points(x_prev0, fx, fy, cx, cy)
            gacc = torch.zeros((num_parts + 1, 6), dtype=dtype,
                               device=dev).index_add_(
                0, torch.clamp(ctx.model_part, 0, num_parts).long(),
                torch.cat([proj0, x_prev0, torch.ones_like(proj0[:, :1])], 1))
            gn = torch.clamp(gacc[:num_parts, 5:], min=1.0)
            model_com = torch.where(gacc[:num_parts, 5:] > 0,
                                    gacc[:num_parts, :5] / gn, -1.0)

    with scope("glue/splat"):
        if use_render_labels:
            # splat the previous pose's vertices into a z-buffer on the
            # label grid (scatter-min of (depth << 8 | part) + 3x3 min-pool)
            # and trust the splatted label where the measured depth agrees
            Hl, Wl = labels_s.shape
            zq = torch.clamp(x_prev0[:, 2] / 20.0 * float(1 << 17), 1.0,
                             float((1 << 17) - 1)).to(torch.int32)
            key = (zq << 8) | ctx.model_part.to(torch.int32)
            px = torch.round(proj0[:, 0]).to(torch.int32) - lab_ox
            py = torch.round(proj0[:, 1]).to(torch.int32) - lab_oy
            ok_v = (px >= 0) & (px < Wl) & (py >= 0) & (py < Hl) & (
                x_prev0[:, 2] > 1e-6)
            flat = torch.where(ok_v, py * Wl + px, Hl * Wl).long()
            zbuf = torch.full((Hl * Wl + 1,), _IMAX, dtype=torch.int32,
                              device=dev).scatter_reduce(
                0, flat, key, "amin", include_self=True)[:-1].reshape(Hl, Wl)
            zp = torch.full((Hl + 2, Wl + 2), _IMAX, dtype=torch.int32,
                            device=dev)
            zp[1:-1, 1:-1] = zbuf
            pooled = zbuf
            for dy in (0, 1, 2):
                for dx in (0, 1, 2):
                    if dy == 1 and dx == 1:
                        continue
                    pooled = torch.minimum(pooled, zp[dy:dy + Hl, dx:dx + Wl])
            hit = pooled != _IMAX
            rl = torch.where(hit, (pooled & 0xFF).to(torch.uint8),
                             torch.full_like(labels_s, _BG))
            rd = torch.where(hit, (pooled >> 8).to(dtype) *
                             (20.0 / float(1 << 17)), 0.0)
            agree = (depth_l > 0) & hit & (
                torch.abs(depth_l - rd) < render_tau)
            labels_s = torch.where(agree, rl, labels_s)

    # blob suppression + CoM tracking on a 2x coarser grid; the origin keeps
    # the returned CoMs in full-grid pixel coordinates
    blob_sub = 2
    lab_c = labels_s[::blob_sub, ::blob_sub]
    with scope("blob_suppress"):
        filt_c, com_new = suppress_part_nonmax(
            lab_c, com_pre, num_parts, seg_stride * blob_sub,
            dist_to_pre_weight, (lab_ox * seg_stride, lab_oy * seg_stride))
    with scope("glue/sample"):
        filt_up = filt_c.repeat_interleave(blob_sub, 0).repeat_interleave(
            blob_sub, 1)[: labels_s.shape[0], : labels_s.shape[1]]
        labels_s = torch.where(filt_up == labels_s, labels_s,
                               torch.full_like(labels_s, _BG))

        # stride-sampled data cloud (inside the window when one is active)
        if use_forest and seg_window is not None:
            xyz_src = xyz_s[oy:oy + seg_window[0], ox:ox + seg_window[1]]
        else:
            xyz_src = xyz_s
        lab_src = labels_s
        sub_xyz = xyz_src[::data_substride, ::data_substride]
        sub_lab = lab_src[::data_substride, ::data_substride]
        pts = sub_xyz.reshape(-1, 3)
        pts = torch.stack([pts[:, 0], -pts[:, 1], pts[:, 2]], dim=1)
        parts = sub_lab.reshape(-1).to(torch.int32)
        parts = torch.where((sub_xyz[..., 2] > 0).reshape(-1), parts, -1)
        parts = torch.where(parts == _BG, -1, parts)

        def topk_samples(is_x, mult, k):
            noise = _hash_noise(is_x.shape[0], mult, dev)
            top = _top_k(is_x.to(torch.float32) * 2.0 + noise, k)
            px_ = xyz_src.reshape(-1, 3)[top]
            return top, torch.stack([px_[:, 0], -px_[:, 1], px_[:, 2]], dim=1)

        if boost_n:
            # extremity-dense samples of the boosted groups at full
            # segmentation resolution
            flat_lab = lab_src.reshape(-1).to(torch.int32)
            is_b = torch.zeros(flat_lab.shape, dtype=torch.bool, device=dev)
            for g in boost_groups:
                is_b = is_b | (flat_lab == g)
            is_b = is_b & (xyz_src[..., 2].reshape(-1) > 0)
            top, bpts = topk_samples(is_b, 2654435761, boost_n)
            pts = torch.cat([pts, bpts])
            parts = torch.cat([parts,
                               torch.where(is_b[top], flat_lab[top], -1)])

        if wild_n and use_forest:
            # wildcard channel: foreground whose forest label was gated to
            # background becomes label-free ICP support (part id == num_parts)
            flat_lab_w = lab_src.reshape(-1).to(torch.int32)
            is_w = (flat_lab_w == _BG) & (xyz_src[..., 2].reshape(-1) > 0)
            topw, wpts = topk_samples(is_w, 2246822519, wild_n)
            pts = torch.cat([pts, wpts])
            parts = torch.cat([parts, torch.where(
                is_w[topw], num_parts, -1).to(torch.int32)])

        n_points = torch.sum(((parts >= 0) & (parts < num_parts)).to(
            torch.int32))
        # body-consistent foreground count in data-grid units (loss detection)
        if use_bgsub:
            n_fg = (torch.sum((depth_s > 0).to(torch.float32)) /
                    float(data_substride * data_substride))
        else:
            n_fg = torch.zeros((), dtype=torch.float32, device=dev)

        N = pts.shape[0]
        if N < pad_n:
            pts = torch.cat([pts, torch.zeros((pad_n - N, 3), dtype=pts.dtype,
                                              device=dev)])
            parts = torch.cat([parts, torch.full(
                (pad_n - N,), -1, dtype=torch.int32, device=dev)])

    with scope("fit"):
        theta, diag = fit(
            ctx_fit if ctx_fit is not None else ctx, parents,
            pts.contiguous(), parts.contiguous(), theta0, beta_pose,
            beta_shape, n_steps=n_steps, use_jsr=use_jsr,
            num_parts=num_parts, point_weight=point_weight,
            plane_weight=plane_weight, huber_k=huber_k,
            robust_per_part=robust_per_part, beta_temp=beta_temp,
            clamp_angle=clamp_angle, freeze_shape=freeze_shape,
            model_sorted=fit_sorted and ctx_fit is not None,
            wild_gate=wild_gate, wild_weight=wild_weight, programs=programs)
    if refine_steps > 0 and ring_faces is not None:
        # per-frame exactness stage: re-fit the SAME data bucket against the
        # mesh surface from the tracked pose, with the full model context
        # and the priors scaled down by refine_beta
        with scope("refine"):
            theta, _ = fit_refine(
                ctx, parents, ring_faces, pts.contiguous(),
                parts.contiguous(), theta, beta_pose * refine_beta,
                beta_shape * refine_beta, n_steps=refine_steps,
                num_parts=num_parts, wild=num_parts,
                wild_gate2=wild_gate * wild_gate, freeze_shape=freeze_shape,
                programs=programs)
    with scope("glue/diag"):
        host_diag = torch.cat([
            n_points[None].to(dtype), diag.cost[None].to(dtype),
            diag.n_matched[None].to(dtype), diag.part_counts.to(dtype),
            com_new.to(dtype).reshape(-1), model_com.to(dtype).reshape(-1),
            torch.linalg.norm(theta.p - theta_in.p)[None].to(dtype),
            n_fg[None].to(dtype), hard_overflow[None].to(dtype)])
        if use_forest and seg_window is not None:
            labels_out = torch.full((Hs, Ws), _BG, dtype=torch.uint8,
                                    device=dev)
            labels_out[oy:oy + labels_s.shape[0],
                       ox:ox + labels_s.shape[1]] = labels_s
        else:
            labels_out = labels_s
    return FrameOut(theta=theta, com_pre=com_new, labels_strided=labels_out,
                    host_diag=host_diag)


def fused_frames_batch(ctx: FitContext, ctx_fit: Optional[FitContext],
                       tree: Optional[TreeTensors],
                       parents: Tuple[int, ...], depth_b: torch.Tensor,
                       labels_b: torch.Tensor, bg_depth: torch.Tensor,
                       intrin4: torch.Tensor, theta0: Theta, com_pre,
                       theta_prev0: Optional[Theta] = None, **frame_kw):
    """Track a batch of consecutive frames, ``depth_b`` [B, H, W] and
    ``labels_b`` [B, H, W], each frame through ``_fused_frame_impl`` with
    the keyword arguments ``frame_kw`` (those after ``com_pre``, without
    ``theta_prev``), carrying (theta, theta_prev, com_pre) from frame to
    frame as the reference's scan does.  Returns (thetas with a leading
    batch axis, host_diag [B, D], the last theta, the last com_pre, the
    last velocity anchor); the label images are not kept."""
    th, com = theta0, com_pre
    th_prev = theta0 if theta_prev0 is None else theta_prev0
    thetas, diags = [], []
    for d_i, l_i in zip(depth_b, labels_b):
        with scope(FRAME_SCOPE):
            out = _fused_frame_impl(ctx, ctx_fit, tree, parents, d_i, l_i,
                                    bg_depth, intrin4, th, com,
                                    theta_prev=th_prev, **frame_kw)
        th_prev, th, com = th, out.theta, out.com_pre
        thetas.append(out.theta)
        diags.append(out.host_diag)
    return (Theta(*(torch.stack(f) for f in zip(*thetas))),
            torch.stack(diags), th, com, th_prev)


def _group_tree(t: TreeTensors, lut: np.ndarray, ng: int) -> TreeTensors:
    """Fold a tree's leaf part distributions into matching groups (argmax
    and confidence recomputed group-wise)."""
    ld = t.leaf_data.cpu().numpy()
    if ld.size == 0:
        return t
    gld = fold_leaf_data(ld, lut, ng)
    return _with_leaves(t, gld)


def _with_leaves(t: TreeTensors, ld: np.ndarray) -> TreeTensors:
    dev = t.leaf_data.device
    return t._replace(
        leaf_data=torch.as_tensor(ld, device=dev),
        leaf_best=torch.as_tensor(ld.argmax(1).astype(np.uint8), device=dev),
        leaf_conf=torch.as_tensor(ld.max(1).astype(np.float32), device=dev))


def _reweight_tree(t: TreeTensors, alpha: float) -> TreeTensors:
    """Inference-side class rebalancing: scale leaf distributions by
    inverse class frequency^alpha (frequency estimated as the mean leaf
    distribution) and renormalize."""
    ld = t.leaf_data.cpu().numpy()
    if ld.size == 0 or alpha <= 0:
        return t
    freq = ld.mean(axis=0)
    freq = freq / max(freq.sum(), 1e-12)
    w = np.power(np.maximum(freq, 1e-6), -alpha)
    g = ld * w
    g = g / np.maximum(g.sum(axis=1, keepdims=True), 1e-12)
    return _with_leaves(t, g.astype(np.float32))


def _stack_trees(trees, stride: int) -> TreeTensors:
    """Stack per-tree tensors into [T, ...] (node and leaf axes padded to
    the largest tree; padding nodes self-loop, padding leaves are zero)."""
    Nmax = max(t.u.shape[0] for t in trees)
    Lmax = max(t.leaf_data.shape[0] for t in trees)

    def pad(a, n, fill):
        if n == 0:
            return a
        return torch.cat([a, torch.full((n,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    stacked = []
    for t in trees:
        n = t.u.shape[0]
        lpad = Lmax - t.leaf_data.shape[0]
        self_idx = torch.arange(n, Nmax, dtype=torch.int32, device=t.u.device)
        stacked.append(TreeTensors(
            u=pad(t.u / stride, Nmax - n, 0.0),
            v=pad(t.v / stride, Nmax - n, 0.0),
            thresh=pad(t.thresh, Nmax - n, 0.0),
            lnode=torch.cat([t.lnode, self_idx]),
            rnode=torch.cat([t.rnode, self_idx]),
            leafid=pad(t.leafid, Nmax - n, -1),
            leaf_data=pad(t.leaf_data, lpad, 0.0),
            leaf_best=pad(t.leaf_best, lpad, 0),
            leaf_conf=pad(t.leaf_conf, lpad, 0.0)))
    return TreeTensors(*[torch.stack([getattr(s, f) for s in stacked])
                         for f in TreeTensors._fields])


class FusedTracker:
    """Per-frame tracker on ``model.device`` (same semantics as the
    reference's ``FusedTracker``; forest or oracle labels)."""

    def __init__(self, model: AvatarModel, intrin, image_size, rtree=None,
                 config: Optional[TrackerConfig] = None):
        """rtree: an RTree, or a sequence of RTrees for a bagged forest
        whose leaf distributions are averaged at inference."""
        self.model = model
        self.device = model.device
        self.intrin = intrin
        self.image_size = tuple(image_size)
        self.config = config or TrackerConfig()
        rtrees = (list(rtree) if isinstance(rtree, (list, tuple))
                  else ([rtree] if rtree is not None else []))
        rtree = rtrees[0] if rtrees else None
        self.rtree = rtree
        self.ava = Avatar(model)
        self.timer = StageTimer()
        self._metrics_file = None
        self._metrics_frame = 0
        dev, dt = self.device, model.dtype
        tt = lambda a, dtype=dt: torch.as_tensor(a, dtype=dtype, device=dev)

        num_parts = rtree.num_parts if rtree is not None else model.num_joints()
        part_map = joint_parts(rtree.part_map if rtree is not None else None,
                               model.num_joints(), num_parts)
        model_part = part_map[model.main_joint]
        # group-level correspondence: fold model parts, forest leaves and
        # oracle masks through the group LUT
        self._glut = None
        tree_grouped = False
        if self.config.part_groups is not None:
            self._glut = np.asarray(self.config.part_groups, np.int32)
            ng = int(self._glut.max()) + 1
            tree_grouped = (rtree is not None and np.array_equal(
                part_map[:len(self._glut)], self._glut))
            if not tree_grouped:
                if part_map.max() >= len(self._glut):
                    raise ValueError(
                        f"the part groups cover {len(self._glut)} parts; "
                        f"the part map sends joints to parts up to "
                        f"{part_map.max()}")
                model_part = self._glut[model_part]
            num_parts = ng
        self.num_parts = num_parts
        if model.pose_prior is None:
            raise ValueError("FusedTracker requires a model pose prior")
        pp = model.pose_prior
        self._ctx = FitContext(
            lbs=model.params, anc_mask=tt(model.ancestor_mask),
            faces=tt(model.faces, torch.int32),
            model_part=tt(model_part, torch.int32),
            prior=PriorData(pp.means, pp.prec_cho, pp.consts_log))
        # part-sorted fit context over every fvs-th vertex, with rest-pose
        # normals precomputed on the full mesh: the NN plan's model
        # permutation becomes the identity
        fvs = max(1, int(getattr(self.config, "fit_vertex_stride", 1)))
        self._ctx_fit = None
        self._fit_sorted = False
        if fvs == 1 or model.use_joint_shape_regressor:
            lp = model.params
            vt = lp.v_template.cpu().numpy()
            fc = np.asarray(model.faces)
            fn = np.cross(vt[fc[:, 1]] - vt[fc[:, 0]],
                          vt[fc[:, 2]] - vt[fc[:, 0]])
            n0 = np.zeros_like(vt)
            for k in range(3):
                np.add.at(n0, fc[:, k], fn)
            n0 /= np.maximum(np.linalg.norm(n0, axis=1, keepdims=True),
                             1e-12)
            sel = np.arange(0, vt.shape[0], fvs)
            idx = sel[np.argsort(model_part[sel], kind="stable")]
            lbs_sub = LBSParams(
                v_template=tt(vt[idx]),
                shapedirs=tt(lp.shapedirs.cpu().numpy()[idx]),
                weights=tt(lp.weights.cpu().numpy()[idx]),
                joint_reg=tt(lp.joint_reg.cpu().numpy()[:, idx]),
                joint_shape_reg_base=lp.joint_shape_reg_base,
                joint_shape_reg=lp.joint_shape_reg)
            self._ctx_fit = self._ctx._replace(
                lbs=lbs_sub, model_part=tt(model_part[idx], torch.int32),
                n_rest=tt(n0[idx]))
            self._fit_sorted = True
        self._max_depth = max((t._max_depth for t in rtrees), default=0)
        self._use_bgsub = False
        self.com_pre = self._com0()
        self.reinit = True
        self.first_init = True
        self._lost_count = 0      # consecutive coasted (root-jump) frames
        self._lost_frames = 0     # frames since tracking was lost
        self._last_root_z = None  # last-known body camera depth (m)
        self._frame_no = 0        # steady-state frames (refine cadence)
        self._shape_refit_in: Optional[int] = None
        self._programs = {}   # the fits' LM programs (optim/gauss_newton)
        self._ring = (torch.as_tensor(vertex_face_rings(
            model.faces, model.num_points()), device=dev)
            if self.config.refine_every > 0 else None)
        self._starve = np.zeros(num_parts, np.int32)
        self.limb_recoveries: dict = {}
        J = model.num_joints()
        self._theta = Theta(p=tt(np.zeros(3)),
                            rots=tt(np.tile(np.eye(3), (J, 1, 1))),
                            w=tt(np.zeros(model.num_shape_keys())))
        # one frame behind self._theta: the warm start's velocity anchor
        self._theta_prev = self._theta
        # the batch and async modes: the last batch's poses [B, ...], the
        # batches and frames in flight
        self.batch_thetas: Optional[Theta] = None
        self._batch_q: list = []
        self._pending_q: list = []

        c = self.config
        H, W = self.image_size
        ss = c.rtree_interval
        # the host pre-strides every frame before upload; the device runs
        # on the strided grid with scaled intrinsics and probe offsets
        self._host_stride = ss
        self._proc_size = ((H + ss - 1) // ss, (W + ss - 1) // ss)
        self._seg_stride = 1
        self._intrin4 = tt([intrin.fx / ss, intrin.fy / ss, intrin.cx / ss,
                            intrin.cy / ss])
        trees_t = []
        for rt in rtrees:
            t = TreeTensors(*(a.to(dev) for a in rt._tree))
            if self._glut is not None and rt.num_parts == len(self._glut):
                t = _group_tree(t, self._glut, self.num_parts)
            elif self._glut is not None and rt.num_parts != self.num_parts:
                raise ValueError(
                    f"tree with {rt.num_parts} parts fits neither the "
                    f"source ({len(self._glut)}) nor group "
                    f"({self.num_parts}) label space")
            if c.label_class_balance > 0:
                t = _reweight_tree(t, c.label_class_balance)
            trees_t.append(t)
        if len(trees_t) > 1:
            self._tree = _stack_trees(trees_t, ss)
        elif trees_t:
            t = trees_t[0]
            self._tree = t._replace(u=t.u / ss, v=t.v / ss)
        else:
            self._tree = None
        self._bg = torch.zeros(self._proc_size, dtype=dt, device=dev)
        self._zero_labels = torch.zeros(self._proc_size, dtype=torch.uint8,
                                        device=dev)
        dsub = max(c.data_interval // ss, 1)
        self._data_substride = dsub
        self._boost_cfg = c.extremity_boost_n if self._glut is not None else 0
        self._wild_cfg = (c.wild_n if self._glut is not None
                          and self._tree is not None else 0)
        Hs, Ws = self._proc_size
        n_data = ((Hs + dsub - 1) // dsub) * ((Ws + dsub - 1) // dsub)
        self._pad_n, self._boost_n, self._wild_n = self._fit_bucket(n_data)
        self._run_consts = None

    def _com0(self) -> torch.Tensor:
        return to_device(np.concatenate(
            [np.full((1, self.num_parts), -1.0),
             np.zeros((1, self.num_parts))]), self.device, self.model.dtype)

    def _fit_bucket(self, n_data: int) -> Tuple[int, int, int]:
        """(pad_n, boost_n, wild_n) for a fit over ``n_data`` grid samples:
        a power-of-two bucket, boost and wildcards clamped into its slack
        unless doubling it would be mostly padding."""
        want_b = self._boost_cfg
        want_w = self._wild_cfg
        pad = 1024
        while pad < n_data:
            pad *= 2
        slack = pad - n_data
        want = want_b + want_w
        if want > slack and slack < want // 2:
            pad *= 2
            slack = pad - n_data
        boost_n = min(want_b, slack)
        return pad, boost_n, min(want_w, slack - boost_n)

    def _pre_stride(self, arr: np.ndarray) -> np.ndarray:
        s = self._host_stride
        return arr if s == 1 else np.ascontiguousarray(arr[::s, ::s])

    def _map_labels(self, labels: np.ndarray) -> np.ndarray:
        """Host-side part -> group mapping of an oracle label image."""
        if self._glut is None:
            return labels
        return group_label_lut(self._glut)[labels]

    def set_background(self, background_xyz: np.ndarray) -> None:
        """Accepts an XYZ map [H, W, 3] or a depth map [H, W] (meters)."""
        bg = np.asarray(background_xyz)
        if bg.ndim == 3:
            bg = bg[..., 2]
        self._bg = torch.as_tensor(self._pre_stride(bg),
                                   dtype=self.model.dtype, device=self.device)
        self._use_bgsub = True

    def _consts(self) -> dict:
        """Per-config device scalars, built once."""
        if self._run_consts is None:
            c = self.config
            H, W = self.image_size
            hs = self._host_stride
            scale = 1200000.0 / (H * W)
            min_cc = max(H * W // 1000, 100) // (hs * hs * 16)
            t = lambda v, dtype=self.model.dtype: to_device(v, self.device,
                                                            dtype)
            consts = dict(
                beta_pose=t(c.beta_pose), beta_shape=t(c.beta_shape),
                nn_t=t(scale * c.nn_dist_thresh_rel),
                nb_t=t(scale * c.neighb_thresh_rel),
                min_cc=t(min_cc, torch.int32), d2p=t(c.dist_to_pre_weight),
                point_weight=t(c.point_weight),
                plane_weight=t(c.plane_weight), huber_k=t(c.huber_k),
                render_tau=t(c.render_label_tau), beta_temp=t(c.beta_temp),
                clamp_angle=t(c.pose_clamp_angle), wild_gate=t(c.wild_gate),
                wild_weight=t(c.wild_weight), body_gate=t(c.body_gate),
                refine_beta=t(c.refine_beta), extrap=t(c.extrapolate_pose),
                zero=t(0.0))
            # per-group confidence gate (relaxed groups only mean anything
            # when group matching is on)
            cv = np.full(self.num_parts, c.label_conf_thresh, np.float32)
            if self._glut is not None:
                for g in c.label_conf_low_groups:
                    if 0 <= g < self.num_parts:
                        cv[g] = c.label_conf_low
            consts["conf_vec"] = to_device(cv, self.device)
            self._run_consts = consts
        return self._run_consts

    def _run(self, xyz, labels, n_steps, use_window=True,
             render_labels=True, is_reinit=False, reinit_gated=False,
             refine=False, fit_shape=False) -> FrameOut:
        """One pass through the pipeline (inside the caller's ``frame``
        root)."""
        kw = self._frame_kwargs(n_steps, use_window, render_labels,
                                is_reinit, reinit_gated, refine, fit_shape)
        return _fused_frame_impl(
            self._ctx, self._ctx_fit, self._tree, self.model.parents, xyz,
            labels, self._bg, self._intrin4, self._theta, self.com_pre,
            **kw)

    def _frame_kwargs(self, n_steps, use_window=True, render_labels=True,
                      is_reinit=False, reinit_gated=False, refine=False,
                      fit_shape=False) -> dict:
        """The keyword arguments of ``_fused_frame_impl`` after
        ``com_pre`` for one frame of this tracker (``theta_prev`` is the
        tracker's velocity anchor)."""
        c = self.config
        hs = self._host_stride
        window = None
        pad_n, boost_n, wild_n = self._pad_n, self._boost_n, self._wild_n
        if use_window and c.seg_window is not None and self.rtree is not None:
            Hs, Ws = self._proc_size
            window = (min(c.seg_window[0] // hs, Hs),
                      min(c.seg_window[1] // hs, Ws))
            dsub = self._data_substride
            n_data = (-(-window[0] // dsub)) * (-(-window[1] // dsub))
            pad_n, boost_n, wild_n = self._fit_bucket(n_data)
        k = self._consts()
        return dict(
            beta_pose=k["beta_pose"], beta_shape=k["beta_shape"],
            nn_t=k["nn_t"], nb_t=k["nb_t"], min_cc_pts=k["min_cc"],
            dist_to_pre_weight=k["d2p"], seg_stride=self._seg_stride,
            data_substride=self._data_substride, n_steps=n_steps,
            num_parts=self.num_parts, max_depth=self._max_depth,
            use_forest=self.rtree is not None, use_bgsub=self._use_bgsub,
            use_jsr=self.model.use_joint_shape_regressor, pad_n=pad_n,
            seg_window=window, conf_thresh=k["conf_vec"],
            point_weight=k["point_weight"], plane_weight=k["plane_weight"],
            huber_k=k["huber_k"], robust_per_part=c.robust_per_part,
            use_render_labels=(render_labels and c.render_labels and
                               self.rtree is not None),
            render_tau=k["render_tau"],
            # the temporal prior and the motion clamp would fight the
            # exploration a reinit fit exists to do
            beta_temp=k["zero"] if is_reinit else k["beta_temp"],
            clamp_angle=k["zero"] if is_reinit else k["clamp_angle"],
            boost_n=boost_n, boost_groups=tuple(c.extremity_boost_groups),
            # steady-state frames solve in the reduced [dp | dr] tangent
            freeze_shape=not (is_reinit or fit_shape),
            fit_sorted=self._fit_sorted, wild_n=wild_n,
            wild_gate=k["wild_gate"], wild_weight=k["wild_weight"],
            sel_walk=float(c.selective_walk),
            # no valid prior pose during a cold (re)init -> gate off
            body_gate=(k["body_gate"] if (not is_reinit or reinit_gated)
                       else k["zero"]),
            ring_faces=self._ring if refine else None,
            refine_steps=c.refine_steps if refine else 0,
            refine_beta=k["refine_beta"],
            theta_prev=self._theta if is_reinit else self._theta_prev,
            extrap=k["extrap"], programs=self._programs)

    # the per-frame tracking state, all of which warmup() leaves untouched
    _WARM_STATE = ("_theta", "_theta_prev", "com_pre", "reinit", "first_init",
                   "_frame_no", "_lost_count", "_lost_frames",
                   "_shape_refit_in", "_last_root_z", "_starve",
                   "limb_recoveries", "_metrics_file", "_metrics_frame",
                   "batch_thetas", "_batch_q", "_pending_q")

    def warmup(self, frame, labels_override=None, batch: int = 0) -> None:
        """Run every variant of ``track`` the tracking loop can reach on
        ``frame``: the reinit, the steady state, the one-shot post-reinit
        shape refit (``config.shape_refit_after``) and the periodic surface
        refine (``config.refine_every``); with ``batch`` > 0 also
        ``track_batch`` over ``batch`` copies of ``frame``.  The first real
        frame then pays for none of what a process pays once: the build and
        load of the NN kernel, the allocator's pools, the NN scratch of each
        fit bucket, the cuBLAS and cuSOLVER handles, and the capture of
        each of its fits' LM steps as CUDA graphs.  The per-frame tracking
        state (the batch and async modes' included), the stage timer and an
        open metrics log are as before afterwards.  Call after
        ``set_background``."""
        c = self.config
        snap = {k: getattr(self, k) for k in self._WARM_STATE}
        snap["_starve"] = self._starve.copy()
        snap["limb_recoveries"] = dict(self.limb_recoveries)
        snap["_batch_q"] = list(self._batch_q)
        snap["_pending_q"] = list(self._pending_q)
        stats = {k: list(v) for k, v in self.timer.stats.items()}
        self._metrics_file = None        # keep warmup out of the log
        try:
            self.reinit = True
            self.track(frame, labels_override)        # reinit
            self.reinit = False
            self._shape_refit_in = None
            # a frame number whose successor is no refine frame, wherever
            # there is one (refine_every == 1 refines every frame)
            self._frame_no = 0
            self.track(frame, labels_override)        # steady state
            if c.shape_refit_after > 0:
                self.reinit = False
                self._shape_refit_in = 0
                self._frame_no = 0
                self.track(frame, labels_override)    # shape refit
            if c.refine_every > 0:
                self.reinit = False
                self._shape_refit_in = None
                self._frame_no = c.refine_every - 1
                self.track(frame, labels_override)    # periodic refine
            if batch > 0:
                self.reinit = False
                self._shape_refit_in = None
                self.track_batch([frame] * batch,
                                 None if labels_override is None
                                 else [labels_override] * batch)
        finally:
            for k, v in snap.items():
                setattr(self, k, v)
            self.timer.stats = stats

    def _upload(self, depth_np: np.ndarray) -> torch.Tensor:
        if depth_np.dtype == np.uint16:
            # bit-cast to int16 for the upload; _fused_frame_impl widens
            # back to uint16 values after striding
            return to_device(np.ascontiguousarray(depth_np).view(np.int16),
                             self.device)
        return to_device(np.ascontiguousarray(depth_np), self.device,
                         self.model.dtype)

    def _upload_labels(self, labels_override) -> torch.Tensor:
        if labels_override is None:
            return self._zero_labels
        return to_device(self._map_labels(self._pre_stride(
            np.asarray(labels_override))), self.device, torch.uint8)

    def track(self, frame, labels_override: Optional[np.ndarray] = None
              ) -> TrackResult:
        """Track one frame: an XYZ map [H, W, 3], a float depth map [H, W]
        in meters, or a uint16 depth map in millimeters."""
        with scope(FRAME_SCOPE):
            return self._track(frame, labels_override)

    def _track(self, frame, labels_override) -> TrackResult:
        c = self.config
        with scope("upload"):
            frame = np.asarray(frame)
            depth_np = frame[..., 2] if frame.ndim == 3 else frame
            depth_np = self._pre_stride(depth_np)
            xyz = self._upload(depth_np)
            labels = self._upload_labels(labels_override)

        min_needed = c.min_points / (c.data_interval ** 2)
        reinitialized = False
        fit_shape = False
        if self.reinit:
            # a failed attempt leaves the tracker coasting on the last good
            # pose, not on the reset seed it planted in self._theta
            theta_keep, com_keep = self._theta, self.com_pre
            theta_prev_keep = self._theta_prev
            with self.timer.stage("reinit"):
                out, diag, gated_lost = self._reinit(depth_np, labels,
                                                     labels_override, xyz)
            if gated_lost:
                self._lost_frames += 1
                self._theta, self.com_pre = theta_keep, com_keep
                self._theta_prev = theta_prev_keep
                return TrackResult(ok=False, n_points=0)
            n_points = diag.n_points
            if n_points < min_needed:
                self._lost_frames += 1
                self._theta, self.com_pre = theta_keep, com_keep
                self._theta_prev = theta_prev_keep
                return TrackResult(ok=False, n_points=n_points)
            self.reinit = False
            self.first_init = False
            reinitialized = True
            self._shape_refit_in = (c.shape_refit_after
                                    if c.shape_refit_after > 0 else None)
        else:
            n_steps = c.frame_icp_iters * c.iters_per_icp
            self._frame_no += 1
            refine = (c.refine_every > 0 and
                      self._frame_no % c.refine_every == 0)
            fit_shape = self._shape_refit_due()
            with self.timer.stage("frame"):
                out = self._run(xyz, labels, n_steps, refine=refine,
                                fit_shape=fit_shape)
                diag = unpack_diag(out.host_diag, self.num_parts)
                n_points = diag.n_points
            if (n_points < min_needed and
                    diag.n_fg < max(2.0, min_needed * c.absent_fg_frac)):
                # person absent or fully occluded: coast and reinitialize
                self.reinit = True
                self._lost_count = 0
                self._lost_frames += 1
                return TrackResult(ok=False, n_points=n_points)
            if c.max_root_jump > 0 and diag.root_jump > c.max_root_jump:
                # the fit teleported: reject the frame, reinit only after
                # repeated failures (reference live-demo.cpp:250-422)
                self._lost_count += 1
                self._lost_frames += 1
                if self._lost_count >= c.lost_reinit_frames:
                    self.reinit = True
                    self._lost_count = 0
                return TrackResult(ok=False, n_points=n_points)
            self._lost_count = 0

        if not reinitialized:
            # post-reinit shape-refit countdown
            if fit_shape:
                self._shape_refit_in = None
            elif self._shape_refit_in is not None:
                self._shape_refit_in -= 1
        with scope("glue/update"):
            # velocity anchor: the previous fitted pose in steady state, the
            # new pose itself right after a reinit
            self._theta_prev = out.theta if reinitialized else self._theta
            self._theta = out.theta
            self.com_pre = out.com_pre
            self._lost_frames = 0
            mz = diag.model_com[:, 4]
            if np.any(mz > 0):
                self._last_root_z = float(np.mean(mz[mz > 0]))
            if not reinitialized:
                self._limb_recovery(diag, depth_np)
            res = TrackResult(ok=True, reinitialized=reinitialized,
                              n_points=n_points,
                              fit_info=self._fit_info(diag))
            self._log_metrics(res)
        return res

    def _reinit(self, depth_np, labels, labels_override, xyz):
        """Host-side reinit: recentre at the cloud centroid and run
        full-image fits from the rest pose and the heaviest GMM component
        means; the lowest cost per match wins.  Returns (out, diag,
        gated_lost)."""
        c = self.config
        dsub = self._data_substride
        hs = self._host_stride
        d_sub = depth_np[::dsub, ::dsub]
        d_sub = (d_sub.astype(np.float32) * 1e-3
                 if d_sub.dtype == np.uint16 else d_sub)
        ys = np.arange(0, d_sub.shape[0]) * dsub * hs
        xs = np.arange(0, d_sub.shape[1]) * dsub * hs
        i = self.intrin
        sub = np.stack([(xs[None, :] - i.cx) * d_sub / i.fx,
                        (ys[:, None] - i.cy) * d_sub / i.fy, d_sub], -1)
        fg = sub[..., 2] > 0
        if labels_override is not None:
            lab = np.asarray(labels_override)[::dsub * hs, ::dsub * hs][
                : fg.shape[0], : fg.shape[1]]
            fg &= lab != _BG
        # gated reinit: while the loss is recent, trust the last-known body
        # depth so an occluder still in frame cannot capture the reinit
        gated = (c.body_gate > 0 and not self.first_init and
                 self._last_root_z is not None and
                 self._lost_frames < c.lost_gated_frames)
        if gated:
            fg &= np.abs(sub[..., 2] - self._last_root_z) <= c.body_gate
            if not fg.any():
                return None, None, True
        centroid = ((sub[fg] * np.array([1, -1, 1])).mean(axis=0)
                    if fg.any() else np.array([0.0, 0.0, 2.5]))
        J = self.model.num_joints()
        rots = np.tile(np.eye(3), (J, 1, 1))
        rots[0] = np.diag([-1.0, 1.0, -1.0])
        seeds = [rots]
        if c.reinit_seeds > 1 and self.model.pose_prior is not None:
            pp = self.model.pose_prior
            wts = host_read(pp.weights)
            means = host_read(pp.means)
            for ci in np.argsort(wts)[::-1][: c.reinit_seeds - 1]:
                aa = means[ci].reshape(J - 1, 3)
                R = rotation.so3_exp(torch.as_tensor(
                    aa, dtype=torch.float32)).numpy()
                seeds.append(np.concatenate([rots[:1], R], axis=0))
        steps = (c.initial_icp_iters if self.first_init
                 else c.reinit_icp_iters) * c.iters_per_icp
        dev, dt = self.device, self.model.dtype
        best = None
        for i, sd in enumerate(seeds):
            self._theta = Theta(
                p=to_device(centroid, dev, dt), rots=to_device(sd, dev, dt),
                w=torch.zeros(self.model.num_shape_keys(), dtype=dt,
                              device=dev))
            self.com_pre = self._com0()
            out_s = self._run(xyz, labels, steps, use_window=False,
                              render_labels=False, is_reinit=True,
                              reinit_gated=gated)
            diag_s = unpack_diag(out_s.host_diag, self.num_parts)
            score = diag_s.cost / max(diag_s.n_matched, 1)
            if best is None or score < best[0]:
                best = (score, out_s, diag_s)
        return best[1], best[2], False

    def _shape_refit_due(self) -> bool:
        return (self._shape_refit_in is not None and
                self._shape_refit_in <= 0)

    # -- the batch and async modes -------------------------------------------

    def _run_batch(self, dep_b, lab_b, n_steps):
        """Run a batch of steady-state frames (``fused_frames_batch``):
        shape frozen, and the surface refine on every frame when
        ``refine_every == 1``, on none otherwise."""
        kw = self._frame_kwargs(n_steps,
                                refine=self.config.refine_every == 1)
        return fused_frames_batch(
            self._ctx, self._ctx_fit, self._tree, self.model.parents, dep_b,
            lab_b, self._bg, self._intrin4, self._theta, self.com_pre,
            theta_prev0=kw.pop("theta_prev"), **kw)

    def track_batch(self, frames, labels_override=None) -> list:
        """Track a list of consecutive frames as one batch: one upload and
        one read of the stacked diagnostics.  No reinit happens inside a
        batch: while the tracker is lost (or its one-shot shape refit is
        due) the head frame goes through ``track`` and the rest is a batch;
        after a loss inside a batch the later frames still get results and
        the next call reinitializes.  Returns a TrackResult per frame; the
        poses stand in ``self.batch_thetas`` with a leading batch axis."""
        if not frames:
            return []
        if self.reinit or self._shape_refit_due():
            head = self.track(frames[0], None if labels_override is None
                              else labels_override[0])
            head_theta = Theta(*(t[None] for t in self._theta))
            rest = self.track_batch(frames[1:], None if labels_override
                                    is None else labels_override[1:])
            # batch_thetas stays aligned with the results: the head's pose
            # leads
            self.batch_thetas = head_theta if not rest else Theta(
                *(torch.cat(p) for p in zip(head_theta, self.batch_thetas)))
            return [head] + rest
        results, self.batch_thetas = self._batch_resolve(
            self._batch_dispatch(frames, labels_override))
        return results

    def _batch_dispatch(self, frames, labels_override) -> dict:
        """Stride and stack a batch, upload it once and run it; the pose
        chain advances to its last frame.  Returns the record
        ``_batch_resolve`` reads."""
        c = self.config
        deps = []
        for f in frames:
            f = np.asarray(f)
            deps.append(self._pre_stride(f[..., 2] if f.ndim == 3 else f))
        with scope("upload"):
            dep_b = self._upload(np.stack(deps))
        if labels_override is None:
            lab_b = torch.zeros((len(frames),) + self._proc_size,
                                dtype=torch.uint8, device=self.device)
        else:
            lab_b = to_device(np.stack([
                self._map_labels(self._pre_stride(np.asarray(lab)))
                for lab in labels_override]), self.device, torch.uint8)
        if self._shape_refit_in is not None:
            # every batch frame runs shape-frozen; an expiring countdown is
            # taken up by the next batch's head frame (track_batch)
            self._shape_refit_in -= len(frames)
        (thetas, diags, self._theta, self.com_pre,
         self._theta_prev) = self._run_batch(
            dep_b, lab_b, c.frame_icp_iters * c.iters_per_icp)
        return dict(diags=diags, thetas=thetas, dep_last=deps[-1])

    def _batch_resolve(self, pending: dict):
        """The host's side of a run batch: one read of its diagnostics,
        then per frame the loss rule, the body depth and a metrics line;
        limb recovery on the last frame.  Returns (results, thetas)."""
        c = self.config
        with scope("diag_read"):
            dn = host_read(pending["diags"])
        min_needed = c.min_points / (c.data_interval ** 2)
        results = []
        for row in dn:
            diag = unpack_diag(row, self.num_parts)
            ok = ((diag.n_points >= min_needed or diag.n_fg >= max(
                2.0, min_needed * c.absent_fg_frac)) and
                (c.max_root_jump <= 0 or diag.root_jump <= c.max_root_jump))
            if not ok:
                # the batch's later frames still get results; the next
                # call reinitializes
                self.reinit = True
                self._lost_frames += 1
            else:
                self._lost_frames = 0
                mz = diag.model_com[:, 4]
                if np.any(mz > 0):
                    self._last_root_z = float(np.mean(mz[mz > 0]))
            results.append(TrackResult(ok=ok, n_points=diag.n_points,
                                       fit_info=self._fit_info(diag)))
            self._log_metrics(results[-1])
        if not self.reinit:
            self._limb_recovery(unpack_diag(dn[-1], self.num_parts),
                                pending["dep_last"])
        return results, pending["thetas"]

    def track_batch_async(self, frames, labels_override=None) -> list:
        """Run this batch and resolve the previous one.  Returns the
        (results, thetas) pairs this call resolved: none on the first call,
        then one per call; on a reinit or a due shape refit the batches in
        flight are resolved first and this batch runs through
        ``track_batch``.  A loss shows one batch late; ``flush_batches``
        resolves the last batch."""
        if not frames:
            return []
        if self.reinit or self._shape_refit_due():
            resolved = self.flush_batches()
            res = self.track_batch(frames, labels_override)
            return resolved + [(res, self.batch_thetas)]
        self._batch_q.append(self._batch_dispatch(frames, labels_override))
        if len(self._batch_q) > 1:
            return [self._batch_resolve(self._batch_q.pop(0))]
        return []

    def flush_batches(self) -> list:
        """Resolve every batch in flight from ``track_batch_async``; returns
        their (results, thetas) pairs."""
        out = []
        while self._batch_q:
            out.append(self._batch_resolve(self._batch_q.pop(0)))
        return out

    def track_async(self, frame, labels_override: Optional[np.ndarray] = None
                    ) -> Optional[TrackResult]:
        """Run this frame and return the result of the frame
        ``config.pipeline_depth`` calls before it (None until there is
        one).  The loss check reads that frame's point count, and limb
        recovery its diagnostics with this frame's depth.  While lost, the
        frames in flight are dropped and the frame goes through ``track``.
        ``flush`` reads the newest frame in flight."""
        if self.reinit:
            self._pending_q = []
            return self.track(frame, labels_override)
        with scope(FRAME_SCOPE):
            return self._track_async(frame, labels_override)

    def _track_async(self, frame, labels_override) -> Optional[TrackResult]:
        c = self.config
        with scope("upload"):
            depth_np = np.asarray(frame)
            if depth_np.ndim == 3:
                depth_np = depth_np[..., 2]
            depth_np = self._pre_stride(depth_np)
            xyz = self._upload(depth_np)
            labels = self._upload_labels(labels_override)
        fit_shape = self._shape_refit_due()
        if fit_shape:
            self._shape_refit_in = None
        elif self._shape_refit_in is not None:
            self._shape_refit_in -= 1
        out = self._run(xyz, labels, c.frame_icp_iters * c.iters_per_icp,
                        fit_shape=fit_shape)
        self._theta_prev = self._theta
        self._theta = out.theta
        self.com_pre = out.com_pre
        self._pending_q.append(out)
        if len(self._pending_q) < max(1, c.pipeline_depth) + 1:
            return None
        diag = unpack_diag(self._pending_q.pop(0).host_diag, self.num_parts)
        with scope("glue/update"):
            self._limb_recovery(diag, depth_np)
        if diag.n_points < c.min_points / (c.data_interval ** 2):
            self.reinit = True
            res = TrackResult(ok=False, n_points=diag.n_points)
        else:
            res = TrackResult(ok=True, n_points=diag.n_points,
                              fit_info=self._fit_info(diag))
        self._log_metrics(res)
        return res

    def flush(self) -> Optional[TrackResult]:
        """The result of the newest frame in flight from ``track_async``
        (None if there is none); the older ones are dropped, and no loss
        check or metrics line is made."""
        if not self._pending_q:
            return None
        diag = unpack_diag(self._pending_q[-1].host_diag, self.num_parts)
        self._pending_q = []
        return TrackResult(ok=True, n_points=diag.n_points,
                           fit_info=self._fit_info(diag))

    @staticmethod
    def _fit_info(diag: HostDiag) -> dict:
        return dict(cost=diag.cost, n_matched=diag.n_matched,
                    part_counts=diag.part_counts.astype(int).tolist(),
                    hard_overflow=diag.hard_overflow)

    # -- one JSON line of metrics per tracked frame --------------------------

    def open_metrics(self, path: str) -> None:
        """Write one JSON line per tracked frame to ``path``: frame index,
        ok / reinit, point and match counts (also per part), fit cost and
        the stages' latest wall ms."""
        self._metrics_file = open(path, "w")
        self._metrics_frame = 0

    def close_metrics(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None

    def _log_metrics(self, res: TrackResult) -> None:
        if self._metrics_file is None:
            return
        rec = dict(frame=self._metrics_frame, ok=res.ok,
                   reinit=res.reinitialized, n_points=res.n_points)
        if res.fit_info:
            rec.update(res.fit_info)
        for k, v in self.timer.stats.items():
            if v:
                rec[f"{k}_ms"] = round(v[-1], 3)
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_frame += 1

    def sync_avatar(self) -> Avatar:
        """Materialize the device-side pose into ``self.ava`` (host)."""
        th = self._theta
        self.ava.p = host_read(th.p).astype(np.float64)
        self.ava.r = host_read(th.rots).astype(np.float64)
        self.ava.w = host_read(th.w).astype(np.float64)
        self.ava.update()
        return self.ava

    def pose(self) -> Tuple[np.ndarray, np.ndarray]:
        """The tracked pose as numpy (verts [P,3], joints [J,3]), without
        touching ``self.ava``."""
        m = self.model
        th = self._theta
        verts, joints, _, _ = lbs(m.params, m.parents, th.w, th.p, th.rots,
                                  use_jsr=m.use_joint_shape_regressor)
        return host_read(verts), host_read(joints)

    def _limb_recovery(self, diag: HostDiag, depth_np: np.ndarray) -> None:
        """Re-aim starved extremity chains at their forest blobs: after
        ``limb_recovery_frames`` zero-match (or mis-aimed) frames, rotate
        the chain-root joint so the limb's centroid points at the blob's
        backprojection."""
        c = self.config
        if not c.limb_recovery or self._glut is None or self.rtree is None:
            return
        pc = diag.part_counts
        com = diag.com_pre
        starve = self._starve
        mp = host_read(self._ctx.model_part)
        parents = self.model.parents
        i = self.intrin
        hs = self._host_stride
        rots = None
        changed = False
        mcom = diag.model_com
        Hp, Wp = depth_np.shape[:2]

        def blob_target(g):
            """Backproject group g's blob CoM (median depth patch)."""
            if com[0, g] < 0:
                return None
            ix, iy = int(com[0, g]), int(com[1, g])
            if not (0 <= ix < Wp and 0 <= iy < Hp):
                return None
            patch = depth_np[max(iy - 2, 0): iy + 3,
                             max(ix - 2, 0): ix + 3].astype(np.float32)
            vals = patch[patch > 0]
            if vals.size == 0:
                return None
            z = float(np.median(vals))
            if depth_np.dtype == np.uint16:
                z *= 1e-3
            return np.array([(ix * hs - i.cx) * z / i.fx,
                             -(iy * hs - i.cy) * z / i.fy, z])

        for g, root in SMPL24_GROUP_CHAIN_ROOT.items():
            if g >= self.num_parts:
                continue
            target = blob_target(g)
            misaimed = (target is not None and mcom[g, 0] >= 0 and
                        float(np.linalg.norm(target - mcom[g, 2:5]))
                        > c.limb_recovery_m)
            if pc[g] > 0 and not misaimed:
                starve[g] = 0
                continue
            starve[g] += 1
            if starve[g] < c.limb_recovery_frames or target is None:
                continue
            if rots is None:
                verts, joints = self.pose()
                rots = host_read(self._theta.rots).astype(np.float64)
                J = len(parents)
                Rg = np.zeros((J, 3, 3))
                Rg[0] = rots[0]
                for j in range(1, J):
                    Rg[j] = Rg[parents[j]] @ rots[j]
            sel = mp == g
            if not sel.any():
                continue
            v_cur = verts[sel].mean(0) - joints[root]
            v_new = target - joints[root]
            n1 = np.linalg.norm(v_cur)
            n2 = np.linalg.norm(v_new)
            if n1 < 1e-6 or n2 < 1e-6:
                continue
            # anatomical reach gate: an unreachable blob is a mislabel
            if not (0.4 * n1 <= n2 <= 1.6 * n1):
                starve[g] = 0
                continue
            ang = float(np.arccos(float(np.clip(
                v_cur @ v_new / (n1 * n2), -1.0, 1.0))))
            if ang < 0.15:            # already aimed; the fit handles it
                continue
            axis = np.cross(v_cur, v_new)
            na = np.linalg.norm(axis)
            if na < 1e-9:
                continue
            k = axis / na
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                          [-k[1], k[0], 0]])
            A = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
            C = Rg[parents[root]] if parents[root] >= 0 else np.eye(3)
            rots[root] = C.T @ A @ C @ rots[root]
            starve[g] = 0
            changed = True
            self.limb_recoveries[g] = self.limb_recoveries.get(g, 0) + 1
        if changed:
            self._theta = Theta(
                p=self._theta.p,
                rots=to_device(rots, self.device, self.model.dtype),
                w=self._theta.w)
            # the re-aim is a host-side jump, not motion: zero the velocity
            self._theta_prev = self._theta
