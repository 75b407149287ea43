"""Background subtraction over XYZ maps (counterpart of
``avatar_tpu/perception/bgsub.py``; reference BGSubtractor.cpp).

Pass 1: a pixel is foreground iff no valid background pixel in its 3x3
window lies within sqrt(nn_dist_thresh) of it in 3D; z == 0 is invalid
(BGSubtractor.cpp:30-80).  Pass 2: connected components of the foreground
gated by 3D neighbour distance <= neighb_thresh; components smaller than
max(H*W/1000, 100) pixels are erased (BGSubtractor.cpp:82-126).  The mask
holds component ids 0..253 in first-pixel scan order, 255 = background.
Thresholds scale as 1200000 / (H*W) * rel (BGSubtractor.cpp:160-162).
The frame and the background go to the device in scope ``upload``; every
copy between host and device is a counted read (``profiling``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from avatar_tpu_torch.device import get_device
from avatar_tpu_torch.perception import cc
from avatar_tpu_torch.profiling import host_read, scope, to_device


def _foreground_mask(background: torch.Tensor, image: torch.Tensor,
                     nn_dist_thresh) -> torch.Tensor:
    """[H, W] bool foreground mask of XYZ ``image`` against
    ``background`` (both [H, W, 3])."""
    valid = image[..., 2] != 0.0
    bg_valid = background[..., 2] != 0.0
    min_d2 = torch.full(image.shape[:2], float("inf"), dtype=image.dtype,
                        device=image.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = torch.roll(background, (dy, dx), (0, 1))
            nb_valid = torch.roll(bg_valid, (dy, dx), (0, 1)).clone()
            # out-of-bounds neighbours are invalid
            if dy == 1:
                nb_valid[0, :] = False
            elif dy == -1:
                nb_valid[-1, :] = False
            if dx == 1:
                nb_valid[:, 0] = False
            elif dx == -1:
                nb_valid[:, -1] = False
            d = (nb - image) ** 2
            d2 = d[..., 0] + d[..., 1] + d[..., 2]
            min_d2 = torch.where(nb_valid, torch.minimum(min_d2, d2), min_d2)
    return valid & (min_d2 >= nn_dist_thresh)


def _components(image: torch.Tensor, fg: torch.Tensor, neighb_thresh):
    """Pass 2: gated components of ``fg``.  Returns (labels [H, W] int32
    root ids with -1 background, sizes [H*W])."""
    labels = cc.connected_components(fg, values=image,
                                     edge_gate_fn=cc.Dist2Gate(neighb_thresh))
    return labels, cc.component_sizes(labels)


class BGSubtractor:
    def __init__(self, background: np.ndarray, stride: int = 1,
                 device: str | torch.device = "cuda"):
        """background: [H, W, 3] XYZ map of the empty scene.  ``stride`` > 1
        runs both passes on the subsampled grid and repeats the mask back
        to full resolution.  The passes run on ``device``."""
        self.device = get_device(device)
        self.background = np.asarray(background, np.float32)
        self.stride = stride
        self.nn_dist_thresh_rel = 0.005
        self.neighb_thresh_rel = 0.005
        self.num_threads = 1  # API parity; ignored
        self.top_left: Tuple[int, int] = (0, 0)
        self.bot_right: Tuple[int, int] = (0, 0)

    # C++ attribute aliases
    @property
    def nnDistThreshRel(self):
        return self.nn_dist_thresh_rel

    @nnDistThreshRel.setter
    def nnDistThreshRel(self, v):
        self.nn_dist_thresh_rel = v

    @property
    def neighbThreshRel(self):
        return self.neighb_thresh_rel

    @neighbThreshRel.setter
    def neighbThreshRel(self, v):
        self.neighb_thresh_rel = v

    @property
    def topLeft(self):
        return self.top_left

    @property
    def botRight(self):
        return self.bot_right

    def run(self, image: np.ndarray,
            comps_by_size: Optional[List] = None) -> np.ndarray:
        """Segment an XYZ frame: a uint8 mask (component ids, 255 =
        background); top_left / bot_right become the foreground bbox.  A
        ``comps_by_size`` list is filled with [size, component id] pairs,
        largest first (reference BGSubtractor.cpp:152-154)."""
        Hf, Wf = image.shape[:2]
        st = self.stride
        image_s = image[::st, ::st] if st > 1 else image
        bg_s = self.background[::st, ::st] if st > 1 else self.background
        H, W = image_s.shape[:2]
        # the thresholds scale with the full-resolution size
        scale = 1200000.0 / (Hf * Wf)
        t = lambda a: to_device(np.asarray(a, np.float32), self.device)
        with scope("upload"):
            img = t(image_s)
            bg = t(bg_s)
        fg = _foreground_mask(bg, img, t(scale * self.nn_dist_thresh_rel))
        labels, sizes = _components(img, fg,
                                    t(scale * self.neighb_thresh_rel))
        labels = host_read(labels)
        sizes = host_read(sizes)
        min_pts = max(Hf * Wf // 1000, 100) // (st * st)

        roots = np.nonzero(sizes >= min_pts)[0][:254]   # scan order
        id_map = np.full(H * W + 1, 255, np.uint8)
        id_map[roots] = np.arange(len(roots), dtype=np.uint8)
        flat = labels.reshape(-1)
        mask = id_map[np.where(flat >= 0, flat, H * W)].reshape(H, W)
        if st > 1:
            mask = np.repeat(np.repeat(mask, st, 0), st, 1)[:Hf, :Wf]

        valid = mask != 255
        if valid.any():
            ys, xs = np.nonzero(valid)
            self.top_left = (int(xs.min()), int(ys.min()))
            self.bot_right = (int(xs.max()), int(ys.max()))
        else:
            self.top_left = (Wf - 1, Hf - 1)
            self.bot_right = (0, 0)

        if comps_by_size is not None:
            comps_by_size.clear()
            comps_by_size.extend(sorted(
                ([int(sizes[r]) * st * st, i] for i, r in enumerate(roots)),
                reverse=True))
        return mask
