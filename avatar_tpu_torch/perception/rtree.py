"""Random-forest body-part segmentation (counterpart of
``avatar_tpu/perception/rtree.py``: ``TreeTensors``, ``walk_pixels``,
``suppress_part_nonmax`` and a minimal ``RTree``).

The walk evaluates the Shotton depth-probe feature
    f = depth(pix + u / d(pix)) - depth(pix + v / d(pix))
with out-of-ROI or zero depth reading BACKGROUND_DEPTH = 20 m, for a fixed
number of steps (leaves self-loop).  Node fields are gathered one by one
instead of through the reference's bit-cast row packing; the leaf ids are
the same either way.  ``torch.round`` and ``jnp.round`` both round half to
even, and the ``u / z`` division is kept where it is, so leaf ids match the
reference bit for bit.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from avatar_tpu_torch.io import formats
from avatar_tpu_torch.perception import cc

BACKGROUND_DEPTH = 20.0  # meters (reference RTree.cpp:325)


class TreeTensors(NamedTuple):
    u: torch.Tensor          # [N, 2] (or [T, N, 2] for a stacked forest)
    v: torch.Tensor          # [N, 2]
    thresh: torch.Tensor     # [N]
    lnode: torch.Tensor      # [N] int32
    rnode: torch.Tensor      # [N] int32
    leafid: torch.Tensor     # [N] int32 (-1 internal)
    leaf_data: torch.Tensor  # [L, num_parts]
    leaf_best: torch.Tensor  # [L] uint8 argmax part
    leaf_conf: torch.Tensor  # [L] f32 max leaf probability


def _tree_depth(lnode, rnode, leafid) -> int:
    maxd = 1
    stack = [(0, 1)]
    while stack:
        n, d = stack.pop()
        maxd = max(maxd, d)
        if leafid[n] < 0:
            stack.append((int(lnode[n]), d + 1))
            stack.append((int(rnode[n]), d + 1))
    return maxd


def walk_pixels(tree: TreeTensors, ys, xs, z, fg, probe_flat, probe_shape,
                max_depth: int, top_left, bot_right) -> torch.Tensor:
    """Leaf ids of an arbitrary pixel set (-1 where not ``fg``).

    ys/xs: int pixel coordinates in probe-image space; z: their depths;
    fg: bool validity; probe_flat: the flattened probe image;
    top_left/bot_right: inclusive (x, y) ROI bounds.
    """
    Hp, Wp = probe_shape
    tlx, tly = top_left
    brx, bry = bot_right
    zsafe = torch.where(fg, z, torch.ones_like(z))

    def probe(off):
        px = xs + off[..., 0]
        py = ys + off[..., 1]
        inside = (px >= tlx) & (px <= brx) & (py >= tly) & (py <= bry)
        pz = probe_flat[torch.clamp(py * Wp + px, 0, Hp * Wp - 1).long()]
        pz = torch.where(pz == 0.0, BACKGROUND_DEPTH, pz)
        return torch.where(inside, pz, BACKGROUND_DEPTH)

    node = torch.zeros(ys.shape, dtype=torch.long, device=ys.device)
    for _ in range(max_depth):
        is_leaf = tree.leafid[node] >= 0
        u_off = torch.round(tree.u[node] / zsafe[..., None]).to(torch.int32)
        v_off = torch.round(tree.v[node] / zsafe[..., None]).to(torch.int32)
        f = probe(u_off) - probe(v_off)
        nxt = torch.where(f < tree.thresh[node], tree.lnode[node],
                          tree.rnode[node]).long()
        node = torch.where(is_leaf, node, nxt)
    return torch.where(fg, tree.leafid[node], -1)


def suppress_part_nonmax(strided: torch.Tensor, com_pre: torch.Tensor,
                         num_parts: int, interval: int, dist_to_pre_weight,
                         origin) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the best-scoring connected blob per part; erase the rest.

    strided: [Hs, Ws] uint8 labels (255 = background); com_pre:
    [2, num_parts] previous centres of mass in full-image pixels (x < 0 =
    unknown); origin: (x0, y0) full-image coordinates of strided[0, 0].
    Score = size - dist^2(com, com_pre) * weight (reference RTree.cpp:
    126-210).  Returns (filtered image, new com_pre).
    """
    Hs, Ws = strided.shape
    dev = strided.device
    HW = Hs * Ws
    active = strided != 255
    labels = cc.connected_components(active, values=strided)
    sizes = cc.component_sizes(labels)
    sx, sy = cc.component_centroids(labels)

    flat_lab = labels.reshape(-1)
    pix_part = strided.reshape(-1).to(torch.int32)
    root = torch.where(flat_lab >= 0, flat_lab, HW).long()
    # every pixel of a component carries the root's part, so duplicate
    # writes agree
    part_of_root = torch.full((HW + 1,), 255, dtype=torch.int32,
                              device=dev).index_put_((root,), pix_part)[:-1]

    szf = sizes.to(torch.float32)
    cx = torch.where(szf > 0, sx / torch.clamp(szf, min=1.0), 0.0)
    cy = torch.where(szf > 0, sy / torch.clamp(szf, min=1.0), 0.0)
    cx_full = cx * interval + origin[0]
    cy_full = cy * interval + origin[1]

    part_idx = torch.where(sizes > 0, part_of_root, num_parts).long()
    pclip = torch.clamp(part_idx, max=num_parts - 1)
    prev_x = com_pre[0][pclip]
    prev_y = com_pre[1][pclip]
    d2 = (cx_full - prev_x) ** 2 + (cy_full - prev_y) ** 2
    score = szf - torch.where(prev_x >= 0, d2 * dist_to_pre_weight, 0.0)
    score = torch.where(sizes > 0, score, -torch.inf)

    best = torch.full((num_parts + 1,), -torch.inf, dtype=torch.float32,
                      device=dev).scatter_reduce(
        0, part_idx, score, "amax", include_self=True)[:num_parts]
    is_best = (score == best[pclip]) & (sizes > 0)
    # tie-break by smallest root index
    root_ids = torch.arange(HW, dtype=torch.int32, device=dev)
    best_root = torch.full((num_parts + 1,), HW, dtype=torch.int32,
                           device=dev).scatter_reduce(
        0, torch.where(is_best, part_idx, num_parts), root_ids, "amin",
        include_self=True)[:num_parts]

    pix_root = torch.where(flat_lab >= 0, flat_lab, 0)
    keep = (flat_lab >= 0) & (
        pix_root == best_root[torch.clamp(pix_part, max=num_parts - 1).long()])
    out = torch.where(keep, strided.reshape(-1),
                      torch.full_like(strided.reshape(-1), 255)).reshape(Hs, Ws)

    found = best_root < HW
    bidx = torch.clamp(best_root, max=HW - 1).long()
    new_x = torch.where(found, cx_full[bidx], -1.0)
    new_y = torch.where(found, cy_full[bidx], 0.0)
    return out, torch.stack([new_x, new_y])


class RTree:
    """Minimal forest holder (the reference's ``RTree`` with
    ``load_file``/``set_forest``; inference entry points beyond the fused
    tracker's walk are not ported yet)."""

    def __init__(self, path_or_parts, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.part_map: list = []
        self.partmap_type: int = -1
        self._tree: Optional[TreeTensors] = None
        self._max_depth = 0
        self.num_parts = 0
        self.forest: Optional[formats.ForestData] = None
        if isinstance(path_or_parts, int):
            self.num_parts = path_or_parts
        else:
            self.load_file(str(path_or_parts))

    def load_file(self, path: str) -> bool:
        self.set_forest(formats.read_srtr(path))
        pm_path = path + ".partmap"
        if os.path.exists(pm_path):
            self.part_map, _, self.partmap_type = formats.read_partmap(pm_path)
        return True

    def set_forest(self, fd: formats.ForestData) -> None:
        self.forest = fd
        self.num_parts = fd.num_parts
        # leaves self-loop so the fixed-depth walk cannot escape them
        self_idx = np.arange(fd.num_nodes, dtype=np.int32)
        is_leaf = fd.leafid >= 0
        lnode = np.where(is_leaf, self_idx, fd.lnode)
        rnode = np.where(is_leaf, self_idx, fd.rnode)
        self._max_depth = _tree_depth(fd.lnode, fd.rnode, fd.leafid)
        ld = fd.leaf_data
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                          device=self.device)
        self._tree = TreeTensors(
            u=t(fd.u, torch.float32), v=t(fd.v, torch.float32),
            thresh=t(fd.thresh, torch.float32),
            lnode=t(lnode, torch.int32), rnode=t(rnode, torch.int32),
            leafid=t(fd.leafid, torch.int32),
            leaf_data=t(ld, torch.float32),
            leaf_best=t(np.argmax(ld, axis=1), torch.uint8),
            leaf_conf=t(ld.max(axis=1) if ld.size else np.zeros(0),
                        torch.float32))
