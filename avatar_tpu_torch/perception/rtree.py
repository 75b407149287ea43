"""Random-forest body-part segmentation (counterpart of
``avatar_tpu/perception/rtree.py``: the walk, the blob filters and the
``RTree`` API; the training entry points live in ``train/forest.py``).

The walk evaluates the Shotton depth-probe feature
    f = depth(pix + u / d(pix)) - depth(pix + v / d(pix))
with out-of-ROI or zero depth reading BACKGROUND_DEPTH = 20 m, for a fixed
number of steps (leaves self-loop).  Node fields are gathered one by one
instead of through the reference's bit-cast row packing; the leaf ids are
the same either way.  ``torch.round`` and ``jnp.round`` both round half to
even, and the ``u / z`` division is kept where it is, so leaf ids match the
reference bit for bit.  On the card the walk is one hand-written CUDA
kernel per tree set (``walk_kernel``); ``walk_pixels_plain`` is its plain
version, which the CPU runs.  The ``RTree`` API's copies between host and
device are counted reads (``profiling.host_read``, ``to_device``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from avatar_tpu_torch.device import get_device
from avatar_tpu_torch.io import formats
from avatar_tpu_torch.perception import cc, walk_kernel
from avatar_tpu_torch.profiling import host_read, to_device

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
                max_depth: int, top_left, bot_right,
                trees: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Leaf ids of an arbitrary pixel set (-1 where not ``fg``).

    ys/xs: int pixel coordinates in probe-image space; z: their depths;
    fg: bool validity; probe_flat: the flattened probe image;
    top_left/bot_right: inclusive (x, y) ROI bounds.  ``trees = (t0, t1)``
    walks those trees of a stacked [T, ...] forest: ids [t1 - t0,
    *ys.shape].  CUDA tensors go through the kernel (``walk_kernel.walk``,
    which raises on what it does not take), CPU tensors through
    ``walk_pixels_plain``.
    """
    if ys.device.type == "cuda":
        return walk_kernel.walk(tree, ys, xs, z, fg, probe_flat, probe_shape,
                                max_depth, top_left, bot_right, trees)
    if ys.device.type != "cpu":
        raise ValueError(f"no walk for device {ys.device}")
    return walk_pixels_plain(tree, ys, xs, z, fg, probe_flat, probe_shape,
                             max_depth, top_left, bot_right, trees)


def walk_pixels_plain(tree: TreeTensors, ys, xs, z, fg, probe_flat,
                      probe_shape, max_depth: int, top_left, bot_right,
                      trees: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Plain PyTorch version of ``walk_pixels``: the fixed-depth level loop,
    one tree at a time."""
    if (tree.u.dim() == 3) != (trees is not None):
        raise ValueError("a tree range goes with a stacked [T, N] forest, "
                         "and only with one")
    if trees is not None:
        return torch.stack([walk_pixels_plain(
            TreeTensors(*(a[t] for a in tree)), ys, xs, z, fg, probe_flat,
            probe_shape, max_depth, top_left, bot_right)
            for t in range(*trees)])
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


def forest_walk(tree: TreeTensors, depth_img: torch.Tensor, max_depth: int,
                interval: int, top_left, bot_right, probe_img=None,
                origin=None) -> torch.Tensor:
    """Leaf ids [Hs, Ws] over the strided grid (-1 for background).

    depth_img [H, W] f32, depth 0 = background; top_left/bot_right:
    inclusive (x, y) ROI bounds, probes outside it read BACKGROUND_DEPTH
    (reference RTree.cpp:3224-3237).  ``probe_img``/``origin``: when
    walking a window of a larger image, the full image and the window's
    (x, y) origin (ROI bounds are then in probe-image coordinates).  The
    grid samples pixels (y, x) = origin + (i, j) * interval.
    """
    H, W = depth_img.shape
    dev = depth_img.device
    Hs = (H + interval - 1) // interval
    Ws = (W + interval - 1) // interval
    if probe_img is None:
        probe_img = depth_img
    ox, oy = (0, 0) if origin is None else origin
    Hp, Wp = probe_img.shape
    ys_l = (torch.arange(Hs, device=dev) * interval)[:, None]
    xs_l = (torch.arange(Ws, device=dev) * interval)[None, :]
    ys, xs = ys_l + oy, xs_l + ox
    tlx, tly = top_left
    brx, bry = bot_right
    z = depth_img.reshape(-1)[torch.clamp(ys_l * W + xs_l, max=H * W - 1)]
    fg = (z > 0) & (xs >= tlx) & (xs <= brx) & (ys >= tly) & (ys <= bry)
    return walk_pixels(tree, ys.expand(Hs, Ws).contiguous(),
                       xs.expand(Hs, Ws).contiguous(), z, fg,
                       probe_img.reshape(-1).contiguous(), (Hp, Wp),
                       max_depth, top_left, bot_right)


def upscale_grid(image: torch.Tensor, interval: int, top_left, bot_right
                 ) -> torch.Tensor:
    """Fill stride gaps with the top-left sample of each cell, inside the
    ROI and for cells whose anchor is in it (reference upscaleGrid,
    RTree.cpp:70-99)."""
    if interval == 1:
        return image
    H, W = image.shape
    dev = image.device
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    src_y = (yy // interval) * interval
    src_x = (xx // interval) * interval
    tlx, tly = top_left
    brx, bry = bot_right
    inroi = (xx >= tlx) & (xx <= brx) & (yy >= tly) & (yy <= bry)
    anchor_in = ((src_x >= tlx) & (src_x <= brx) & (src_y >= tly) &
                 (src_y <= bry))
    return torch.where(inroi & anchor_in, image[src_y, src_x], image)


def remove_small_pieces(strided: torch.Tensor, num_parts: int,
                        interval: int, image_hw, thresh: float = 0.0005
                        ) -> torch.Tensor:
    """Erase connected blobs below thresh * (H*W / interval^2) pixels
    (reference removeSmallPieces, RTree.cpp:245-321)."""
    labels = cc.connected_components(strided != 255, values=strided)
    sizes = cc.component_sizes(labels)
    scaled = torch.tensor(image_hw[0] * image_hw[1], dtype=torch.float32) / (
        interval * interval) * thresh
    flat_lab = labels.reshape(-1)
    sz_of_pix = sizes[torch.clamp(flat_lab, min=0).long()]
    labelled, szf = flat_lab >= 0, sz_of_pix.to(torch.float32)
    keep = labelled & (szf >= to_device(scaled, strided.device))
    return torch.where(keep, strided.reshape(-1),
                       torch.full_like(strided.reshape(-1), 255)).reshape(
        strided.shape)


def _strided_to_full(strided: torch.Tensor, full_shape, interval: int
                     ) -> torch.Tensor:
    """Strided samples placed back into a full-size image, 255 elsewhere."""
    if interval == 1:
        return strided
    out = torch.full(tuple(full_shape), 255, dtype=strided.dtype,
                     device=strided.device)
    out[::interval, ::interval] = strided
    return out


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
    """Forest API mirroring the reference class (RTree.h:13-183): loading,
    ``predict_best``, ``predict`` and ``post_process`` on ``device``,
    training and export."""

    def __init__(self, path_or_parts, device: str | torch.device = "cuda"):
        self.device = get_device(device)
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

    def load_trainer_checkpoint(self, path: str):
        """Load a reference RTREE_V2/V3 resumable trainer checkpoint
        (RTree.cpp:1964-2130, 2649-2779) as a usable forest.  Frontier
        nodes not yet split get uniform leaf distributions.  Returns the
        parsed state (data source, sample lists, level info) for
        inspection or conversion."""
        with open(path, "rb") as f:
            head = f.read(9)
        if head == b"RTREE_V3 ":
            state = formats.read_rtree_v3(path)
        elif head == b"RTREE_V2 ":
            state = formats.read_rtree_v2(path)
        else:
            raise ValueError(f"{path}: not an RTREE_V2/V3 checkpoint")
        self.set_forest(formats.trainer_checkpoint_to_forest(state))
        return state

    def export_file(self, path: str) -> bool:
        formats.write_srtr(path, self.forest)
        return True

    exportFile = export_file

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

    loadFile = load_file

    # -- inference ----------------------------------------------------------

    def _roi(self, depth_shape, top_left, bot_right):
        H, W = depth_shape
        if top_left is None:
            top_left = (0, 0)
        if bot_right is None or bot_right[0] == -1:
            bot_right = (W - 1, H - 1)
        return ((int(top_left[0]), int(top_left[1])),
                (int(bot_right[0]), int(bot_right[1])))

    def _depth(self, depth) -> torch.Tensor:
        return to_device(np.asarray(depth, np.float32), self.device)

    def predict_best(self, depth, num_threads: int = 0, interval: int = 1,
                     top_left=None, bot_right=None,
                     fill_in_gaps: bool = True) -> np.ndarray:
        """Best part per pixel: [H, W] uint8, 255 = background (reference
        RTree.cpp:3184-3262).  ``num_threads`` is ignored."""
        depth = self._depth(depth)
        tl, br = self._roi(depth.shape, top_left, bot_right)
        leaf = forest_walk(self._tree, depth, self._max_depth, interval, tl,
                           br)
        best = self._tree.leaf_best[torch.clamp(leaf, min=0).long()]
        best = torch.where(leaf >= 0, best, torch.full_like(best, 255))
        out = _strided_to_full(best, depth.shape, interval)
        if fill_in_gaps and interval > 1:
            out = upscale_grid(out, interval, tl, br)
        return host_read(out)

    predictBest = predict_best

    def predict(self, depth, interval: int = 1, top_left=None,
                bot_right=None, fill_in_gaps: bool = True) -> np.ndarray:
        """Leaf distributions [H, W, num_parts] f32 at full resolution,
        zeros at background (reference RTree.cpp:3156-3182).  Stride gaps
        repeat each cell's top-left sample (``fill_in_gaps``) or stay
        zero."""
        depth = self._depth(depth)
        tl, br = self._roi(depth.shape, top_left, bot_right)
        leaf = forest_walk(self._tree, depth, self._max_depth, interval, tl,
                           br)
        dist = self._tree.leaf_data[torch.clamp(leaf, min=0).long()]
        dist = torch.where((leaf >= 0)[..., None], dist, 0.0)
        if interval > 1:
            H, W = depth.shape
            if fill_in_gaps:
                dist = dist.repeat_interleave(interval, 0).repeat_interleave(
                    interval, 1)[:H, :W]
            else:
                full = torch.zeros((H, W, dist.shape[-1]), dtype=dist.dtype,
                                   device=dist.device)
                full[::interval, ::interval] = dist
                dist = full
        return host_read(dist)

    def post_process(self, image: np.ndarray, com_pre: np.ndarray,
                     interval: int = 1, num_threads: int = 0,
                     top_left=None, bot_right=None,
                     dist_to_pre_weight: float = 0.001) -> np.ndarray:
        """Blob filtering and gap fill (reference RTree.cpp:3422-3450):
        returns the filtered [H, W] uint8 labels; ``com_pre`` [2,
        num_parts] is updated in place as in the reference.  The strided
        grid is anchored at image (0, 0), as ``predict_best``'s is, with
        out-of-ROI samples masked to background."""
        H, W = image.shape
        tl, br = self._roi(image.shape, top_left, bot_right)
        if com_pre.shape != (2, self.num_parts):
            com_pre.resize((2, self.num_parts), refcheck=False)
            com_pre[0, :] = -1.0
            com_pre[1, :] = 0.0
        strided = np.array(image[::interval, ::interval])
        ys = np.arange(strided.shape[0]) * interval
        xs = np.arange(strided.shape[1]) * interval
        inroi = ((xs[None, :] >= tl[0]) & (xs[None, :] <= br[0]) &
                 (ys[:, None] >= tl[1]) & (ys[:, None] <= br[1]))
        strided[~inroi] = 255
        st = to_device(strided, self.device)
        if self.partmap_type == formats.PARTMAP_CONTIGUOUS:
            filtered, new_com = suppress_part_nonmax(
                st, to_device(com_pre, self.device, torch.float32),
                self.num_parts, interval, dist_to_pre_weight, (0, 0))
            com_pre[:] = host_read(new_com)
        else:
            filtered = remove_small_pieces(st, self.num_parts, interval,
                                           (H, W))
        out = np.asarray(image).copy()
        out[::interval, ::interval] = np.where(
            inroi, host_read(filtered), out[::interval, ::interval])
        if interval > 1:
            out = host_read(upscale_grid(to_device(out, self.device),
                                         interval, tl, br))
        return out

    postProcess = post_process

    @staticmethod
    def read_part_map(path_or_stream):
        return formats.read_partmap(path_or_stream)

    readPartMap = read_part_map

    # the training entry points live in avatar_tpu_torch.train.forest
    def train_from_avatar(self, *args, **kwargs):
        from avatar_tpu_torch.train.forest import train_from_avatar

        return train_from_avatar(self, *args, **kwargs)

    trainFromAvatar = train_from_avatar

    def train_transfer(self, *args, **kwargs):
        from avatar_tpu_torch.train.forest import train_transfer

        return train_transfer(self, *args, **kwargs)

    trainTransfer = train_transfer

    def train(self, *args, **kwargs):
        from avatar_tpu_torch.train.forest import train_from_files

        return train_from_files(self, *args, **kwargs)
