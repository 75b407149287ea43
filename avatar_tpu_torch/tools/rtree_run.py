"""Run forest segmentation on a single depth frame (counterpart of
``avatar_tpu/tools/rtree_run.py``).

Rebuild of reference rtree-run.cpp: load one depth image (.exr/.depth),
predict parts on ``--device`` (the card by default), write a palette
visualization.  With several tree models the dense part distributions are
averaged and the per-pixel argmax visualized (reference
rtree-run.cpp:92-121).  Without OpenCV the segmentation is saved as
``OUT.npy`` instead.

    python -m avatar_tpu_torch.tools.rtree_run DEPTH_FILE TREE.srtr [TREE2.srtr...]
"""

from __future__ import annotations

import argparse

import numpy as np

from avatar_tpu_torch.io import formats
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.utils import palette_color_table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("depth_file")
    ap.add_argument("trees", nargs="+",
                    help="one or more .srtr models (distributions averaged)")
    ap.add_argument("-o", "--out", default="rtree_run.png")
    ap.add_argument("--interval", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; there "
                         "is no silent CPU fallback)")
    args = ap.parse_args(argv)

    depth = formats.read_depth(args.depth_file)
    if depth.ndim == 3:
        depth = depth[..., 2]
    tree = RTree(args.trees[0], device=args.device)
    if len(args.trees) == 1:
        seg = tree.predict_best(depth, interval=args.interval)
    else:
        dist = tree.predict(depth, interval=args.interval).astype(np.float64)
        for path in args.trees[1:]:
            t = RTree(path, device=args.device)
            if t.num_parts != tree.num_parts:
                raise SystemExit(f"part-count mismatch: {path}")
            dist += t.predict(depth, interval=args.interval)
        fg = dist.sum(-1) > 0
        seg = np.where(fg, dist.argmax(-1), 255).astype(np.uint8)
    table = (palette_color_table(max(tree.num_parts, 17)) * 255).astype(
        np.uint8)
    vis = table[np.minimum(seg, tree.num_parts - 1)]
    vis[seg == 255] = 0
    try:
        import cv2

        cv2.imwrite(args.out, vis)
        print(f"wrote {args.out}")
    except ImportError:
        np.save(args.out + ".npy", seg)
        print(f"wrote {args.out}.npy (no OpenCV)")


if __name__ == "__main__":
    main()
