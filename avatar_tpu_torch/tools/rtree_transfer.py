"""Re-estimate forest leaf distributions on fresh synthetic renders.

Counterpart of ``avatar_tpu/tools/rtree_transfer.py`` (reference
rtree-transfer.cpp:11-104 / RTree::trainTransfer): the tree structure is
frozen; every foreground pixel of freshly rendered frames walks the tree
and the (part, leaf) visit histogram renormalizes the leaf distributions
(unvisited leaves keep their old weights).

    python -m avatar_tpu_torch.tools.rtree_transfer IN.srtr OUT.srtr \\
        --synthetic-model 2 --images 50
"""

from __future__ import annotations

import argparse

from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.tools.common import (add_model_args, load_model,
                                           load_pose_seq)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="trained .srtr")
    ap.add_argument("output", help="output .srtr")
    ap.add_argument("--images", type=int, default=100)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--fx", type=float, default=606.438)
    ap.add_argument("--fy", type=float, default=606.351)
    ap.add_argument("--cx", type=float, default=637.294)
    ap.add_argument("--cy", type=float, default=366.992)
    ap.add_argument("--pose-seq", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-q", "--quiet", action="store_true")
    add_model_args(ap)
    args = ap.parse_args(argv)

    model = load_model(args)
    intrin = CameraIntrin(fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy)
    pose_seq = load_pose_seq(args.pose_seq) if args.pose_seq else None
    tree = RTree(args.input, device=args.device)
    tree.train_transfer(model, pose_seq, intrin, (args.height, args.width),
                        verbose=not args.quiet, num_images=args.images,
                        seed=args.seed)
    tree.export_file(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
