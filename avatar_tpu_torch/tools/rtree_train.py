"""Train a body-part random forest from synthetic renders.

Counterpart of ``avatar_tpu/tools/rtree_train.py`` (reference
rtree-train.cpp, flags rtree-train.cpp:26-52).  Training runs on
``--device``, the card by default — see avatar_tpu_torch/train/forest.py.
``--devices N`` > 1 spawns a world of N ranks, one process per device
(N cards, or N CPU processes under gloo with ``--device cpu``); rank 0
writes the forest.

    python -m avatar_tpu_torch.tools.rtree_train OUT.srtr \\
        --synthetic-model 2 --images 200 --features 128 --depth 13
    python -m avatar_tpu_torch.tools.rtree_train OUT.srtr \\
        --synthetic-model 1 --images 16 --devices 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

from avatar_tpu_torch.device import get_device
from avatar_tpu_torch.io import formats
from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.tools.common import (add_model_args, load_model,
                                           load_pose_seq)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output", help="output .srtr path")
    ap.add_argument("--images", type=int, default=100,
                    help="number of synthetic images (reference default 100; "
                         "Kinect paper used 1M)")
    ap.add_argument("--pixels", type=int, default=2000,
                    help="pixel samples per image")
    ap.add_argument("--features", type=int, default=200,
                    help="candidate features per node chunk (the reference "
                         "proposes 5000 and filters to 200)")
    ap.add_argument("--probe", type=float, default=170.0,
                    help="max probe offset (pixel*meters)")
    ap.add_argument("--depth", type=int, default=20, help="max tree depth")
    ap.add_argument("--min-samples", type=int, default=100)
    ap.add_argument("--threshes", type=int, default=15,
                    help="threshold buckets per feature")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--fx", type=float, default=606.438)
    ap.add_argument("--fy", type=float, default=606.351)
    ap.add_argument("--cx", type=float, default=637.294)
    ap.add_argument("--cy", type=float, default=366.992)
    ap.add_argument("--pose-seq", default="")
    ap.add_argument("--part-map", default="")
    ap.add_argument("--num-parts", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="resumable training state path (saved every level "
                         "and on SIGINT, like the reference's RTREE_V3)")
    ap.add_argument("--devices", type=int, default=0,
                    help="train over N devices, one process each in a "
                         "torch.distributed world (NCCL on the card, gloo "
                         "with --device cpu): data-parallel image batches, "
                         "all-reduced count tensors; 0 = one device, no "
                         "process group.  The trained tree is the "
                         "one-device tree.  The analogue of the reference's "
                         "--num-threads (RTree.cpp:1700-1704 mutex-reduce)")
    ap.add_argument("--data", default="",
                    help="train from a recorded dataset dir containing "
                         "depth_exr/ + part_mask/ instead of synthetic "
                         "renders (reference rtree-train.cpp:135)")
    ap.add_argument("-q", "--quiet", action="store_true")
    add_model_args(ap)
    return ap


def _launch(args, argv) -> None:
    """Run this tool on every rank of a world of ``args.devices``."""
    dev = get_device(args.device)
    if dev.type == "cuda" and args.devices > torch.cuda.device_count():
        sys.exit(f"--devices {args.devices}: {torch.cuda.device_count()} "
                 "CUDA device(s) visible; a world of "
                 f"{args.devices} ranks needs one card per rank")
    from avatar_tpu_torch.parallel.training import run_world

    run_world(main, args.devices, dev,
              list(sys.argv[1:] if argv is None else argv), timeout_s=None)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.devices > 1 and not dist.is_initialized():
        _launch(args, argv)
        return
    if args.devices and args.data:
        sys.exit("--devices trains on synthetic renders; --data trains on "
                 "one device, as the reference's does")
    part_map = None
    num_parts = args.num_parts
    pm_type = 0
    if args.part_map:
        part_map, num_parts, pm_type = formats.read_partmap(args.part_map)

    tree = RTree(num_parts, device=args.device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    common = dict(
        verbose=lead and not args.quiet, num_images=args.images,
        num_points_per_image=args.pixels, num_features=args.features,
        max_probe_offset=args.probe, min_samples=args.min_samples,
        max_tree_depth=args.depth, threshes_per_feature=args.threshes,
        train_partial_save_path=args.checkpoint, seed=args.seed)
    if args.data:
        tree.train(os.path.join(args.data, "depth_exr"),
                   os.path.join(args.data, "part_mask"), **common)
        tree.part_map = list(part_map) if part_map is not None else []
    else:
        model = load_model(args)
        intrin = CameraIntrin(fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy)
        pose_seq = load_pose_seq(args.pose_seq) if args.pose_seq else None
        tree.train_from_avatar(model, pose_seq, intrin,
                               (args.height, args.width), part_map=part_map,
                               devices=args.devices, **common)
    if not lead:
        return      # rank 0 writes the forest
    tree.partmap_type = pm_type
    tree.export_file(args.output)
    print(f"wrote {args.output} ({tree.forest.num_nodes} nodes)")


if __name__ == "__main__":
    main()
