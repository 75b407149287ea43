"""Synthetic depth dataset generator (counterpart of
``avatar_tpu/tools/smplsynth.py``), batched on ``--device`` (the card by
default).

Rebuild of reference smplsynth.cpp: mocap-posed (or prior-sampled)
randomized avatars rendered to depth + part-mask + joint label files in the
OpenARK dataset layout, one ``train/synth.py`` render batch per step.  The
part masks and joint labels are written through OpenCV.  The labels of
image i come from ``synth.sample_pose``, which draws the same pose for the
same (seed, i) as the render batch did.

    python -m avatar_tpu_torch.tools.smplsynth OUT_DIR -n 100 --synthetic-model 2
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.io import formats
from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.io.dataset import DatasetWriter
from avatar_tpu_torch.tools.common import (add_model_args, load_model,
                                           load_pose_seq)
from avatar_tpu_torch.train import synth


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("-n", "--num-images", type=int, default=100)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    # hardcoded K4A fallback intrinsics (smplsynth.cpp:244-250)
    ap.add_argument("--fx", type=float, default=606.438)
    ap.add_argument("--fy", type=float, default=606.351)
    ap.add_argument("--cx", type=float, default=637.294)
    ap.add_argument("--cy", type=float, default=366.992)
    ap.add_argument("--pose-seq", default="", help="mocap .dat path")
    ap.add_argument("--part-map", default="", help=".partmap file")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    add_model_args(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    model = load_model(args)
    intrin = CameraIntrin(fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy)
    H, W = args.height, args.width
    part_map = None
    if args.part_map:
        part_map, _, _ = formats.read_partmap(args.part_map)
    pose_seq = load_pose_seq(args.pose_seq) if args.pose_seq else None

    src = synth.make_source(model, intrin, part_map, pose_seq,
                            n_images=args.num_images, seed=args.seed)
    writer = DatasetWriter(args.out_dir, intrin, pad=8)
    K = model.num_shape_keys()

    B = args.batch
    for start in range(0, args.num_images, B):
        ids = np.arange(start, min(start + B, args.num_images))
        ids_pad = np.pad(ids, (0, B - len(ids)), mode="edge")
        depth, mask, joints = synth.render_batch(
            src, model.parents, ids_pad, args.seed, H, W, K)
        depth = depth.cpu().numpy()
        mask = mask.cpu().numpy()
        joints = joints.cpu().numpy()
        for k, i in enumerate(ids):
            writer.write_depth(int(i), depth[k])
            writer.write_part_mask(int(i), mask[k])
            # labels (smplsynth.cpp:127-165)
            w, p, rots = synth.sample_pose(src, [int(i)], args.seed, K)
            jp = joints[k]
            j2d = np.stack([
                jp[:, 0] * intrin.fx / jp[:, 2] + intrin.cx,
                -jp[:, 1] * intrin.fy / jp[:, 2] + intrin.cy], 1)
            aa = rotation.so3_log(rots[0]).cpu().numpy().reshape(-1)
            writer.write_joints(int(i), j2d, jp, p[0].cpu().numpy(),
                                w[0].cpu().numpy(), aa, aa[3:])
        print(f"[smplsynth] wrote {min(start + B, args.num_images)}"
              f"/{args.num_images}", file=sys.stderr)


if __name__ == "__main__":
    main()
