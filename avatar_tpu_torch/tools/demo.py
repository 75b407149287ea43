"""Offline tracking demo over a recorded OpenARK dataset (counterpart of
``avatar_tpu/tools/demo.py``).

Rebuild of reference demo.cpp (flags demo.cpp:44-73): background subtraction
from a designated background frame, forest segmentation, avatar fit, Lambert
overlay, on ``--device`` (the card by default).  Headless by default (writes
overlay frames to --out); pass --display to show a window when OpenCV GUI
support exists.  ``--throughput`` (the reference's batched ``track_batch``
mode) is not ported and exits with a message.

    python -m avatar_tpu_torch.tools.demo DATASET_PATH RTREE_PATH [options]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from avatar_tpu_torch.io.dataset import Dataset
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.tools.common import add_model_args, load_model
from avatar_tpu_torch.tracking import Tracker, TrackerConfig

THROUGHPUT_MESSAGE = ("the batched throughput mode (FusedTracker."
                      "track_batch) is not ported: ROADMAP A9 leaves the "
                      "batch and async paths behind")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset_path")
    ap.add_argument("rtree", nargs="?", default="",
                    help="forest model path (.srtr); omit with --rtree-only "
                         "semantics of showing bgsub components")
    ap.add_argument("-b", "--background", type=int, default=9999,
                    help="background frame id (demo.cpp:46)")
    ap.add_argument("-i", "--image", type=int, default=1,
                    help="first frame id")
    ap.add_argument("-p", "--pad", type=int, default=4,
                    help="zero pad width of frame file names")
    ap.add_argument("-R", "--rtree-only", action="store_true",
                    help="show part segmentation only, skip optimization")
    ap.add_argument("--no-occlusion", action="store_true")
    ap.add_argument("--betapose", type=float, default=0.05)
    ap.add_argument("--betashape", type=float, default=0.12)
    ap.add_argument("-I", "--data-interval", type=int, default=12)
    ap.add_argument("--nnstep", type=int, default=20)
    ap.add_argument("-t", "--frame-icp-iters", type=int, default=3)
    ap.add_argument("-T", "--reinit-icp-iters", type=int, default=6)
    ap.add_argument("--inner-iters", type=int, default=10)
    ap.add_argument("-M", "--min-points", type=int, default=1000)
    ap.add_argument("--out", default="", help="write overlay frames here")
    ap.add_argument("--display", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--fused", action="store_true",
                    help="use the fully fused on-device pipeline (note: its "
                         "track_async throughput mode detects tracking loss "
                         "one frame late by design; this tool uses the "
                         "synchronous path)")
    ap.add_argument("--metrics", default="",
                    help="write per-frame metrics JSONL here (stage ms, "
                         "per-part match counts, fit cost, reinit events)")
    ap.add_argument("--part-groups", action="store_true",
                    help="group-level correspondence for 24-part SMPL trees "
                         "(perception/partgroups.py)")
    ap.add_argument("--beta-temp", type=float, default=None,
                    help="temporal pose-prior weight (fused tracker; "
                         "default from TrackerConfig)")
    ap.add_argument("--no-render-labels", action="store_true",
                    help="disable the model-predicted label override "
                         "(fused tracker; on by default with a forest)")
    ap.add_argument("--throughput", type=int, default=0, metavar="B",
                    help="the reference's offline max-throughput mode "
                         "(track_batch): not ported, any B > 0 is refused")
    add_model_args(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.throughput > 0:
        sys.exit(f"--throughput {args.throughput}: {THROUGHPUT_MESSAGE}")
    ds = Dataset(args.dataset_path, pad=args.pad)
    model = load_model(args)

    rtree = RTree(args.rtree, device=args.device) if args.rtree else None

    try:
        bg = ds.xyz(args.background)
    except FileNotFoundError:
        bg = None
        print("[demo] no background frame; skipping subtraction",
              file=sys.stderr)

    first = ds.xyz(args.image)
    H, W = first.shape[:2]
    part_groups = None
    if args.part_groups:
        from avatar_tpu_torch.perception.partgroups import SMPL24_GROUP_LUT

        part_groups = tuple(SMPL24_GROUP_LUT)
    cfg = TrackerConfig(
        beta_pose=args.betapose, beta_shape=args.betashape,
        data_interval=args.data_interval,
        frame_icp_iters=args.frame_icp_iters,
        reinit_icp_iters=args.reinit_icp_iters,
        iters_per_icp=args.inner_iters, min_points=args.min_points,
        enable_occlusion=not args.no_occlusion,
        part_groups=part_groups,
        **({} if args.beta_temp is None
           else dict(beta_temp=args.beta_temp)),
        render_labels=not args.no_render_labels)
    if args.fused:
        from avatar_tpu_torch.tracking_fused import FusedTracker

        tracker = FusedTracker(model, ds.intrin, (H, W), rtree=rtree,
                               config=cfg)
    else:
        tracker = Tracker(model, ds.intrin, (H, W), rtree=rtree, config=cfg)
    if bg is not None:
        tracker.set_background(bg)
    if args.metrics:
        tracker.open_metrics(args.metrics)

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    n = 0
    for fid in ds.frames(start=args.image):
        xyz = ds.xyz(fid)
        rgb = ds.rgb(fid)
        if args.rtree_only and rtree is not None:
            depth = np.ascontiguousarray(xyz[..., 2])
            seg = rtree.predict_best(depth, interval=2)
            _write_or_show(args, fid, _palette_view(seg), rgb)
        else:
            res = tracker.track(xyz)
            if res.ok:
                if args.fused:
                    tracker.sync_avatar()
                overlay = (tracker.render_overlay(rgb)
                           if hasattr(tracker, "render_overlay") else None)
                if overlay is not None:
                    _write_or_show(args, fid, overlay, None)
                print(f"frame {fid}: tracked ({res.n_points} pts"
                      f"{', reinit' if res.reinitialized else ''})")
            else:
                print(f"frame {fid}: tracking lost ({res.n_points} pts)")
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    if args.metrics:
        tracker.close_metrics()
        print(f"[demo] metrics written to {args.metrics}")
    print(tracker.timer.report())


def _palette_view(seg: np.ndarray) -> np.ndarray:
    from avatar_tpu_torch.utils import palette_color_table

    table = (palette_color_table(256) * 255).astype(np.uint8)
    out = table[np.minimum(seg, 16)]
    out[seg == 255] = 0
    return out


def _write_or_show(args, fid, image, rgb):
    try:
        import cv2
    except ImportError:
        cv2 = None
    if args.out and cv2 is not None:
        cv2.imwrite(os.path.join(args.out, f"overlay_{fid:06d}.png"), image)
    if args.display and cv2 is not None:
        cv2.imshow("avatar_tpu demo", image)
        cv2.waitKey(1)


if __name__ == "__main__":
    main()
