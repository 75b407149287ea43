"""Offline tracking demo over a recorded OpenARK dataset (counterpart of
``avatar_tpu/tools/demo.py``).

Rebuild of reference demo.cpp (flags demo.cpp:44-73): background subtraction
from a designated background frame, forest segmentation, avatar fit, Lambert
overlay, on ``--device`` (the card by default).  Headless by default (writes
overlay frames to --out); pass --display to show a window when OpenCV GUI
support exists.  ``--throughput B --fused`` tracks the first frame, then
the rest in batches of B (``FusedTracker.track_batch``), and prints frames
per second.

    python -m avatar_tpu_torch.tools.demo DATASET_PATH RTREE_PATH [options]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from avatar_tpu_torch.io.dataset import Dataset
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.tools.common import (add_model_args, add_partmap_arg,
                                           load_model, set_partmap)
from avatar_tpu_torch.tracking import Tracker, TrackerConfig

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
                         "track_async mode detects tracking loss "
                         "pipeline_depth frames late by design; this tool "
                         "uses the synchronous path)")
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
                    help="offline max-throughput mode (fused tracker): "
                         "track B frames per batch (track_batch); prints "
                         "fps, skips per-frame overlays")
    add_partmap_arg(ap)
    add_model_args(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    ds = Dataset(args.dataset_path, pad=args.pad)
    model = load_model(args)

    rtree = RTree(args.rtree, device=args.device) if args.rtree else None
    if args.partmap and rtree is not None:
        set_partmap(rtree, args.partmap)

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

    if args.throughput and args.fused and not args.rtree_only:
        _throughput(args, ds, tracker)
        return

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


def _throughput(args, ds, tracker):
    """Track the first frame, then the rest in batches of
    ``args.throughput``; print the frames per second of the batches."""
    fids = list(ds.frames(start=args.image))
    if args.max_frames:
        fids = fids[: args.max_frames]
    tracker.track(ds.xyz(fids[0]))
    B = args.throughput
    t0 = time.perf_counter()
    n_ok = 0
    for i in range(1, len(fids), B):
        chunk = [ds.xyz(f) for f in fids[i:i + B]]
        n_ok += sum(r.ok for r in tracker.track_batch(chunk))
    dt = time.perf_counter() - t0
    print(f"[demo] {len(fids) - 1} frames in {dt:.2f}s "
          f"({(len(fids) - 1) / max(dt, 1e-9):.1f} fps, "
          f"{n_ok} tracked), batch={B}")
    if args.metrics:
        tracker.close_metrics()
        print(f"[demo] metrics written to {args.metrics}")


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
