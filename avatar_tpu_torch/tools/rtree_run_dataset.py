"""Run forest part segmentation over an OpenARK dataset (counterpart of
``avatar_tpu/tools/rtree_run_dataset.py``).

Rebuild of reference rtree-run-dataset.cpp:36-194: per frame, run one or
more trees (distributions averaged) on ``--device`` (the card by default),
postprocess, and write palette visualizations (``seg_XXXXXX.npy`` label
images without OpenCV).

    python -m avatar_tpu_torch.tools.rtree_run_dataset DATASET TREE1 [TREE2 ...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from avatar_tpu_torch.io.dataset import Dataset
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.utils import palette_color_table


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset_path")
    ap.add_argument("trees", nargs="+", help="one or more .srtr files "
                    "(multi-tree distributions are averaged)")
    ap.add_argument("-i", "--start", type=int, default=1)
    ap.add_argument("-p", "--pad", type=int, default=4)
    ap.add_argument("--interval", type=int, default=2)
    ap.add_argument("--no-postprocess", action="store_true")
    ap.add_argument("--out", default="rtree_out")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; there "
                         "is no silent CPU fallback)")
    ap.add_argument("--interactive", action="store_true",
                    help="a/d step frames, m toggles the GT part-mask "
                    "view, q/ESC quits (rtree-run-dataset.cpp:176-186); "
                    "frames render on demand instead of batch")
    return ap


def run_interactive(args, ds, trees, table, com_pre, key_source=None,
                    on_frame=None):
    """The reference's interactive frame-stepping loop
    (rtree-run-dataset.cpp:103-186): show the current frame's segmentation
    (or its ground-truth part mask after 'm'), then block on a key —
    'a' steps back, 'd' forward, 'm' toggles mask view, 'q'/ESC exits.
    ``key_source`` is injectable so tests can drive a scripted sequence;
    ``on_frame(fid, show_mask, img)`` observes every displayed frame."""
    num_parts = trees[0].num_parts
    if key_source is None:       # pragma: no cover - needs a display
        import cv2

        def key_source():
            return cv2.waitKey(0) & 0xFF

    fids = list(ds.frames(start=args.start))
    if not fids:
        return
    pos, show_mask = 0, False
    while True:
        fid = fids[max(0, min(pos, len(fids) - 1))]
        if show_mask:
            seg = ds.part_mask(fid)
            if seg is None:
                seg = np.full((1, 1), 255, np.uint8)
        else:
            seg = _segment(ds, trees, fid, args, com_pre)
        vis = table[np.minimum(seg, num_parts - 1)]
        vis[seg == 255] = 0
        if on_frame is not None:
            on_frame(fid, show_mask, vis)
        k = key_source()
        if k in (ord("q"), 27):
            break
        elif k == ord("a") and pos > 0:
            pos -= 1
        elif k == ord("d") and pos < len(fids) - 1:
            pos += 1
        elif k == ord("m"):
            show_mask = not show_mask


def _segment(ds, trees, fid, args, com_pre):
    depth = ds.depth(fid)
    if depth.ndim == 3:
        depth = depth[..., 2]
    if len(trees) == 1:
        seg = trees[0].predict_best(depth, interval=args.interval)
    else:
        dist = None
        for t in trees:
            d = t.predict(depth, interval=args.interval)
            dist = d if dist is None else dist + d
        fg = dist.sum(-1) > 0
        seg = np.where(fg, np.argmax(dist, -1).astype(np.uint8), 255)
    if not args.no_postprocess:
        seg = trees[0].post_process(seg, com_pre, interval=args.interval)
    return seg


def main(argv=None, key_source=None, on_frame=None):
    args = build_parser().parse_args(argv)
    ds = Dataset(args.dataset_path, pad=args.pad)
    trees = [RTree(p, device=args.device) for p in args.trees]
    num_parts = trees[0].num_parts
    os.makedirs(args.out, exist_ok=True)
    table = (palette_color_table(max(num_parts, 17)) * 255).astype(np.uint8)
    com_pre = np.full((2, num_parts), -1.0)
    com_pre[1, :] = 0.0

    if args.interactive:
        run_interactive(args, ds, trees, table, com_pre,
                        key_source=key_source, on_frame=on_frame)
        return

    n = 0
    for fid in ds.frames(start=args.start):
        seg = _segment(ds, trees, fid, args, com_pre)
        vis = table[np.minimum(seg, num_parts - 1)]
        vis[seg == 255] = 0
        try:
            import cv2

            cv2.imwrite(os.path.join(args.out, f"seg_{fid:06d}.png"), vis)
        except ImportError:
            np.save(os.path.join(args.out, f"seg_{fid:06d}.npy"), seg)
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    print(f"processed {n} frames -> {args.out}")


if __name__ == "__main__":
    main()
