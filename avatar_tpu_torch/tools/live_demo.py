"""Live tracking from a camera (or synthetic/dataset playback source)
(counterpart of ``avatar_tpu/tools/live_demo.py``).

Rebuild of reference live-demo.cpp (flags live-demo.cpp:60-120): threaded
capture, background capture on demand, tracking-loss reinitialization, and
Lambert overlay output, on ``--device`` (the card by default; the
synthetic camera renders there too, in its capture thread).  The camera
backends are pluggable (k4a, freenect2, synthetic, or a dataset directory
— see io/camera.py).  A failed capture thread ends the loop with its
error instead of leaving it waiting for a frame.

    python -m avatar_tpu_torch.tools.live_demo --camera synthetic RTREE [options]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from avatar_tpu_torch.io.camera import open_camera
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.tools.common import (add_model_args, add_partmap_arg,
                                           load_model, set_partmap)
from avatar_tpu_torch.tracking import Tracker, TrackerConfig


class LiveDemoState:
    """Keyboard-driven interactive state machine (live-demo.cpp:491-529).

    Keys (case-insensitive, same bindings as the reference):
      q / ESC   quit
      b         capture the current frame as the background model
      SPACE     pause/unpause; the FIRST unpause captures the background if
                none is set (live-demo.cpp:516-523), and pausing arms
                tracking reinitialization for the next unpaused frame
                (live-demo.cpp:525: ``if (pause) reinit = true``)
      h         toggle the BG-subtraction bounding-box overlay
      t         toggle rtree-only visualization mode
      0-3       background display type (none / RGB / depth / external)
    """

    def __init__(self, start_paused: bool = False):
        self.pause = start_paused
        self.background_type = 1
        self.show_bbox = False
        self.rtree_only = False
        self.quit = False
        self.bg_set = False

    def handle_key(self, c: int, tracker, xyz) -> None:
        if c is None or c < 0:
            return
        ch = chr(c).upper() if 0 <= c < 256 else ""
        if ch == "Q" or c == 27:                      # 27 = ESC
            self.quit = True
        elif ch and ch in "0123":     # a code >= 256 is no key here
            self.background_type = int(ch)
        elif ch == "B":
            tracker.set_background(xyz)
            self.bg_set = True
            print("[live] background updated", file=sys.stderr)
        elif ch == "H":
            self.show_bbox = not self.show_bbox
        elif ch == "T":
            self.rtree_only = not self.rtree_only
        elif ch == " ":
            if not self.bg_set:
                tracker.set_background(xyz)
                self.bg_set = True
                print("[live] unpaused, background updated",
                      file=sys.stderr)
            self.pause = not self.pause
            if self.pause:
                # reference live-demo.cpp:525: pausing arms reinit so the
                # next unpaused frame re-acquires the subject
                tracker.reinit = True


def _cv_key_source():
    """Default interactive key source: cv2.waitKey when a display exists."""
    try:
        import cv2

        return lambda: cv2.waitKey(1)
    except ImportError:
        return lambda: -1


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("rtree", nargs="?", default="",
                    help="forest model path (.srtr)")
    ap.add_argument("--camera", default="synthetic",
                    help="'k4a', 'freenect2', 'synthetic', or a dataset dir")
    ap.add_argument("--betapose", type=float, default=0.05)
    ap.add_argument("--betashape", type=float, default=0.12)
    ap.add_argument("-I", "--data-interval", type=int, default=12)
    ap.add_argument("-t", "--frame-icp-iters", type=int, default=3)
    ap.add_argument("-T", "--reinit-icp-iters", type=int, default=5)
    ap.add_argument("--initial-icp-iters", type=int, default=7)
    ap.add_argument("--inner-iters", type=int, default=10)
    ap.add_argument("-M", "--min-points", type=int, default=1000)
    ap.add_argument("--nn-dist", type=float, default=0.002,
                    help="bg subtractor nn distance rel (live-demo.cpp)")
    ap.add_argument("--neighb-dist", type=float, default=0.001)
    ap.add_argument("--dist-to-pre-weight", type=float, default=0.001)
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = run until interrupted)")
    ap.add_argument("--out", default="", help="write overlay frames here")
    ap.add_argument("--capture-bg-after", type=int, default=0,
                    help="treat frame N as the background "
                         "(the reference binds this to the 'b' key)")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--metrics", default="",
                    help="write per-frame metrics JSONL here")
    ap.add_argument("--part-groups", action="store_true",
                    help="group-level correspondence for 24-part SMPL trees")
    ap.add_argument("--beta-temp", type=float, default=None,
                    help="temporal pose-prior weight (fused tracker; "
                         "default from TrackerConfig)")
    ap.add_argument("--no-render-labels", action="store_true",
                    help="disable the model-predicted label override")
    ap.add_argument("--interactive", action="store_true",
                    help="start PAUSED with the reference's keyboard loop "
                         "(space = unpause + capture background, b = "
                         "recapture, q = quit; live-demo.cpp:491-529); "
                         "reads keys from the display window")
    add_partmap_arg(ap)
    add_model_args(ap)
    return ap


def main(argv=None, key_source=None, on_frame=None):
    """Run the live demo.

    key_source: optional callable returning a keycode (or -1) per frame —
    tests inject scripted sequences here; interactive runs poll the
    display window.  on_frame: optional callback
    ``(frame_no, state, result_or_None)`` for observability/testing.
    """
    args = build_parser().parse_args(argv)
    model = load_model(args)
    cam = open_camera(args.camera, device=args.device)
    intrin = cam.intrinsics()
    H, W = cam.image_size()
    rtree = RTree(args.rtree, device=args.device) if args.rtree else None
    if args.partmap and rtree is not None:
        set_partmap(rtree, args.partmap)

    part_groups = None
    if args.part_groups:
        from avatar_tpu_torch.perception.partgroups import SMPL24_GROUP_LUT

        part_groups = tuple(SMPL24_GROUP_LUT)
    cfg = TrackerConfig(
        beta_pose=args.betapose, beta_shape=args.betashape,
        data_interval=args.data_interval,
        frame_icp_iters=args.frame_icp_iters,
        reinit_icp_iters=args.reinit_icp_iters,
        initial_icp_iters=args.initial_icp_iters,
        iters_per_icp=args.inner_iters, min_points=args.min_points,
        nn_dist_thresh_rel=args.nn_dist,
        neighb_thresh_rel=args.neighb_dist,
        dist_to_pre_weight=args.dist_to_pre_weight,
        part_groups=part_groups,
        **({} if args.beta_temp is None
           else dict(beta_temp=args.beta_temp)),
        render_labels=not args.no_render_labels)
    if args.fused:
        from avatar_tpu_torch.tracking_fused import FusedTracker

        tracker = FusedTracker(model, intrin, (H, W), rtree=rtree, config=cfg)
    else:
        tracker = Tracker(model, intrin, (H, W), rtree=rtree, config=cfg)
    if args.metrics:
        tracker.open_metrics(args.metrics)

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    state = LiveDemoState(start_paused=args.interactive)
    if key_source is None:
        key_source = _cv_key_source() if args.interactive else (lambda: -1)
    if args.interactive:
        print("Note: paused, press space to begin. The background (for BG "
              "subtraction) will be captured each time you unpause.",
              file=sys.stderr)

    cam.begin_capture()
    n = 0
    last_id = -1
    oracle = None
    warmed = not args.fused        # only FusedTracker exposes warmup()
    try:
        while not state.quit:
            frame, fid = cam.get_frame()
            if frame is None or fid == last_id:
                time.sleep(0.002)
                continue
            last_id = fid
            xyz, rgb = frame
            state.handle_key(key_source(), tracker, xyz)
            if state.quit:
                break
            if state.pause:
                # reference pause branch (live-demo.cpp:273-289): show
                # PAUSED, do not track or advance the recording
                if on_frame is not None:
                    on_frame(n, state, None)
                n += 1
                if args.frames and n >= args.frames:
                    break
                continue
            if args.capture_bg_after and n == args.capture_bg_after:
                tracker.set_background(xyz)
                state.bg_set = True
                print("[live] background captured", file=sys.stderr)
            if rtree is None and hasattr(cam, "gt"):
                # synthetic camera without a forest: oracle labels
                from avatar_tpu_torch.render.renderer import AvatarRenderer

                rend = AvatarRenderer(cam.gt, intrin)
                oracle = rend.render_part_mask((H, W))
            if not warmed and (state.bg_set or not args.capture_bg_after):
                # pay every first-use cost (the kernel's build and load,
                # the allocator, cuBLAS / cuSOLVER) on the first tracked
                # frame, so no later frame stalls the real-time loop; after
                # the background is set when one is to be captured, so the
                # warmed frames see the subtraction the live ones do
                tracker.warmup(xyz, labels_override=oracle)
                warmed = True
            res = tracker.track(xyz, labels_override=oracle)
            status = ("ok" if res.ok else "lost")
            if on_frame is not None:
                on_frame(n, state, res)
            if n % 10 == 0:
                print(f"frame {n}: {status} pts={res.n_points}",
                      file=sys.stderr)
            if args.out and res.ok and not args.fused:
                overlay = tracker.render_overlay(rgb)
                try:
                    import cv2

                    cv2.imwrite(os.path.join(args.out,
                                             f"live_{n:06d}.png"), overlay)
                except ImportError:
                    pass
            n += 1
            if args.frames and n >= args.frames:
                break
    finally:
        cam.end_capture()
    if args.metrics:
        tracker.close_metrics()
    print(tracker.timer.report())


if __name__ == "__main__":
    main()
