"""Record camera streams into the OpenARK dataset layout (counterpart of
``avatar_tpu/tools/data_recording.py``).

Rebuild of reference data-recording.cpp:40-300: capture depth (+RGB) frames
from a camera backend into <out>/depth_exr (+rgb) with intrin.txt, and
optionally re-verify the recording by reloading every frame (--verify,
data-recording.cpp:268-298).  The synthetic camera renders on ``--device``
(the card by default).  RGB frames are written through OpenCV.

    python -m avatar_tpu_torch.tools.data_recording OUT_DIR --camera synthetic \\
        --frames 30 --verify
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from avatar_tpu_torch.io.camera import open_camera
from avatar_tpu_torch.io.dataset import Dataset, DatasetWriter


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--camera", default="synthetic",
                    help="'k4a', 'freenect2', 'synthetic', or a dataset dir")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--verify", action="store_true",
                    help="reload the recording and check frame counts + "
                         "intrinsics parse (data-recording.cpp:268-298)")
    ap.add_argument("--device", default="cuda",
                    help="where the synthetic camera renders (default: the "
                         "card; there is no silent CPU fallback)")
    args = ap.parse_args(argv)

    cam = open_camera(args.camera, device=args.device, fps_cap=args.fps)
    writer = DatasetWriter(args.out_dir, cam.intrinsics(), pad=4)
    cam.begin_capture()
    written = 0
    last_id = -1
    try:
        while written < args.frames:
            frame, fid = cam.get_frame()
            if frame is None or fid == last_id:
                time.sleep(0.002)
                continue
            last_id = fid
            xyz, rgb = frame
            writer.write_depth(written + 1, xyz[..., 2])
            if rgb is not None:
                writer.write_rgb(written + 1, rgb)
            written += 1
            if written % 10 == 0:
                print(f"[record] {written}/{args.frames}", file=sys.stderr)
    finally:
        cam.end_capture()
    print(f"recorded {written} frames to {args.out_dir}")

    if args.verify:
        ds = Dataset(args.out_dir, pad=4)
        count = sum(1 for _ in ds.frames(start=1))
        assert count == written, f"verify failed: {count} != {written}"
        d = ds.depth(1)
        assert np.isfinite(d).all()
        assert ds.intrin.fx > 0
        print(f"verify ok: {count} frames, intrinsics fx={ds.intrin.fx}")


if __name__ == "__main__":
    main()
