"""Wall ms per tracked frame of the bench's fused tracker, for this
checkout and, in turns with it, for other checkouts of the port.

    python3 scripts/frame_wall_torch.py [--repeats 3] [--clock] [--other PATH ...]

Each run builds ``chip_smoke.Scene`` of its checkout (the detail-6 model,
the 3-tree r5 forest, 14 groups, background subtraction, 1280x720) and
tracks the 6 fixture frames ``--repeats`` times with a fresh tracker each
time, deterministic algorithms on as ``chip_smoke.py`` has them, no stage
clock and no profiler.  It reports the steady frames' wall ms (host clock
to a synchronise; frames 2-5 of each repeat, the first repeat left out as
warm-up) and the reinit frame's.  With ``--other`` it runs this checkout,
the others, the others again and this checkout again (a process each,
since the checkouts share a package name), so that two versions are
compared on one card within one call.  With ``--clock`` every repeat of
this checkout is followed by one under ``profiling.stage_clock`` (one clock
per frame), reported as ``clocked_steady_wall_ms_median``: what the clock
costs when it is on.  Prints the card's name and power limit first, then
one JSON line per run.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str, repeats: int, clock: bool = False) -> dict:
    sys.path.insert(0, root)
    import contextlib

    import numpy as np
    import torch

    import chip_smoke
    from avatar_tpu_torch.device import get_device

    torch.use_deterministic_algorithms(True)
    dev = get_device("cuda:0")
    scene = chip_smoke.Scene(dev)
    if clock:
        from avatar_tpu_torch.profiling import stage_clock
    steady, clocked, reinit, pose = [], [], [], None
    for rep in range(repeats + 1):
        for on in (False, True) if clock else (False,):
            tracker = scene.tracker()
            for i, frame in enumerate(scene.frames):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with stage_clock(dev) if on else contextlib.nullcontext():
                    res = tracker.track(frame)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if not res.ok:
                    sys.exit(f"{root}: frame {i} lost track")
                if rep and i >= 2:
                    (clocked if on else steady).append(ms)
                elif rep and i == 0 and not on:
                    reinit.append(ms)
            pose = float(np.abs(tracker.pose()[1]).sum())
    out = dict(root=root, repeats=repeats, deterministic_algorithms=True,
               steady_wall_ms_median=float(np.median(steady)),
               steady_wall_ms_min=min(steady), steady_wall_ms_max=max(steady),
               steady_frames=len(steady),
               reinit_wall_ms_median=float(np.median(reinit)),
               pose_checksum=pose)
    if clock:
        out.update(clocked_steady_wall_ms_median=float(np.median(clocked)),
                   clocked_steady_wall_ms_min=min(clocked),
                   clocked_steady_wall_ms_max=max(clocked))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--other", nargs="*", default=[])
    ap.add_argument("--clock", action="store_true",
                    help="also time this checkout under the stage clock")
    ap.add_argument("--measure", default="",
                    help="(internal) measure this checkout root in-process")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.repeats, args.clock)))
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    others = [os.path.abspath(p) for p in args.other]
    for root in [HERE] + others + others + ([HERE] if others else []):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", root,
             "--repeats", str(args.repeats)]
            + (["--clock"] if args.clock and root == HERE else []),
            capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            sys.exit(f"measuring {root} failed:\n{out.stderr}")
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
