"""Frames per second of the forest trainer's frame generation (render and
sample, ``ForestTrainer._init_samples``) by the bench forest's recipe, for
this checkout and, in turns with it, for other checkouts of the port.

    python3 scripts/frame_rate_torch.py [--images 288] [--other PATH ...]

With ``--other`` it runs this checkout, the others, the others again and
this checkout again (a process each, since the checkouts share a package
name), so that two versions are compared on one card within one call.
Prints one JSON line per run and the card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str, images: int, device: str) -> dict:
    sys.path[:0] = [root, os.path.join(root, "scripts")]
    import torch
    import train_bench_forest_torch as bench

    from avatar_tpu_torch.testing import synthetic_model

    model = synthetic_model(detail=6, device=device)
    sync = torch.cuda.synchronize if device.startswith("cuda") else (
        lambda: None)
    rates = []
    for _ in range(3):                      # the first run warms up
        trainer = bench.make_trainer(model, images, 2)
        sync()
        t0 = time.perf_counter()
        trainer._init_samples()
        sync()
        rates.append(images / (time.perf_counter() - t0))
    return dict(root=root, images=images, frames_per_s=rates[1:],
                samples=int(trainer.samples.valid.sum()),
                cache_sum=int(trainer._depth_cache.long().sum()))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", type=int, default=288)
    ap.add_argument("--other", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--measure", default="",
                    help="(internal) measure this checkout root in-process")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.images, args.device)))
        return
    if args.device.startswith("cuda"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())
    others = [os.path.abspath(p) for p in args.other]
    for root in [HERE] + others + others + ([HERE] if others else []):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", root,
             "--images", str(args.images), "--device", args.device],
            capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"measuring {root} failed:\n{out.stderr}")
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
