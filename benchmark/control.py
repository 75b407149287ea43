"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        --seconds 6 [--deterministic] [--out FILE]

For each seed, in one process: the cell's set-up and a short window of
the program at the cell's own size and load; then, on the frames a run
would compare, the gaps between the program and the plain reference
(the program's readings) and between the control and the reference.  The
control is the reference put in the program's place and run with TF32
matmuls allowed: the nearest precision below the float32 that the
configurations state.  ``--deterministic`` runs the program with
``torch.use_deterministic_algorithms(True)``, which shows how much of
the program's gap is the order of its floating-point atomics; the
reference run twice from the same state shows the same of the reference.
Prints one JSON line per seed (and appends it to ``--out``): each gap per
compared frame and the largest, for the program and the control.  Needs a CUDA
device; the benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(cell, seed: int, seconds: float, dev,
             deterministic: bool = False) -> dict:
    """One seed's readings (the module docstring)."""
    import gc

    import torch

    from harness import check
    from harness.cell import set_up, window
    from harness.trackers import build_reference

    if deterministic:
        torch.use_deterministic_algorithms(True)
    try:
        scene, runner, k = set_up(cell, seed, dev)
        records, _, _ = window(runner, scene, k, seconds, dev, None)
    finally:
        torch.use_deterministic_algorithms(False)
    del runner
    gc.collect()
    picks = check.pick_frames(records, seed, cell.traffic["check_frames"],
                              cell.traffic["check_reinit"])
    reference = build_reference(cell.config, scene, dev)
    program = check.frame_gaps(records, picks, scene, reference)

    def outputs():
        out = {}
        for i in picks:
            reference.set_state(records[i]["state_before"])
            out[i] = reference.feed(scene.frames[records[i]["frame"]])
        return out

    # the reference against itself: the spread of its own atomics
    again = check.frame_gaps(records, picks, scene, reference,
                             outputs=outputs())
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctl_out = outputs()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    control = check.frame_gaps(records, picks, scene, reference,
                               outputs=ctl_out)
    line = dict(
        workload=cell.name, seed=seed, deterministic=deterministic,
        frames=len(records),
        compared=[dict(k=records[i]["k"], kind=records[i]["kind"])
                  for i in picks],
        program=program, program_numbers=check.numbers(program),
        reference_again_numbers=check.numbers(again),
        control=control, control_numbers=check.numbers(control))
    del reference, scene, records
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ["USE_FLAX"] = "0"
    if args.deterministic:
        # cuBLAS needs a fixed workspace for deterministic results
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from harness import spec

    cell = spec.load_cell(args.workload, ROOT / "BENCHMARK.json")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        line = readings(cell, seed, args.seconds, dev, args.deterministic)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
