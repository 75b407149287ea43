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

With ``--paths`` each run measures instead, per path -- the fused
tracker's reinit frame and steady frames, the accuracy mode's refine
frames, the host tracker's steady frames and a ``track_batch`` of 16 --
what its LM fits cost: the frame's wall ms (no clock), the fit's and the
refine's elapsed ms under the stage clock and the synchronising copies and
reads the clock counts inside them (``reads``; 0 for a checkout whose
program counts none), and from a ``torch.profiler`` trace (last) the
launches the host issues inside them (runtime and driver launch calls: a
kernel's, or a whole CUDA graph's) beside the device's busy ms and kernel
count there.
Every fused tracker is warmed (``warmup``) first; the host tracker, which
has none, is measured on frames 2-5.
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


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaGraphLaunch", "cuLaunchKernel", "cuLaunchKernelEx")
FIT_SCOPES = ("fit", "refine")


def _host_launches(log_dir: str, profiling) -> dict:
    """Launch calls the host made inside each fit scope of the traces in
    ``log_dir`` (by the call's own host timestamp), and in all."""
    import glob
    import gzip

    counts = dict.fromkeys(FIT_SCOPES + ("all",), 0)
    for path in glob.glob(os.path.join(log_dir, "*.trace.json.gz")):
        with gzip.open(path, "rt") as fh:
            events = [ev for ev in json.load(fh).get("traceEvents", [])
                      if ev.get("ph") == "X"]
        index = profiling._ScopeIndex([ev for ev in events
                                       if ev.get("cat") == "user_annotation"])
        calls = sorted((ev["ts"], (ev.get("pid"), ev.get("tid")))
                       for ev in events
                       if ev.get("cat") in ("cuda_runtime", "cuda_driver")
                       and ev.get("name") in _LAUNCH_CALLS)
        by_thread = {}
        for ts, thread in calls:
            by_thread.setdefault(thread, []).append(ts)
        for thread, stamps in by_thread.items():
            for scopes in index.paths(thread, stamps):
                counts["all"] += 1
                for name in FIT_SCOPES:
                    if name in scopes:
                        counts[name] += 1
    return counts


def measure_paths(root: str) -> dict:
    """Per path: frame wall ms, the fits' elapsed ms, synchronising reads,
    host launch calls, device busy ms and kernels (see the docstring)."""
    sys.path.insert(0, root)
    import tempfile

    import numpy as np
    import torch

    import chip_smoke
    from avatar_tpu_torch import profiling
    from avatar_tpu_torch.device import get_device

    torch.use_deterministic_algorithms(True)
    dev = get_device("cuda:0")
    scene = chip_smoke.Scene(dev)
    frames = scene.frames
    xyzs = [scene.intrin.depth_to_xyz_np(f.astype(np.float32) * 1e-3)
            for f in frames]
    order = [1, 2, 3, 4, 5, 4, 3, 2]
    wide = [frames[order[i % len(order)]] for i in range(16)]
    acc = dict(refine_every=1, refine_steps=2)

    def fused(**kw):
        def make():
            tracker = scene.tracker(**kw)
            tracker.warmup(frames[0])
            return tracker
        return make

    def steps_of(seq, lo, hi):
        def run(tracker, each):
            for i, frame in enumerate(seq[:hi]):
                each(i >= lo, lambda f=frame: [tracker.track(f)])
        return run

    def batch(tracker, each):
        tracker.track(frames[0])
        each(True, lambda: tracker.track_batch(wide))

    # (name, a fresh tracker, the frames: run(tracker, each) calls
    # each(measured, step) per step, frames per measured step)
    paths = (("fused_reinit", fused(), steps_of(frames, 0, 1), 1),
             ("fused_steady", fused(), steps_of(frames, 1, 6), 1),
             ("accuracy_steady", fused(**acc), steps_of(frames, 1, 6), 1),
             ("host_steady", lambda: chip_smoke._host_tracker(scene),
              steps_of(xyzs, 2, 6), 1),
             ("batch16", fused(), batch, len(wide)))
    out, rows_of = {}, {}
    for name, make, run, per in paths:
        rows = rows_of[name] = {"wall": [], "clock": [], "syncs": []}

        def plain(measured, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step()
            torch.cuda.synchronize()
            if not all(r.ok for r in res):
                sys.exit(f"{root}: {name} lost track")
            if measured:
                rows["wall"].append((time.perf_counter() - t0) * 1e3 / per)

        def clocked(measured, step):
            with profiling.stage_clock(dev) as clock:
                step()
            if measured:
                rows["clock"].append({k: clock.stages.get(k, {}).get(
                    "elapsed_ms", 0.0) / per for k in FIT_SCOPES})
                rows["syncs"].append({k: sum(
                    v.get("counts", {}).get("reads", 0)
                    for s, v in clock.stages.items()
                    if s.split("/")[0] == k) / per for k in FIT_SCOPES})

        for each in (plain, clocked):
            run(make(), each)
    # the traces last: a process that has run the profiler pays more for
    # every launch after it
    for name, make, run, per in paths:
        rows = rows_of[name]
        tracker, traced = make(), []

        def note(measured, step):
            traced.append(measured)
            if measured:
                with tempfile.TemporaryDirectory() as tmp:
                    with profiling.device_trace(tmp, dev):
                        step()
                        torch.cuda.synchronize()
                    attr = profiling.trace_attribution(tmp, per)
                    launches = _host_launches(tmp, profiling)
                traced[-1] = (attr, launches)
            else:
                step()
        run(tracker, note)
        rec = [t for t in traced if t is not False]
        med = lambda vals: float(np.median(vals)) if vals else None
        line = dict(
            wall_ms=med(rows["wall"]),
            wall_ms_spread=[min(rows["wall"]), max(rows["wall"])],
            frames=len(rows["wall"]) * per)
        for k in FIT_SCOPES:
            busy = [a["scopes"].get(k, {}) for a, _ in rec]
            line[k] = dict(
                elapsed_ms=med([r[k] for r in rows["clock"]]),
                syncs=med([r[k] for r in rows["syncs"]]),
                host_launches=med([n[k] / per for _, n in rec]),
                busy_ms=med([b.get("ms", 0.0) for b in busy]),
                device_launches=med([b.get("launches", 0.0) for b in busy]))
        line["frame_busy_ms"] = med([a["total_ms"] for a, _ in rec])
        line["frame_host_launches"] = med([n["all"] / per for _, n in rec])
        out[name] = line
    return dict(root=root, deterministic_algorithms=True, paths=out)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--other", nargs="*", default=[])
    ap.add_argument("--clock", action="store_true",
                    help="also time this checkout under the stage clock")
    ap.add_argument("--paths", action="store_true",
                    help="per path: the LM fits' elapsed ms, synchronising "
                         "reads, host launch calls and busy ms")
    ap.add_argument("--measure", default="",
                    help="(internal) measure this checkout root in-process")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure_paths(args.measure) if args.paths else
                         measure(args.measure, args.repeats, args.clock)))
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
            + (["--clock"] if args.clock and root == HERE else [])
            + (["--paths"] if args.paths else []),
            capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            sys.exit(f"measuring {root} failed:\n{out.stderr}")
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
