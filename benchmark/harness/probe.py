"""What the traced run (``--trace 1``) records, from the benchmark's side of
the program's calls: per frame the program's stage clock
(``profiling.stage_clock``: elapsed ms and entries per scope), the
searches the frame ran (``nn_kernel.LAUNCHES``), and the shapes of each
fit and its search (wrappers around ``fit`` and ``correspond.matcher``);
then a ``torch.profiler`` trace of a short sub-window, and the device time
of the steady fit's search."""

from __future__ import annotations

import gzip
import json
import os
import shutil
import threading
from collections import defaultdict
from typing import List, Optional

import torch

import roofline

# runtime and driver calls that launch work: a kernel's, or a whole graph's
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
                "cuLaunchKernel", "cuLaunchKernelEx")
FRAME_MARK = "bench/frame"


class FitProbe:
    """Records each fit's shapes (model vertices P, joints J, shape keys K,
    tangent size D, data rows N) and its search's tile ranges while
    installed."""

    def __init__(self):
        self.fits: List[dict] = []
        self._cur = threading.local()
        self._saved = []

    def install(self) -> None:
        from avatar_tpu_torch import tracking_fused
        from avatar_tpu_torch.optim import correspond, optimizer

        def wrap_fit(real):
            def fit(ctx, parents, data_pts, *args, **kw):
                J = len(parents)
                K = ctx.lbs.shapedirs.shape[2]
                rec = dict(P=ctx.lbs.weights.shape[0], J=J, K=K,
                           D=3 + 3 * J + (0 if kw.get("freeze_shape")
                                          else K),
                           N=data_pts.shape[0], match=None)
                self._cur.rec = rec
                try:
                    return real(ctx, parents, data_pts, *args, **kw)
                finally:
                    self._cur.rec = None
                    self.fits.append(rec)
            return fit

        real_matcher = correspond.matcher

        def matcher(*args, **kw):
            out = real_matcher(*args, **kw)
            rec = getattr(self._cur, "rec", None)
            if rec is not None:
                rec["match"] = out[2]
            return out

        for mod, name, new in ((tracking_fused, "fit", wrap_fit),
                               (optimizer, "fit", wrap_fit),
                               (correspond, "matcher", lambda r: matcher)):
            real = getattr(mod, name)
            self._saved.append((mod, name, real))
            setattr(mod, name, new(real))

    def uninstall(self) -> None:
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)
        self._saved = []

    def take(self) -> List[dict]:
        out, self.fits = self.fits, []
        return out


def searches() -> int:
    from avatar_tpu_torch.optim import nn_kernel
    return int(sum(nn_kernel.LAUNCHES.values()))


def pairs_of(match) -> int:
    """Scanned pairs of one search (``roofline.search_pairs``)."""
    if match.cstart is None:
        ranges = [(0, match.pp // match.chunk)] * (match.n // match.tile_n)
    else:
        ranges = list(zip(match.cstart.tolist(), match.cend.tolist()))
    return roofline.search_pairs(ranges, match.chunk, match.tile_n)


def search_device_ms(match, cloud: torch.Tensor, wild: int,
                     calls: int = 50) -> float:
    """Device ms per call of ``nn_kernel.nn_match`` on ``match``: CUDA
    events around ``calls`` calls queued behind a held device, so the
    calls run back to back and the host's enqueue cost stays out."""
    from avatar_tpu_torch.optim import nn_kernel
    dev = cloud.device
    cloud = cloud[:match.p].contiguous()
    center = cloud.mean(0)
    visible = torch.ones(match.p, dtype=torch.bool, device=dev)
    for _ in range(3):
        nn_kernel.nn_match(match, cloud, center, visible, wild)
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(20e6))          # ~10 ms of queued device work
    a.record()
    for _ in range(calls):
        nn_kernel.nn_match(match, cloud, center, visible, wild)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def _union(intervals):
    """Merged [start, end] intervals of ``intervals`` (sorted)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, s, e) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged)


def _innermost(spans, stamps) -> List[str]:
    """The innermost span open at each of ``stamps`` (ascending)."""
    spans = sorted(spans, key=lambda a: (a[0], -a[1]))
    out, stack, i = [], [], 0
    for ts in stamps:
        while i < len(spans) and spans[i][0] <= ts:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= ts:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no scope)")
    return out


def parse_trace(log_dir: str) -> Optional[dict]:
    """Reduce the Chrome traces in ``log_dir`` (``profiling.device_trace``)
    over the frames marked ``FRAME_MARK``: device busy seconds (the union of
    kernel, memcpy and memset intervals), the frames' wall, the host's
    launch calls inside the frames, the device operations that took most
    time, and the idle gaps by the innermost host scope open at their
    middle.  None without device events."""
    frames, device, launches = [], [], 0
    names = defaultdict(float)
    annotations = defaultdict(list)
    for root, _, files in os.walk(log_dir):
        for fn in sorted(files):
            if not fn.endswith(".trace.json.gz"):
                continue
            with gzip.open(os.path.join(root, fn), "rt") as fh:
                events = json.load(fh).get("traceEvents", [])
            calls = []
            for ev in events:
                if ev.get("ph") != "X":
                    continue
                cat = ev.get("cat")
                ts, dur = float(ev["ts"]), float(ev.get("dur", 0))
                if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                    device.append((ts, ts + dur))
                    names[ev.get("name", "?")] += dur
                elif cat == "user_annotation":
                    if ev.get("name") == FRAME_MARK:
                        frames.append((ts, ts + dur))
                    annotations[(ev.get("pid"), ev.get("tid"))].append(
                        (ts, ts + dur, ev.get("name", "?")))
                elif cat in ("cuda_runtime", "cuda_driver") and \
                        ev.get("name") in LAUNCH_CALLS:
                    calls.append(ts)
            launches += len(calls)
    if not device or not frames:
        return None
    merged = _union(device)
    frames.sort()
    wall_us = sum(e - s for s, e in frames)
    busy_in_frames = sum(_overlap(merged, s, e) for s, e in frames)
    w0, w1 = frames[0][0], frames[-1][1]
    # idle gaps inside the traced window, by the host's innermost scope
    thread = max(annotations, key=lambda k: sum(
        1 for a in annotations[k] if a[2] == FRAME_MARK))
    edges = [(w0, w0)] + [tuple(m) for m in merged] + [(w1, w1)]
    idle = [(max(e0, w0), min(s1, w1)) for (_, e0), (s1, _) in
            zip(edges, edges[1:]) if min(s1, w1) > max(e0, w0)]
    gaps = defaultdict(float)
    for (a, b), name in zip(idle, _innermost(annotations[thread],
                                             [0.5 * (a + b)
                                              for a, b in idle])):
        gaps[name] += (b - a) * 1e-6
    top = lambda d, scale: [[k, v * scale] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(
        n_frames=len(frames), busy_s=_overlap(merged, w0, w1) * 1e-6,
        window_s=(w1 - w0) * 1e-6, frames_wall_s=wall_us * 1e-6,
        busy_in_frames_s=busy_in_frames * 1e-6,
        host_launches=launches,
        device_ops=top(names, 1e-6), idle_gaps=top(gaps, 1.0))


def traced_frames(runner, frames, device, tmp_root: str) -> Optional[dict]:
    """Track ``frames`` under ``profiling.device_trace``, each marked
    ``FRAME_MARK``; the reduced trace, its files deleted."""
    from avatar_tpu_torch.profiling import device_trace
    log_dir = os.path.join(tmp_root, f"bench_trace_{os.getpid()}")
    try:
        with device_trace(log_dir, device):
            for frame in frames:
                with torch.profiler.record_function(FRAME_MARK):
                    runner.feed(frame)
        return parse_trace(log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
