"""Stage profiling (counterpart of ``avatar_tpu/profiling.py``).

``utils.StageTimer`` measures host wall time per pipeline stage.  These
helpers say where a frame's time goes on the device, in two ways:

    from avatar_tpu_torch.profiling import (device_trace, stage_clock,
                                            trace_attribution)

    with stage_clock(device) as clock:        # elapsed time per scope
        tracker.track(frame)
    clock.stages["fit/nn"]                    # elapsed_ms, host_ms, entries,
                                              # counts

    with device_trace(log_dir, device):       # torch.profiler, Chrome trace
        for frame in frames:
            tracker.track(frame)
    trace_attribution(log_dir, len(frames))   # busy ms per frame by stage

The tracker's stages and the parts of an LM step are marked with
``scope(name)`` (``tracking_fused._fused_frame_impl``, ``tracking.Tracker``,
``optim/gauss_newton``), below one ``frame`` root per ``track`` call that
holds the whole call: the upload, the stages, the diagnostics read and the
state update.  On the card an LM step is the replay of a captured
CUDA graph, marked as one scope, ``step``, beside the host read ``sync``;
a step that re-linearizes is also the span ``lin`` (``fit/step/lin``;
``fit/lin`` where the steps run uncaptured, its parts keeping their
paths), whose entries count the linearizations;
the parts of a step show only in a run with ``gauss_newton.eager_steps()``,
and a scope opened while a graph is being captured records no event.  A
scope always enters
``torch.profiler.record_function``, which is what ``trace_attribution``
reads back.  Only while a ``stage_clock`` is active on the calling thread
does it also record an event at entry and exit (a CUDA event on the
current stream, the host clock on the CPU).  With no clock active a scope
records no event, reads nothing back and synchronises nothing.

*Counts.*  ``count(name, k)`` adds ``k`` to the innermost scope open under
this thread's stage clock; with no clock active it returns after one
thread-local lookup.  A scope's counts are its own, not its children's;
what is counted under a clock with no scope open goes to one top-level
entry, ``UNSCOPED``, so a block's totals are complete.  The counters:

    reads     the host's waits on the card: every synchronising copy or
              read on a tracked frame's path goes through ``host_read``,
              ``to_device`` (a copy from pageable host memory waits for
              the stream as a read does) or, for an operation that reads
              back on its own (``bincount``, ``nonzero``), ``host_sync``
    read_ms   the host's blocked time in those reads (host clock)
    steps     LM steps run by a fit (``optim/gauss_newton``)

While a profiler records, a read also enters ``record_function(READ_SPAN)``,
so it sits on the profiler's timeline beside the kernels; it opens no
scope.
``counted_syncs_only()`` makes every other synchronisation raise (the card
test that every sync of a frame is counted).

*Elapsed is not busy.*  The clock's ``elapsed_ms`` is the device timeline
between a scope's two events, idle gaps included: a stage that waits on
the host reads long on the clock.  ``trace_attribution`` sums the time the
device spent in kernels and copies launched inside each scope.  The ratio
of the two is the share of a stage in which the card worked.

The reference's ``PEAK_FLOPS_V5E``, ``gflops`` and ``mfu`` have no
counterpart: ``torch.profiler`` records no per-kernel operation count.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np
import torch

try:    # private, and the cheapest check; if it moves, reads still trace
    from torch._C._autograd import _profiler_enabled
except ImportError:
    from torch.autograd import profiler as _autograd_profiler

    def _profiler_enabled() -> bool:
        return getattr(_autograd_profiler, "_is_profiler_enabled", True)

from avatar_tpu_torch.device import get_device

# the root scope of one tracked frame; reported paths are relative to it
FRAME_SCOPE = "frame"
# the stage clock's entry for counts made with no scope open
UNSCOPED = "(unscoped)"
# the profiler's name for a counted read
READ_SPAN = "host_read"
# trace_attribution's stage of each scope name (the reference's buckets)
_STAGE_OF = {"fit": "fit", "refine": "fit", "forest_walk": "walk",
             "blob_suppress": "blob_cc", "bgsub": "bgsub"}
STAGES = ("bgsub", "walk", "blob_cc", "fit", "frame_glue", "other")

_active = threading.local()
_event_pool: List = []
_strict = False     # counted_syncs_only() is active


def _new_event():
    return torch.cuda.Event(enable_timing=True)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageClock:
    """What ``stage_clock`` yields.  After the block, ``stages`` maps each
    scope path (``"fit/nn"``; paths below the ``frame`` root leave it out)
    to ``elapsed_ms`` (device timeline on the card, host clock on the CPU),
    ``host_ms`` (host clock, always), ``entries``, ``depth`` (1 for a
    scope directly below the frame root) and ``counts`` ({name: total} of
    ``count`` calls made directly in the scope); counts made with no scope
    open are under ``UNSCOPED``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        self.stages: Dict[str, dict] = {}
        self._open: List[list] = []      # the open scopes' records
        self._records: List[list] = []
        self._unscoped: Dict[str, float] = {}

    def _mark(self):
        if not self.on_card:
            return None
        ev = _event_pool.pop() if _event_pool else _new_event()
        ev.record()
        return ev

    def _enter(self, name: str, nests: bool = True) -> list:
        path = (self._open[-1][0] if self._open else []) + [name]
        rec = [path, self._mark(), None, time.perf_counter(), 0.0, None]
        if nests:
            self._open.append(rec)
        return rec

    def _exit(self, rec: list, nests: bool = True) -> None:
        rec[2] = self._mark()
        rec[4] = time.perf_counter()
        if nests:
            self._open.pop()
        self._records.append(rec)

    def _count(self, name: str, k) -> None:
        if self._open:
            rec = self._open[-1]
            counts = rec[5]
            if counts is None:
                counts = rec[5] = {}
        else:
            counts = self._unscoped
        counts[name] = counts.get(name, 0) + k

    def _finish(self) -> None:
        """One synchronise, then every event pair is read and pooled."""
        _synchronize(self.device)
        for path, start, end, t0, t1, counts in self._records:
            host_ms = (t1 - t0) * 1e3
            if self.on_card:
                elapsed = start.elapsed_time(end)
                _event_pool.extend((start, end))
            else:
                elapsed = host_ms
            root = path.index(FRAME_SCOPE) if FRAME_SCOPE in path else -1
            st = self.stages.setdefault(_rel(path), dict(
                elapsed_ms=0.0, host_ms=0.0, entries=0,
                depth=len(path) - 1 - root, counts={}))
            st["elapsed_ms"] += elapsed
            st["host_ms"] += host_ms
            st["entries"] += 1
            for name, k in (counts or {}).items():
                st["counts"][name] = st["counts"].get(name, 0) + k
        if self._unscoped:
            self.stages[UNSCOPED] = dict(elapsed_ms=0.0, host_ms=0.0,
                                         entries=0, depth=0,
                                         counts=dict(self._unscoped))
        self._records = []
        self._unscoped = {}


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class scope:
    """Mark a stage: ``with scope("fit"): ...``.  Scopes nest.  With
    ``nests=False`` the scope is a span the stage clock times and counts
    at its own path, under the scope open around it, while the scopes
    inside it keep their paths (and counts made inside it go to that
    outer scope); it enters no ``record_function``, so the profiler's
    paths do not change either (``gauss_newton``'s eager ``lin`` span)."""

    __slots__ = ("name", "nests", "_fn", "_clock", "_rec")

    def __init__(self, name: str, nests: bool = True):
        self.name = name
        self.nests = nests

    def __enter__(self):
        self._fn = None
        if self.nests:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self._clock = getattr(_active, "clock", None)
        if self._clock is not None and self._clock.on_card and \
                _capturing():
            self._clock = None      # an event would be captured, not timed
        if self._clock is not None:
            self._rec = self._clock._enter(self.name, self.nests)
        return self

    def __exit__(self, *exc):
        if self._clock is not None:
            self._clock._exit(self._rec, self.nests)
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def count(name: str, k=1) -> None:
    """Add ``k`` to counter ``name`` of the innermost scope open under this
    thread's stage clock (of ``UNSCOPED`` with none open); nothing with no
    clock active."""
    clock = getattr(_active, "clock", None)
    if clock is not None:
        clock._count(name, k)


class host_sync:
    """Mark a block that synchronises the card once (``n`` times where one
    operation waits more than once): ``with host_sync(): changed =
    bool(mask.any())``.  Under a stage clock the enclosing scope counts
    ``n`` ``reads`` and the host's blocked time as ``read_ms``; while a
    profiler records, the block enters ``record_function(READ_SPAN)``
    (with neither, a read costs a few microseconds).  Opens no scope."""

    __slots__ = ("n", "_fn", "_clock", "_t0", "_mode")

    def __init__(self, n: int = 1):
        self.n = n

    def __enter__(self):
        self._fn = None
        if _profiler_enabled():
            self._fn = torch.profiler.record_function(READ_SPAN)
            self._fn.__enter__()
        self._mode = None
        if _strict:
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
        self._clock = getattr(_active, "clock", None)
        if self._clock is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._clock is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            self._clock._count("reads", self.n)
            self._clock._count("read_ms", ms)
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def host_read(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy, one counted read (``host_sync``)."""
    with host_sync():
        return t.cpu().numpy()


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype=dtype, device=device)`` for host data
    ``a``, one counted read (``host_sync``): a copy from pageable host
    memory waits for the device's stream as a read does."""
    with host_sync():
        return torch.as_tensor(a, dtype=dtype, device=device)


@contextlib.contextmanager
def counted_syncs_only():
    """For the block, every synchronisation of the card raises except
    inside ``host_sync`` (``host_read``, ``to_device``), which lifts the
    mode around its own (``torch.cuda.set_sync_debug_mode("error")``; process-wide,
    as that mode is).  Card only."""
    global _strict
    if _strict:
        raise RuntimeError("counted_syncs_only() is already active")
    torch.cuda.set_sync_debug_mode("error")
    _strict = True
    try:
        yield
    finally:
        _strict = False
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def unclocked():
    """Suspend this thread's stage clock for the block (the one-time
    warm-up and capture of a CUDA graph, which are no frame's time)."""
    clock = getattr(_active, "clock", None)
    _active.clock = None
    try:
        yield
    finally:
        _active.clock = clock


@contextlib.contextmanager
def stage_clock(device="cuda"):
    """Activate the stage clock on this thread for the block.  The block's
    scopes record events and nothing is read until the block ends, with one
    synchronise."""
    if getattr(_active, "clock", None) is not None:
        raise RuntimeError("a stage clock is already active on this thread")
    clock = StageClock(get_device(device))
    _active.clock = clock
    try:
        yield clock
    finally:
        _active.clock = None
        clock._finish()


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Capture a ``torch.profiler`` trace of the block (host activity
    always, device activity when ``device`` is a card) and leave it in
    ``log_dir`` as a gzipped Chrome trace, which ``trace_attribution`` reads
    back and ``chrome://tracing`` or Perfetto display.  Adds nothing
    outside the block; inside it every launch costs the host more."""
    from torch.profiler import ProfilerActivity, profile

    dev = get_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize(dev)
    n = len(glob.glob(os.path.join(log_dir, "*.trace.json.gz")))
    raw = os.path.join(log_dir, f"frames_{os.getpid()}_{n}.trace.json")
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb") as dst:
        for block in iter(lambda: src.read(1 << 20), b""):
            dst.write(block)
    os.remove(raw)


def time_jitted(fn: Callable, *args, iters: int = 20, warmup: int = 2,
                device="cuda", **kwargs) -> dict:
    """Time a callable, blocking on every call: CUDA events around one call
    on an idle device (the host clock on the CPU), so the call's host work
    and launch latency are inside the interval.  Returns {"mean_ms",
    "min_ms", "p50_ms", "iters"}; the first ``warmup`` calls are excluded.
    The name is the reference's."""
    dev = get_device(device)
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize(dev)
    samples = []
    for _ in range(iters):
        if dev.type == "cuda":
            a, b = _new_event(), _new_event()
            a.record()
            fn(*args, **kwargs)
            b.record()
            b.synchronize()
            samples.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            samples.append((time.perf_counter() - t0) * 1e3)
    arr = np.asarray(samples)
    return {"mean_ms": float(arr.mean()), "min_ms": float(arr.min()),
            "p50_ms": float(np.median(arr)), "iters": iters}


def time_amortized(fn: Callable, *args, iters: int = 20, warmup: int = 2,
                   device="cuda", **kwargs) -> dict:
    """Queue ``iters`` calls back to back and synchronise once.  Returns
    {"ms", "iters"}: host wall time per call, which is the device's time
    per call when the device is the slower side and the host's enqueue
    cost when it is not."""
    dev = get_device(device)
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _synchronize(dev)
    return {"ms": (time.perf_counter() - t0) / iters * 1e3, "iters": iters}


def time_queued(fn: Callable, *args, iters: int = 50, hold_ms: float = 0.0,
                device="cuda", **kwargs) -> float:
    """Device ms per call with the host's enqueue cost left out: events
    around ``iters`` calls queued while the device is held busy for
    ``hold_ms`` (by ``torch.cuda._sleep``), so the calls run back to back.
    Card only."""
    dev = get_device(device)
    if dev.type != "cuda":
        raise ValueError("time_queued needs a CUDA device")
    a, b = _new_event(), _new_event()
    torch.cuda.synchronize(dev)
    busy_wait(hold_ms)
    a.record()
    for _ in range(iters):
        fn(*args, **kwargs)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def busy_wait(ms: float) -> None:
    """Queue about ``ms`` of device work on the current stream, so what is
    queued next waits on the device and then runs back to back."""
    if ms > 0:
        torch.cuda._sleep(int(ms * 2.0e6))      # cycles, at up to 2 GHz


def _stage_of(path: List[str]) -> str:
    for name in reversed(path):
        if name in _STAGE_OF:
            return _STAGE_OF[name]
    return "frame_glue" if FRAME_SCOPE in path else "other"


def _rel(path: List[str]) -> str:
    """A scope path as reported: relative to the frame root."""
    if FRAME_SCOPE in path:
        path = path[path.index(FRAME_SCOPE):]
        return "/".join(path[1:]) or FRAME_SCOPE
    return "/".join(path)


class _ScopeIndex:
    """The host threads' ``user_annotation`` events, to look up the scope
    path that encloses a timestamp on a thread."""

    def __init__(self, events):
        self._by_thread = defaultdict(list)
        for ev in events:
            self._by_thread[(ev.get("pid"), ev.get("tid"))].append(
                (ev["ts"], ev["ts"] + ev.get("dur", 0), ev["name"]))
        for spans in self._by_thread.values():
            spans.sort(key=lambda s: (s[0], -s[1]))

    def paths(self, thread, stamps: List[float]) -> List[List[str]]:
        """The enclosing scope path at each of ``stamps`` (ascending)."""
        spans = self._by_thread.get(thread, [])
        out, stack, i = [], [], 0
        for ts in stamps:
            while i < len(spans) and spans[i][0] <= ts:
                while stack and stack[-1][1] <= spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] <= ts:
                stack.pop()
            out.append([s[2] for s in stack])
        return out


def trace_attribution(log_dir: str, reps: int) -> dict:
    """Parse the traces ``device_trace`` left in ``log_dir`` into device
    time per frame by stage (``reps`` frames were traced).

    Every device event (kernel, memcpy, memset) is attributed to the
    innermost scope that encloses the host call which launched it; the
    trace links the two by correlation id, so a kernel queued in ``fit``
    that runs while the host is already in ``sync`` still counts for
    ``fit``.  A trace with no device events (taken on the CPU) attributes
    its leaf CPU operators in the same way, by their own start.

    Returns ``total_ms`` (busy ms per frame), ``launches`` (events per
    frame), ``stages`` with the reference's keys (``bgsub``; ``walk`` for
    scope ``forest_walk``; ``blob_cc`` for ``blob_suppress``; ``fit`` for
    ``fit`` and ``refine``; ``frame_glue`` for the rest of a frame;
    ``other``), and ``scopes``: every scope path relative to the frame root
    with ``ms`` and ``launches`` per frame, children included.
    """
    reps = max(reps, 1)
    stage_ms = dict.fromkeys(STAGES, 0.0)
    scope_ms = defaultdict(float)
    scope_n = defaultdict(int)
    total, count, on_device = 0.0, 0, False

    for path in sorted(glob.glob(os.path.join(log_dir, "**",
                                              "*.trace.json.gz"),
                                 recursive=True)):
        with gzip.open(path, "rt") as fh:
            events = [ev for ev in json.load(fh).get("traceEvents", [])
                      if ev.get("ph") == "X"]
        index = _ScopeIndex([ev for ev in events
                             if ev.get("cat") == "user_annotation"])
        device_events = [ev for ev in events if ev.get("cat") in (
            "kernel", "gpu_memcpy", "gpu_memset")]
        # (thread, host timestamp, duration) of what is attributed
        work = []
        if device_events:
            on_device = True
            calls = {}
            for ev in events:
                if ev.get("cat") in ("cuda_runtime", "cuda_driver"):
                    corr = (ev.get("args") or {}).get("correlation")
                    if corr is not None:
                        calls[corr] = ev
            for ev in device_events:
                call = calls.get((ev.get("args") or {}).get("correlation"))
                thread = (call.get("pid"), call.get("tid")) if call else None
                work.append((thread, call["ts"] if call else 0.0,
                             ev.get("dur", 0)))
        else:
            ops = defaultdict(list)
            for ev in events:
                if ev.get("cat") == "cpu_op":
                    ops[(ev.get("pid"), ev.get("tid"))].append(ev)
            for thread, lane in ops.items():
                lane.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
                for i, ev in enumerate(lane):
                    end = ev["ts"] + ev.get("dur", 0)
                    if not (i + 1 < len(lane) and lane[i + 1]["ts"] < end):
                        work.append((thread, ev["ts"], ev.get("dur", 0)))
        by_thread = defaultdict(list)
        for thread, ts, dur in work:
            by_thread[thread].append((ts, dur))
        for thread, items in by_thread.items():
            items.sort()
            paths = index.paths(thread, [ts for ts, _ in items])
            for (_, dur), scopes in zip(items, paths):
                ms = dur / 1e3
                total += ms
                count += 1
                stage_ms[_stage_of(scopes)] += ms
                lo = scopes.index(FRAME_SCOPE) if FRAME_SCOPE in scopes else 0
                for depth in range(lo + 1, len(scopes) + 1):
                    key = _rel(scopes[:depth])
                    scope_ms[key] += ms
                    scope_n[key] += 1

    stages = {k: round(v / reps, 3) for k, v in sorted(
        stage_ms.items(), key=lambda x: -x[1])}
    return {
        "total_ms": round(total / reps, 3),
        "launches": round(count / reps, 1),
        "on_device": on_device,
        "stages": stages,
        "scopes": {k: {"ms": round(scope_ms[k] / reps, 3),
                       "launches": round(scope_n[k] / reps, 1)}
                   for k in sorted(scope_ms)},
    }
