"""One run of one cell: set-up, the measured window, the traced extras
(``--trace 1``), and the comparison that decides ``correct``.

Set-up runs from process start to the first measured frame: the NN
kernel's build (cached in ``avatar_tpu_torch/_build/`` inside the
checkout), the scene (model, person, motion, frames rendered on the
device), the tracker (model tensors, forests, fit contexts), its
``warmup`` where it has one, and ``prime_frames`` frames of the mix, which
run every shape the window uses.  The window is a closed loop: the next
frame is handed over when the previous result is on the host.
"""

from __future__ import annotations

import gc
import time
from typing import List, Optional

import numpy as np
import torch

from harness import check, probe, spec
from harness.scene import make_scene
from harness.trackers import build_program, build_reference


class TraceRun:
    """What a per-layer metric's reader reads (``metrics/<name>.py``):
    ``frames``, the window's frame records (``kind`` is ``steady``,
    ``reinit``, ``lost`` or ``empty``; ``wall_s``; ``stages``, the stage
    clock's {scope path: {elapsed_ms, entries, ...}}; ``searches``; and
    ``fits``, one {P, J, K, D, N, pairs} per fit); ``trace``, the reduced
    device trace of the sub-window (``probe.parse_trace``, with
    ``frames``, the index into the scene's frames of each traced frame)
    or None;
    ``nn``, {device_ms, bound_ms, bound_by} of the steady fit's search or
    None; and ``cell``."""

    def __init__(self, frames, trace, nn, cell):
        self.frames = frames
        self.trace = trace
        self.nn = nn
        self.cell = cell


def _kind(rec: dict) -> str:
    out = rec["out"]
    if not rec["body"]:
        return "empty"
    if not out.ok:
        return "lost"
    return "reinit" if out.reinitialized else "steady"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(runner, scene, k0: int, seconds: float, dev,
            fit_probe: Optional[probe.FitProbe]):
    """Track frames from slot ``k0`` until ``seconds`` have passed; the
    records and the window's length."""
    records: List[dict] = []
    state = runner.state()
    k = k0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        slot = scene.slot(k)
        frame = scene.frames[slot.frame]
        rec = dict(k=k, frame=slot.frame, body=slot.body,
                   segment_start=slot.segment_start, state_before=state)
        if fit_probe is None:
            t0 = time.perf_counter()
            out = runner.feed(frame)
            rec["wall_s"] = time.perf_counter() - t0
        else:
            from avatar_tpu_torch.profiling import stage_clock
            n0 = probe.searches()
            with stage_clock(dev) as clock:
                t0 = time.perf_counter()
                out = runner.feed(frame)
                rec["wall_s"] = time.perf_counter() - t0
            rec["stages"] = clock.stages
            rec["searches"] = probe.searches() - n0
            rec["fits"] = fit_probe.take()
        rec["out"] = out
        rec["kind"] = _kind(rec)
        state = runner.state()
        records.append(rec)
        k += 1
    return records, time.perf_counter() - t_start, k


def _trace_slots(scene, k: int, traffic: dict) -> List[int]:
    """The sub-window the profiler traces: ``trace_frames`` slots from
    ``k`` on, and more until ``trace_min_reinit`` segment starts are in."""
    out, starts = [], 0
    while len(out) < traffic["trace_frames"] or \
            starts < traffic["trace_min_reinit"]:
        starts += scene.slot(k).segment_start
        out.append(k)
        k += 1
    return out


def _nn_reading(records: List[dict], runner, dev) -> Optional[dict]:
    """Device ms and least ms of the last steady fit's search."""
    from roofline import search_bound_ms
    steady = [r for r in records if r["kind"] == "steady"
              and r["fits"] and r["fits"][-1]["match"] is not None]
    if not steady or dev.type != "cuda":
        return None
    rec = steady[-1]
    fit = rec["fits"][-1]
    m = fit["match"]
    cloud = torch.as_tensor(rec["out"].verts, dtype=torch.float32,
                            device=dev)
    wild = runner.tracker.num_parts if runner.kind == "fused" else -1000
    dev_ms = probe.search_device_ms(m, cloud, wild)
    bound_ms, by = search_bound_ms(m.n, m.pp, m.n // m.tile_n, fit["pairs"])
    return dict(device_ms=dev_ms, bound_ms=bound_ms, bound_by=by,
                rows=m.n, slots=m.pp, pairs=fit["pairs"])


def set_up(cell: spec.Cell, seed: int, dev):
    """The scene, the program's tracker warmed and primed, and the slot of
    the first measured frame."""
    cfg = cell.config
    if dev.type == "cuda":
        from avatar_tpu_torch.optim import nn_kernel
        nn_kernel.build()
    scene = make_scene(cfg, cell.traffic, seed, dev, cell.bench_dir)
    runner = build_program(cfg, scene, dev)
    first_body = next(s.frame for s in scene.schedule if s.body)
    runner.warmup(scene.frames[first_body])
    for k in range(cfg["prime_frames"]):
        runner.feed(scene.frames[scene.slot(k).frame])
    _sync(dev)
    return scene, runner, cfg["prime_frames"]


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, tmp_root: str) -> dict:
    """One run; returns the result line's fields, ``checks`` last."""
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    scene, runner, k = set_up(cell, seed, dev)
    # what set-up made stays out of the collector's sweeps in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    fit_probe = None
    if trace:
        fit_probe = probe.FitProbe()
        fit_probe.install()
    try:
        records, window_s, k = window(runner, scene, k, seconds, dev,
                                       fit_probe)
    finally:
        if fit_probe is not None:
            fit_probe.uninstall()
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    body = [r for r in records if r["body"]]
    tracked = [r for r in body if r["out"].ok]
    errs = [np.mean(np.linalg.norm(r["out"].joints -
                                   scene.gt_joints[r["frame"]], axis=1))
            for r in tracked]
    e2e = dict(
        frames_per_s=len(records) / window_s,
        frame_ms_p95=(float(np.percentile([r["wall_s"] for r in body], 95))
                      * 1e3 if body else None),
        joint_err_mm=float(np.mean(errs)) * 1e3 if errs else None,
        setup_s=setup_s)

    result = dict(correct=False, attempted=len(body),
                  failed=len(body) - len(tracked))
    device_info = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        count=1, memory_peak_bytes=int(peak))
    if trace:
        for r in records:
            for f in r["fits"]:
                f["pairs"] = (probe.pairs_of(f["match"]) if f["match"]
                              is not None else 0)
        nn = _nn_reading(records, runner, dev)
        for r in records:
            for f in r["fits"]:
                f["match"] = None
        slots = _trace_slots(scene, k, traffic)
        reduced = probe.traced_frames(
            runner, [scene.frames[scene.slot(i).frame] for i in slots],
            dev, tmp_root)
        if reduced is not None:
            reduced["frames"] = [scene.slot(i).frame for i in slots]
        run = TraceRun(records, reduced, nn, cell)
        result["metrics"] = spec.read_metrics(cell.per_layer, run,
                                               cell.bench_dir)
        if reduced is not None:
            device_info.update(busy_s=reduced["busy_s"],
                               window_s=reduced["window_s"])
            result["breakdown"] = dict(device_ops=reduced["device_ops"],
                                       idle_gaps=reduced["idle_gaps"])
    else:
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    result["device"] = device_info

    # the program's state is freed before the reference runs
    del runner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    picks = check.pick_frames(records, seed, traffic["check_frames"],
                              traffic["check_reinit"])
    reference = build_reference(cfg, scene, dev)
    numbers = check.numbers(check.frame_gaps(records, picks, scene,
                                             reference))
    numbers.update(check.window_numbers(records))
    result["compared_frames"] = len(picks)
    result["correct"], result["checks"] = check.judge(numbers, cell.limits)
    return result
