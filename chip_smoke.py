#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; imports nothing of JAX.  Phases, one line
each (any failure exits non-zero and prints no result):

1. device — the card's name and power limit from nvidia-smi;
2. build — compiles the hand-written kernels (avatar_tpu_torch/csrc/
   nn_argmin.cu, forest_walk.cu, cc_label.cu) from the checkout;
3. kernel — the kernel against its plain PyTorch version at the fit's
   shapes (N = 8192 steady state and 32768 reinit rows, 6656 model slots,
   14 groups, wildcards and padding): indices equal, d2 within rtol 1e-6,
   ranged (B1, the fit's) and full-range (B2), and B2 at the unplanned
   ``find_nn_stats``'s shape (8192 unsorted rows, 7168 slots with pad part
   -2, chunk 1024), beside each launch's bound (the larger of its bytes
   over HBM bandwidth and its scanned pairs' FP32 operations over the FP32
   peak).  Three times per case: ``device_ms``, CUDA events around 50
   launches queued behind a busy device, so the host's enqueue cost is not
   in it (median of 7 runs; the clouds stay warm in L2, as the fit finds
   them); ``host_us``, the host clock around 50 wrapper calls with no
   synchronise: the enqueue cost per call; ``call_ms``, events around one
   call on an idle device (median of 20), which holds both.  The fused
   entry (``find_nn_stats_planned``) is timed the same way;
3b. walk — the forest walk's kernel (``perception/walk_kernel.py``)
   against its plain version (``rtree.walk_pixels_plain``, the eager level
   loop) on frame 1 of the fixture, background removed, at the three
   shapes its callers give it: tree 0 of the stacked r5 forest over the
   fused tracker's 3,072-pixel bucket of its 192x149 window, trees [1, 3)
   over 1,024 of those pixels in one launch, and the demo forest over the
   host tracker's 640x360 grid (stride 2) inside a body ROI.  Leaf ids
   equal to the bit; ``device_ms``, ``host_us`` and ``call_ms`` as in
   phase 3, the plain version's ms, and the bound: the levels the walks
   visit (32 node bytes and two 4-byte probes each), the pixels read and
   the ids written, over HBM bandwidth;
3c. cc — the connected-components kernel (``perception/cc_kernel.py``)
   against its plain version (``cc.connected_components_plain``, the eager
   sweep loop) on the four calls of the main path, as a steady frame (fixture
   frame 1) gives them: the fused tracker's ``bgsub`` (60x107, distance
   gate) and ``blob_suppress`` (the part grid of its tracked window at
   half the forest's resolution, a strided view: 96x75), the host
   tracker's at ``demo``'s strides (360x640 each).  Labels and sizes
   equal to the bit; the loop's sweeps; ``device_ms``, ``host_us`` and
   ``call_ms`` as in phase 3, the plain version's ms, and the bound: the
   mask and values read once and the labels written once, over HBM
   bandwidth;
4. slice — ``FusedTracker.track`` at 1280x720 with the bench's config, the
   3-tree r5 forest and background subtraction, on the 6 frames of
   tests/fixtures/torch_port_720p.npz (one reinit, then steady state).
   Free-running, as a user runs it: every frame ok, the kernel launched,
   the pose finite and still tracking (within 40 mm of ground truth); wall
   ms per frame.  Then frame by frame from the JAX reference's state before
   each frame (stored in the fixture): joints within 5 mm of the
   reference's and no more than 2 mm further from ground truth.  The
   free-running poses are reported against the reference but not bounded
   by it: two float32 implementations of the LM fit part ways at a near-tie
   of an accept/stop decision in the reinit fit (~2-5 mm), and the
   sequence amplifies that difference (see PERF.md).  The kernel is held
   against its plain version on the inputs of every launch of the synced
   run (indices equal, d2 within rtol 1e-6).
4b. batch — the batch and async modes of ``FusedTracker`` at phase 4's
   configuration, each from the state after ``track`` on frame 0.  (a)
   ``track_batch`` over frames 1-5, the main path: every result ok, one
   pose per result, each within 40 mm of ground truth (reported beside the
   reference's joints, unbounded); B1 held against its plain version on
   every launch.  (b) ``_fused_frame_impl`` frame by frame with the
   batch's arguments: thetas, host_diag and the last com_pre equal to
   (a)'s, to the bit.  (c) ``track_batch_async`` over [1, 2] [3, 4] [5],
   then ``flush_batches``: pairs per call [0, 1, 1, 1], poses equal to
   (a)'s to the bit.  (d) ``track_async`` over frames 1-5, then ``flush``:
   ``pipeline_depth`` Nones, then the results of ``track``'s chain that
   many calls late, and the flush frame's; where no limb recovery fired,
   the poses equal the chain's to the bit.  (e) ``warmup(frame,
   batch=16)`` leaves the state as it was; 16 frames ping-ponged over the
   fixture (bench.py's batch width) as one batch and through ``track``.
   Frames per second of each mode.
4c. graph — the LM loop as it runs on the card: each step of ``fit`` and
   ``fit_refine`` a replay of one of two captured CUDA graphs, the host
   reading (accept, stop) once after it.  On five paths (the fused
   tracker's reinit frame and two steady frames, the accuracy mode's
   refine frames, the host tracker's frames, a ``track_batch`` of 16) a
   tracker with graphed fits and one whose fits run uncaptured go through
   the same frames from the same state: every fit equal to the bit
   (theta, cost, matches, accepted steps, last correspondences, part
   counts), the poses equal, the same kernel launches (a replay counts the
   searches it launches; a capture inside the run adds its one uncaptured
   run of each step), every search of the eager run equal to its plain
   version.  One eager step of the steady fit passes under
   ``set_sync_debug_mode("error")``.  Prints each path's fit and frame
   wall ms uncaptured ("before") and graphed ("after").
5. render — the 6 ground-truth poses of tests/fixtures/
   torch_port_720p_refine.npz through ``Avatar.update`` and
   ``AvatarRenderer`` on the card: the uint16-mm scene against the
   tracking fixture's ``depth``, and frame 0's part mask against
   ``part_mask0``.  At most 0.1% of body pixels differ, each on an edge
   (the body's outline, an occlusion edge or, for the mask, a part
   boundary); no interior depth pixel differs by more than 1 mm.
   CUDA-event ms per ``render_frame`` at 1280x720.
6. refine probe — bench.py's fit_rmse_mm probe: ``fit_refine``, 20 steps
   from the ground truth with both priors at 1e-4, on frame 0's
   oracle-labelled stride-6 samples.  fit_rmse_mm < 1 mm and within
   0.2 mm of the reference's (stored in the fixture); the kernel launched,
   and held against its plain version on the inputs of every launch
   (N = 1024 padded samples over the unsorted model plan); ms per LM step.
7. accuracy mode — ``FusedTracker`` with ``refine_every=1,
   refine_steps=2`` on the 6 frames, free-running (ok, finite, within
   40 mm of ground truth, wall ms per frame) and frame by frame from the
   reference's accuracy-mode state (the bounds of phase 4, and 1.5 mm on
   the frames that ran the refine).  A control tracks the same synced
   frames with no refine and must land outside the 1.5 mm bound.
8. host tracker — ``tracking.Tracker`` (bgsub, ``RTree.predict_best`` /
   ``post_process`` with the r5 forest, ``AvatarOptimizer``) on the 6
   frames as XYZ maps (``CameraIntrin.depth_to_xyz_np``).  Free-running:
   every frame ok and finite, GT error beside the reference's (the JAX
   ``Tracker`` in tests/fixtures/torch_port_720p_host.npz) and within 40
   mm of ground truth or, where the reference itself is further, within
   its worst frame + 10 mm; a control (the unfitted reinit pose) must miss
   that bound; wall ms per frame.  Synced, frame by frame from the
   reference's state: steady frames within 5 mm of the reference's joints,
   and a control with the fit a no-op must miss that bound; the reinit
   frame within the free-running bound, and its fit cut to the first 8 LM
   steps within 5 mm of the reference's (past them that cold-start fit is
   ill-conditioned, see PERF.md).  B1 held against its plain version on
   every launch.
9. library NN — frame 0's unpadded samples (the optimizer's input in the
   synced run) against the model posed at the reference's pose after it:
   ``find_nn_stats`` (B2) gives the same corr, mapped to data order, and
   n_matched as ``find_nn_stats_planned`` over the bucketed plan (B1);
   ``fit`` on the unpadded samples (N % 256 != 0) launches B2 and lands
   within 0.5 mm (joints) of the bucketed fit, which must move further
   than that from its start.  B2 held against its plain version on every
   launch.

10. training — the forest trainer on the card, by the bench forest's
   recipe (``scripts/train_bench_forest_torch.py``, which a user runs too):
   the detail-6 model, 14 part groups, the 1280x720 camera at train stride
   3 (240 x 427 frames), 2000 points per image, 512 features filtered to
   64 per node, 16 buckets, min_samples 48, balance 0.5, image batch 72.
   Only the scale is cut: 1024 images and depth 10 (the committed forests
   used 8-16k images at depth 17-18).  It runs no hand-written kernel.
   Fails unless (a) training finishes with the frame cache and the
   samples on the card; (b) children are in range and every leaf sums to
   1 within 1e-5; (c) the exported ``.srtr`` reads back equal; (d)
   per-pixel accuracy at stride 3 on 16 fresh 1280x720 frames clears
   ``TRAIN_ACCURACY`` (printed beside the committed
   ``data/bench_forest_g14c.srtr`` on the same frames), and a control, the
   tree cut to its root's leaf, misses it; (e) at 16 images, depth 6 and
   24 features the flat and the batch pass modes grow one tree; (f) from
   one in-memory frame source the card grows the CPU's tree; (g)
   ``train_transfer`` on 8 fresh frames changes leaves that still sum to
   1.  Prints frames rendered per second, the parts of one frame (pose
   draws, ``lbs``, ``render_frame`` alone, ``render_frames`` per image
   batch), per-level wall time and device
   time by pass (CUDA events around every pass of a second, instrumented
   run, which must grow the same tree), probe evaluations per second, the
   frame cache's bytes and the count scatter's device time with
   deterministic algorithms on and off.
10b. tools — the camera-to-tracker entry points as a user runs them, at
   1280x720 (K4A intrinsics), with the detail-6 model and the r5 forests.
   The native library is built (``native.build.build()``) and must be what
   serves: its RLE bytes equal the numpy codec's on the 6 frames, and
   ``connected_components_host`` equals ``perception.cc`` on the card,
   label for label, on frame 0's bgsub mask.  The 6 frames and a
   background frame 9999 go through ``DatasetWriter`` as ``.depth`` RLE
   (also where OpenCV could write EXR) and read back equal
   (``Dataset.xyz`` ms, native and numpy).
   ``demo.main``, host and ``--fused``, with ``--part-groups`` and
   ``--metrics``: per frame ok, n_points, reinit and joints equal to the
   bit to the same tracker class built with the same config and driven
   directly over the same arrays (wall ms per steady frame of both, joint
   error to GT).  ``rtree_run_dataset`` with the three trees and
   ``rtree_run`` on one frame equal ``RTree.predict`` / ``predict_best`` +
   ``post_process``.  ``live_demo`` twice, each under a wall-clock limit:
   the synthetic camera rendering on the card in its capture thread
   (oracle labels), and a recording with the forest, ``--fused`` and
   ``--capture-bg-after 1``: frames tracked, ok, per second, and the
   camera thread's share.  ``SyntheticCamera.next_frame`` ms at 360x640
   and 720p.  ``data_recording`` and ``smplsynth`` run only where OpenCV
   is installed.  Then the model tools at the card's defaults:
   ``optim_tool --synthetic-model 6`` at 512x512 (vertex RMSE must fall;
   printed beside the reference test's 80 mm bar, with its wall time and
   B1 launches), ``smpltrim`` (the trimmed model loads and poses on the
   card), ``smpl_viewer`` in each ``--mode``, ``face_landmark_tracking``
   over the recording (a line per frame); ``scratch`` and ``smpl_viewer
   --interactive`` only where matplotlib imports (a skip is printed).
   Every B1 launch of the tools, and of ``optim_tool`` apart, is held
   against the plain version to the bit.
10c. mesh — the multi-device layer over a world of one (NCCL: the machine
   has one card, and NCCL puts no two ranks on one GPU).  (a)
   ``ForestTrainer(mesh=make_mesh(1))`` by phase 10's recipe at its widths
   and scale grows, node for node, the tree of batch mode without a mesh:
   both wall times, per-level wall times and the all-reduces' and
   all-gathers' device ms per level.  (b) ``rtree_train --devices 1``
   writes the bytes of ``--devices 0`` (1280x720, 32 images, depth 6);
   ``--devices 2`` exits naming the one visible card.  (c)
   ``sharded_track_step`` with a stream per fixture frame 1 and 2 from
   the reference's state (1280x720, the bench's config, the 3-tree r5
   forest, bgsub): each stream's theta, labels and host_diag equal
   ``_fused_frame_impl`` called directly on it, to the bit, its joints
   within 5 mm of the reference's synced frame; ms per stream beside
   ``FusedTracker.track``'s.  Its B1 launches are held against the plain
   version.  (d) ``sharded_multistream_lbs`` equals ``lbs_batched`` to the
   bit.
11. stages — where a tracked frame's time goes.  The fused tracker as a
   user drives it (``set_background``, ``warmup``, ``open_metrics``,
   ``track`` over the 6 frames, ``close_metrics``), the accuracy mode and
   the host tracker, each frame under ``profiling.stage_clock``.  One JSON
   line per path (a fused reinit frame; fused steady, accuracy-mode and
   host-tracker frames as medians over the 5 steady frames): per scope the
   clock's elapsed ms on the device timeline (idle gaps included), the
   host's wall ms, the entries and the synchronising copies and reads
   counted there (the clock's ``reads``: ``profiling.host_read`` /
   ``host_sync``); the frames' wall ms with its spread.  Each path's
   tracker then runs a reinit and a steady frame again in a pass of its
   own with PyTorch's sync reports on (``set_sync_debug_mode("warn")``).
   Fails unless: each of those frames' ``reads`` equal the
   synchronisations PyTorch reports for it, and a steady frame's in
   ``bgsub`` and ``blob_suppress`` equal ``CARD_CC_READS`` (no sweep
   flag, no ``bincount``; one connected-components launch in each); the
   clocked frames equal an unclocked tracker's to the
   bit (theta, labels, diag); the warmed tracker's frames equal a cold
   one's and its state after ``warmup``, and after ``warmup(batch=2)``,
   equals its state before; the metrics log has one line per tracked
   frame with the reference's keys and none from ``warmup``; the scopes
   directly below a frame sum to within 10% of the frame's own
   event-to-event ms; every stage and LM-step scope shows; B1 was
   launched, and equals its plain version on every recorded search.  Then
   a process's first ``track`` cold (a child process that builds the
   kernels inside that call) against warmed (a child that calls ``warmup``
   first): wall ms each, and the same pose to the bit.  Last, the fused
   and host paths graphed once more with every walk through the plain
   eager version (the walk before its kernel): ``forest_walk`` ms and the
   kernel's ``walk_launches`` per steady frame before and after (two a
   fused frame, one a host frame, after).
12. profile — ``torch.profiler``, last because a process that has run it
   pays more for every launch after it.  The planned search of phase 3:
   device launches per search and each kernel's own device time.  Then
   ``profiling.device_trace`` around a reinit frame and a few steady frames
   of each path of phase 11, read back by ``profiling.trace_attribution``:
   one JSON line per path with the device's busy ms and launches per frame
   by stage and by scope, and busy ms over the clock's elapsed ms, the
   share of each scope in which the card worked.  Fails unless the trace
   holds device events, every scope of phase 11 shows in it, the stages
   sum to ``total_ms`` and ``total_ms`` is not above the traced frames'
   wall ms; the graphed fused and host paths with plain walks too, for
   the walk's launches per steady frame before and after its kernel.
   Phases 11 and 12 run each path with its LM steps uncaptured
   (the per-part view of a step, ``lm_steps`` "eager") and the fused
   reinit and steady and the host paths again graphed (``fit/step`` is a
   replay; "graphed").

Graphed and eager runs.  Every tracker's fit on the card replays its LM
steps as CUDA graphs, as a user runs it, unless
``gauss_newton.eager_steps()`` is active: only the eager half of 4c and
the "eager" lines of phases 11 and 12 (the per-part view of a step) turn
it on.  A fit called directly with no ``programs`` (phases 6 and 9) runs
its steps uncaptured, as it would for a user.  Graphed and eager fits
equal each other to the bit, so the phases that compare one with the
other hold that too.

The kernel counts are reset before each main path (phases 4, 4b, 4c, 6,
7, 8, 9, each tool run of 10b, the sharded track step of 10c, and 11's
graphed fused run) and read after it.  The paths search through the
fused entry (``nn_kernel.nn_match``).  Every search of a recorded run is
held against the plain version on its inputs: a search called from
Python is recorded at the call; a search inside a replayed graph after
the replay, from the program's buffers (the iterate it started from, the
visibility and the correspondences it wrote).  The path's own
correspondences must equal the plain version's, and the search run again
through the fused and the raw entry too: indices equal and d2 equal to
the last bit.  The line before the last is the kernels'
JSON record (``ms`` is ``device_ms``); the last line is ``{"ok": true,
"device": {...}}``.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# cuBLAS needs a fixed workspace for deterministic results; set before
# torch initializes CUDA
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_720p.npz")
REFINE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                              "torch_port_720p_refine.npz")
HOST_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                            "torch_port_720p_host.npz")
FORESTS = [os.path.join(ROOT, "data", f"bench_forest_r5{s}.srtr")
           for s in ("", "_1", "_2")]
GROUP_FOREST = os.path.join(ROOT, "data", "bench_forest_g14c.srtr")
H, W = 720, 1280
# bench.py's tracker config (cfg_kw), which the fixture was tracked with
BENCH_CFG = dict(data_interval=6, min_points=1000, frame_icp_iters=2,
                 reinit_icp_iters=6, initial_icp_iters=7, iters_per_icp=4,
                 label_conf_thresh=0.55, rtree_interval=3)
RTOL = 1e-6              # kernel vs plain d2
REF_MM = 5.0             # port vs JAX reference joints, per synced frame
REFINE_REF_MM = 1.5      # the same, on synced frames that ran the refine
GT_SLACK_MM = 2.0        # port's GT error over the reference's, synced
TRACKING_MM = 40.0       # free-running GT error: still tracking
RENDER_FRAC = 1e-3       # differing pixels, as a share of body pixels
RENDER_INTERIOR_MM = 1   # largest depth difference off the edges
PROBE_MM = 1.0           # fit_rmse_mm bound (bench.py's gate)
PROBE_REF_MM = 0.2       # |port - reference| fit_rmse_mm
HOST_SLACK_MM = 10.0     # free-running host tracker over a reference > 40 mm
LIBRARY_FIT_MM = 0.5     # unpadded (B2) fit vs bucketed (B1) fit, joints
TRAIN_IMAGES = 1024      # phase 10's scale: the recipe's widths, cut in
TRAIN_DEPTH = 10         # images and depth only
TRAIN_ACCURACY = 0.6     # held-out per-pixel accuracy, group space, stride 3
                         # (first run: 0.6681; the majority group: 0.3090)
# the card's peaks for the bound (NVIDIA H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_PAIR = 9         # 3 sub, 3 mul, 2 add, 1 compare per scanned pair


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_device():
    import torch

    from avatar_tpu_torch.device import get_device

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return get_device("cuda:0")


def phase_build():
    from avatar_tpu_torch.optim import nn_kernel
    from avatar_tpu_torch.perception import cc_kernel, walk_kernel

    for src, build in (("nn_argmin.cu", nn_kernel.build),
                       ("forest_walk.cu", walk_kernel.build),
                       ("cc_label.cu", cc_kernel.build)):
        t0 = time.perf_counter()
        log = build()
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {src} built in {time.perf_counter() - t0:.2f} s; "
              + " | ".join(ptxas), flush=True)


def _time_ms(fn, reps: int = 20) -> float:
    """CUDA events around ONE call on an idle device, median of ``reps``:
    the call's host work and launch latency are inside the interval."""
    from avatar_tpu_torch import profiling

    return profiling.time_jitted(fn, iters=reps, warmup=1)["p50_ms"]


def _device_ms(fn, dev, n: int = 50, runs: int = 7) -> float:
    """Device time per call: events around ``n`` calls queued while the
    device is busy (for twice the time the host took to queue them in the
    warm-up), over ``n``; median of ``runs``."""
    import torch

    from avatar_tpu_torch import profiling

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    hold_ms = (time.perf_counter() - t0) * 2e3 + 1.0
    return float(np.median([profiling.time_queued(
        fn, iters=n, hold_ms=hold_ms, device=dev) for _ in range(runs)]))


def _host_us(fn, n: int = 50, runs: int = 7) -> float:
    """Host time per call: the host clock around ``n`` calls on an empty
    queue, with no synchronise inside, over ``n``; median of ``runs``."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def _profiled(fn, n: int = 20):
    """``torch.profiler``'s view of ``n`` calls: {kernel name: (launches
    per call, device us per launch)}, empty where the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0))
        on_device = "cuda" in str(getattr(ev, "device_type", "")).lower()
        if on_device and total > 0:
            out[ev.key] = (ev.count / n, total / ev.count)
    return out


def _compare(name, got, ref, n_rows):
    import torch

    (d, i), (rd, ri) = got, ref
    torch.cuda.synchronize()
    if not torch.equal(i, ri):
        fail(f"{name} N={n_rows}: {int((i != ri).sum())} indices differ "
             "from the plain version")
    ok = ri >= 0
    err = (d - rd).abs()
    rel = float((err[ok] / rd[ok].abs().clamp(min=1e-30)).max()) if ok.any() \
        else 0.0
    if rel > RTOL or not torch.equal(d[~ok], rd[~ok]):
        fail(f"{name} N={n_rows}: d2 relative error {rel:.3g} > {RTOL}")
    return float(err[ok].max()) if ok.any() else 0.0, rel


def phase_kernel(dev):
    import torch

    from avatar_tpu_torch.optim import correspond, nn_kernel
    from avatar_tpu_torch.perception.partgroups import SMPL24_NUM_GROUPS
    from avatar_tpu_torch.testing import (synthetic_nn_inputs,
                                          synthetic_nn_stats_inputs)

    wild = SMPL24_NUM_GROUPS
    rec = {}
    cases = []
    for n_rows in (8192, 32768):
        args = synthetic_nn_inputs(n_rows, seed=n_rows, device=dev)
        # B2 (full range) at chunk 512 on the planned layout: 6656 slots
        # are not a multiple of 1024, and the tie rule makes the result
        # independent of the chunk
        cases += [("nn_argmin_ranges", n_rows, args, dict(chunk=512)),
                  ("nn_argmin", n_rows, args[:5], dict(chunk=512))]
    # B2 as find_nn_stats launches it: unsorted, 7168 slots, chunk 1024
    data, dpart, verts, part, visible = synthetic_nn_stats_inputs(
        8192, device=dev)
    center = verts.mean(0)
    unplanned = correspond.unplanned_match(data, dpart, part)
    cases.append(("nn_argmin", "8192 unplanned",
                  nn_kernel.match_inputs(unplanned, verts, center,
                                         visible)[:5], dict(chunk=1024)))
    for name, n_rows, a, kw in cases:
        kw = dict(kw, wild=wild)
        fn = getattr(nn_kernel, name)
        ref_fn = getattr(nn_kernel, name + "_ref")
        got = fn(*a, **kw)
        ref = ref_fn(*a, **kw)
        max_abs, rel = _compare(name, got, ref, n_rows)
        device_ms = _device_ms(lambda: fn(*a, **kw), dev)
        host_us = _host_us(lambda: fn(*a, **kw))
        call_ms = _time_ms(lambda: fn(*a, **kw))
        plain_ms = _time_ms(lambda: ref_fn(*a, **kw))
        ranged = list(a) + [None, None][:7 - len(a)]
        bound_ms, bound_by = _bound(ranged, kw)
        matched = int((got[1] >= 0).sum())
        print(f"[kernel] {name} N={n_rows} Pp={a[2].shape[0]} chunk="
              f"{kw['chunk']}: indices equal ({matched} matched), d2 max abs "
              f"err {max_abs:.3g}, max rel {rel:.3g}; device_ms "
              f"{device_ms:.5f} (events around 50 queued launches, median "
              f"of 7), host_us {host_us:.2f} per call, call_ms {call_ms:.4f}"
              f" and plain {plain_ms:.4f} ms (events around one call, median"
              f" of 20); bound {bound_ms * 1e3:.3f} us by {bound_by} "
              f"({_pairs(ranged, kw)} scanned pairs)", flush=True)
        rec[(name, n_rows)] = dict(max_abs_err=max_abs, ms=device_ms,
                                   device_ms=device_ms, host_us=host_us,
                                   call_ms=call_ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)

    # the fused entry as the fit calls it: one planned search, model mean
    # included, over the unsorted model (mperm) with the wildcard gate
    plan = correspond.make_nn_plan(data, dpart, part, num_parts=wild)
    gate2 = torch.tensor(0.04, device=dev)
    search = lambda: correspond.find_nn_stats_planned(
        plan, verts, visible, wild=wild, wild_gate2=gate2)
    st = search()
    ref = nn_kernel.nn_match_ref(plan.match, verts, center, visible, wild,
                                 gate2)
    torch.cuda.synchronize()
    if not torch.equal(st.corr, ref[1]) or \
            float(st.n_matched) != float(ref[3]):
        fail("[kernel] find_nn_stats_planned differs from its plain version")
    device_ms, host_us = _device_ms(search, dev), _host_us(search)
    call_ms = _time_ms(search)
    print(f"[kernel] find_nn_stats_planned N=8192 (one host call into the "
          f"kernel): corr and n_matched ({int(st.n_matched)}) equal to the "
          f"plain version; device_ms {device_ms:.5f}, host_us {host_us:.2f},"
          f" call_ms {call_ms:.4f}", flush=True)
    return rec, search


def phase_profile(search):
    """``torch.profiler``'s count and device time of the kernels of one
    planned search.  Last of all phases: once the profiler has run in a
    process, every later launch costs the host more."""
    prof = _profiled(search)
    if not prof:
        print("[profile] torch.profiler recorded no device time here",
              flush=True)
        return
    print(f"[profile] find_nn_stats_planned N=8192: "
          f"{sum(c for c, _ in prof.values()):g} device launches per search;"
          " device us per launch: " + ", ".join(
              f"{k[:60]} x{c:g} {us:.2f}" for k, (c, us) in prof.items()),
          flush=True)


WALK_NODE_BYTES = 32     # leafid, u, v, thresh, lnode, rnode of one node
WALK_PIXEL_BYTES = 21    # ys, xs (int64), z (float32), fg (one byte)


def _walk_bytes(tree, leaf, trees) -> int:
    """Bytes one walk needs: per (tree, pixel) the internal nodes on its
    path (32 bytes and two 4-byte probes each) and its leaf's id, each
    pixel read once and each id written once."""
    stacked = trees is not None
    ids = leaf.reshape(leaf.shape[0] if stacked else 1, -1).cpu().numpy()
    n_bytes = ids.size * 4 + ids.shape[1] * WALK_PIXEL_BYTES
    for i, t in enumerate(range(*trees) if stacked else [None]):
        pick = (lambda a: a[t]) if stacked else (lambda a: a)
        lnode, rnode, leafid = (pick(a).cpu().numpy() for a in (
            tree.lnode, tree.rnode, tree.leafid))
        depth = np.zeros(leafid.shape[0], np.int64)
        stack = [0]
        while stack:                    # leaves self-loop: stop at them
            n = stack.pop()
            if leafid[n] < 0:
                for c in (lnode[n], rnode[n]):
                    depth[c] = depth[n] + 1
                    stack.append(c)
        leaf_node = np.zeros(int(leafid.max()) + 1, np.int64)
        leaf_node[leafid[leafid >= 0]] = np.nonzero(leafid >= 0)[0]
        got = ids[i][ids[i] >= 0]
        n_bytes += int(depth[leaf_node[got]].sum()) * (WALK_NODE_BYTES + 8)
        n_bytes += got.size * 4
    return n_bytes


@contextlib.contextmanager
def _plain_walks():
    """Every CUDA walk through the plain eager version: the walk as it ran
    before its kernel, for a reading before and after."""
    from avatar_tpu_torch.perception import rtree, walk_kernel

    real = walk_kernel.walk
    walk_kernel.walk = rtree.walk_pixels_plain
    try:
        yield
    finally:
        walk_kernel.walk = real


def phase_walk(scene):
    """The forest walk's kernel against its plain version at the fused
    bucket, the hard set and the host grid: leaf ids equal to the bit,
    times and bound.  Returns the records by case."""
    import torch

    from avatar_tpu_torch.perception import rtree, walk_kernel
    from avatar_tpu_torch.tracking_fused import _stack_trees

    dev = scene.dev
    d = scene.frames[1].astype(np.float32) * 1e-3
    depth = torch.as_tensor(np.where(d < scene.bg_m - 0.1, d, 0.0).astype(
        np.float32), device=dev)
    ss = BENCH_CFG["rtree_interval"]
    stacked = _stack_trees([t._tree for t in scene.trees], ss)
    max_depth = max(t._max_depth for t in scene.trees)
    # the fused tracker's window of the strided frame, centred on the body
    d_s = depth[::ss, ::ss]
    wh, ww = 576 // ss, 448 // ss
    by, bx = torch.nonzero(d_s > 0, as_tuple=True)
    oy = min(max(int(by.float().mean()) - wh // 2, 0), d_s.shape[0] - wh)
    ox = min(max(int(bx.float().mean()) - ww // 2, 0), d_s.shape[1] - ww)
    rflat = d_s[oy:oy + wh, ox:ox + ww].reshape(-1).contiguous()
    rfg = rflat > 0
    tie = torch.rand(rflat.shape[0], device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
    sel = torch.argsort(-(rfg.float() * 2.0 + tie), stable=True)[:3072]
    bucket = (sel // ww, sel % ww, rflat[sel], rfg[sel], rflat, (wh, ww),
              max_depth, (0, 0), (ww - 1, wh - 1))
    hard = torch.randperm(3072, device=dev, generator=torch.Generator(
        device=dev).manual_seed(4))[:1024]
    hard_set = tuple(a[hard] for a in bucket[:4]) + bucket[4:]
    # the host tracker's grid: forest_walk at stride 2 over the frame
    host = scene.trees[0]
    hy, hx = torch.nonzero(depth > 0, as_tuple=True)
    tl = (int(hx.min()) - 40, int(hy.min()) - 40)
    br = (int(hx.max()) + 40, int(hy.max()) + 40)
    gy = (torch.arange(H // 2, device=dev) * 2)[:, None].expand(
        H // 2, W // 2).contiguous()
    gx = (torch.arange(W // 2, device=dev) * 2)[None, :].expand(
        H // 2, W // 2).contiguous()
    z = depth[::2, ::2].contiguous()
    fg = (z > 0) & (gx >= tl[0]) & (gx <= br[0]) & (gy >= tl[1]) & \
        (gy <= br[1])
    grid = (gy, gx, z, fg, depth.reshape(-1), (H, W), host._max_depth, tl,
            br)
    rec = {}
    for name, tree, args, trees in (
            ("bucket", stacked, bucket, (0, 1)),
            ("hard", stacked, hard_set, (1, 3)),
            ("host_grid", host._tree, grid, None)):
        run = lambda: rtree.walk_pixels(tree, *args, trees=trees)
        plain = lambda: rtree.walk_pixels_plain(tree, *args, trees=trees)
        before = walk_kernel.LAUNCHES
        got, ref = run(), plain()
        torch.cuda.synchronize()
        if walk_kernel.LAUNCHES != before + 1:
            fail(f"[walk] {name}: the walk did not launch its kernel once")
        if not torch.equal(got, ref):
            fail(f"[walk] {name}: {int((got != ref).sum())} leaf ids differ "
                 "from the plain version")
        k = args[0].numel()
        n_bytes = _walk_bytes(tree, got, trees)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        device_ms = _device_ms(run, dev)
        host_us = _host_us(run)
        call_ms = _time_ms(run)
        plain_ms = _time_ms(plain)
        n_trees = 1 if trees is None else trees[1] - trees[0]
        print(f"[walk] {name}: {n_trees} tree(s) x {k} pixels "
              f"({int(args[3].sum())} foreground), max_depth {args[6]}: leaf "
              f"ids equal to the plain version; device_ms {device_ms:.5f}, "
              f"host_us {host_us:.2f}, call_ms {call_ms:.4f}, plain "
              f"{plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us by bytes "
              f"({n_bytes} bytes: levels visited, pixels, ids)", flush=True)
        rec[name] = dict(ms=device_ms, device_ms=device_ms, host_us=host_us,
                         call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="bytes", pixels=k,
                         trees=n_trees)
    return rec


@contextlib.contextmanager
def _cc_calls(calls: list):
    """Record each ``cc.connected_components`` call's arguments (the
    tensors themselves, views included)."""
    from avatar_tpu_torch.perception import cc

    real = cc.connected_components

    def recorded(active, edge_gate_fn=None, values=None, max_iters=64):
        calls.append((active, edge_gate_fn, values, max_iters))
        return real(active, edge_gate_fn, values, max_iters)

    cc.connected_components = recorded
    try:
        yield
    finally:
        cc.connected_components = real


def phase_cc(scene):
    """The connected-components kernel against its plain version at the
    four shapes of the main path, on the inputs a steady frame gives it:
    the fused tracker's ``bgsub`` (60x107, distance gate) and
    ``blob_suppress`` (120x214 part grid), and the host tracker's at
    ``demo``'s strides (360x640 each).  Labels and sizes equal to the bit;
    times, sweeps and bound.  Returns the records by case."""
    import torch

    from avatar_tpu_torch import profiling
    from avatar_tpu_torch.perception import cc, cc_kernel
    from avatar_tpu_torch.perception.rtree import RTree
    from avatar_tpu_torch.tracking import Tracker, TrackerConfig

    dev, frames = scene.dev, scene.frames
    fused = scene.tracker()
    rtree = RTree(FORESTS[0], device=dev)
    rtree.partmap_type = 0
    host = Tracker(scene.model, scene.intrin, (H, W), rtree=rtree,
                   config=TrackerConfig(**dict(BENCH_CFG, rtree_interval=2)))
    host.set_background(scene.intrin.depth_to_xyz_np(
        np.full((H, W), scene.bg_m, np.float32)))
    xyz = lambda f: scene.intrin.depth_to_xyz_np(f.astype(np.float32) * 1e-3)
    cases = {}
    for name, track, seq in (("fused", fused.track, frames[:2]),
                             ("host", host.track, [xyz(f) for f in
                                                   frames[:2]])):
        track(seq[0])
        calls = []
        with _cc_calls(calls):
            if not track(seq[1]).ok:
                fail(f"[cc] the {name} tracker lost frame 1")
        if len(calls) != 2:
            fail(f"[cc] a steady {name} frame labelled {len(calls)} times, "
                 "not twice")
        cases[f"{name}_bgsub"], cases[f"{name}_blob_suppress"] = calls
    torch.cuda.synchronize()
    rec = {}
    for name, (active, gate, values, max_iters) in cases.items():
        run = lambda: cc.connected_components(active, gate, values,
                                              max_iters)
        plain = lambda: cc.connected_components_plain(active, gate, values,
                                                      max_iters)
        before = cc_kernel.LAUNCHES
        got = run()
        with profiling.stage_clock(dev) as clock:
            ref = plain()
        torch.cuda.synchronize()
        if cc_kernel.LAUNCHES != before + 1:
            fail(f"[cc] {name}: the labelling did not launch its kernel once")
        if not torch.equal(got, ref):
            fail(f"[cc] {name}: {int((got != ref).sum())} labels differ "
                 "from the plain version")
        if not torch.equal(cc.component_sizes(got).cpu(),
                           cc.component_sizes(ref.cpu())):
            fail(f"[cc] {name}: component sizes differ from bincount's")
        # the plain loop reads its flag once before the sweeps, once after
        # each
        sweeps = sum(v["counts"].get("reads", 0)
                     for v in clock.stages.values()) - 1
        Hc, Wc = active.shape
        n = Hc * Wc
        n_bytes = n * (1 + 4 + (values.element_size() * values[0, 0].numel()
                                if values is not None else 0))
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        device_ms = _device_ms(run, dev)
        host_us = _host_us(run)
        call_ms = _time_ms(run)
        plain_ms = _time_ms(plain)
        gate_name = "distance" if gate is not None else "equal parts"
        n_comp = len(torch.unique(got[got >= 0]))
        print(f"[cc] {name}: {Hc}x{Wc} ({int((got >= 0).sum())} active, "
              f"{n_comp} components, {gate_name} gate, "
              f"{sweeps} sweeps): labels and sizes equal to the plain "
              f"version; device_ms {device_ms:.5f}, host_us {host_us:.2f}, "
              f"call_ms {call_ms:.4f}, plain {plain_ms:.3f} ms; bound "
              f"{bound_ms * 1e3:.3f} us by bytes ({n_bytes} bytes: mask, "
              f"values, labels)", flush=True)
        rec[name] = dict(ms=device_ms, device_ms=device_ms, host_us=host_us,
                         call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="bytes", pixels=n,
                         shape=[Hc, Wc], sweeps=sweeps)
    return rec


def _reset_counts() -> None:
    from avatar_tpu_torch.optim import nn_kernel

    nn_kernel.LAUNCHES.update(dict.fromkeys(nn_kernel.LAUNCHES, 0))


def _frozen(m):
    """The search ``m`` over copies of its tensors (a fit program's search
    reads buffers that its next fit loads anew)."""
    from avatar_tpu_torch.optim import nn_kernel

    c = nn_kernel.static_match(m)
    nn_kernel.load_match(c, m)
    return c


def _cloned(v):
    return v.clone() if hasattr(v, "clone") else v


@contextlib.contextmanager
def _recording(calls: list, name: str = "nn_argmin_ranges"):
    """Append every search of the kernel ``name`` that the block makes to
    ``calls``: (search, model cloud, center, visible, wild, gate, the
    path's own corr), tensors copied.  A search made by a Python call (a
    direct call, an uncaptured LM step) is recorded at the call through
    ``nn_kernel.nn_match``; a search inside a replayed LM graph is no
    Python call, and is recorded after each replay of a program's ``lin``
    from the program's buffers: the iterate the replay started from, the
    visibility it computed and the correspondences it wrote.  The block's
    fits run as they would without it, graphed on the card."""
    import torch

    from avatar_tpu_torch.optim import gauss_newton, nn_kernel

    real, real_run = nn_kernel.nn_match, gauss_newton._Program.run

    def record(m, model_cloud, center, visible, wild=-1000, wild_gate2=None):
        out = real(m, model_cloud, center, visible, wild, wild_gate2)
        if m.name == name and not (model_cloud.is_cuda and
                                   torch.cuda.is_current_stream_capturing()):
            calls.append((_frozen(m), model_cloud.clone(), center.clone(),
                          visible.clone(), wild, _cloned(wild_gate2),
                          out[1].clone()))
        return out

    def run(prog, relinearize, graphed):
        b = prog.b
        if not (graphed and relinearize and b.match.name == name):
            return real_run(prog, relinearize, graphed)
        x = b.x.clone()
        out = real_run(prog, relinearize, graphed)
        calls.append((_frozen(b.match), x, torch.mean(x, dim=0),
                      b.vis.clone(), prog.wild,
                      _cloned(getattr(b, "wild_gate2", None)),
                      b.corr.clone()))
        return out

    nn_kernel.nn_match, gauss_newton._Program.run = record, run
    try:
        yield
    finally:
        nn_kernel.nn_match, gauss_newton._Program.run = real, real_run


def _pairs(args, kw) -> int:
    """Scanned (row, model slot) pairs of one ranged launch: the rows of
    each tile times the columns of its chunk range (no range: all)."""
    tile_n, chunk = kw.get("tile_n", 256), kw.get("chunk", 512)
    if args[5] is None:
        return args[0].shape[0] * args[2].shape[0]
    cs, ce = args[5].long(), args[6].long()
    return int(((ce - cs).clamp(min=0) * chunk).sum()) * tile_n


def _bound(args, kw):
    """The least time (ms) the card could take for one ranged launch, and
    what bounds it: each input read once and each output written once
    over HBM bandwidth, against the scanned pairs' FP32 operations over
    the FP32 peak."""
    n_bytes = sum(a.numel() * a.element_size() for a in args
                  if a is not None) + args[0].shape[0] * 8
    if args[5] is None:     # the full range written out, as it was counted
        n_bytes += 2 * 4 * (args[0].shape[0] // kw.get("tile_n", 256))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = _pairs(args, kw) * OPS_PER_PAIR / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _hold_recorded(tag: str, calls: list, dev=None) -> float:
    """Every recorded search against the plain version on its inputs: the
    path's own correspondences, and the search again through the fused and
    the raw entry, indices equal and d2 equal to the last bit.  Returns
    the largest d2 abs error (0).  With ``dev``, also the spread of
    scanned pairs over the 64-row groups of the launches, and the kernel's
    times on the last recorded search."""
    import torch

    from avatar_tpu_torch.optim import nn_kernel

    if not calls:
        fail(f"[{tag}] no kernel call recorded")
    worst, shapes, pairs, bound, per_group = 0.0, set(), 0, 0.0, []
    for m, cloud, center, visible, wild, gate, corr in calls:
        args = nn_kernel.match_inputs(m, cloud, center, visible)
        kw = dict(tile_n=m.tile_n, chunk=m.chunk, wild=wild)
        n = args[0].shape[0]
        ref = nn_kernel.nn_argmin_ranges_ref(*args, **kw)
        got = nn_kernel.nn_argmin_ranges(*args, **kw)
        worst = max(worst, _compare(f"[{tag}] recorded", got, ref, n)[0])
        fused = nn_kernel.nn_match(m, cloud, center, visible, wild, gate)
        plain = nn_kernel.nn_match_ref(m, cloud, center, visible, wild, gate,
                                       argmin=lambda *a, **k: ref)
        torch.cuda.synchronize()
        if not torch.equal(corr, plain[1]):
            fail(f"[{tag}] recorded search: the path's corr differs from "
                 "the plain version")
        for what, x, y in zip(("d2", "corr", "wgt", "n_matched"), fused,
                              plain):
            if not torch.equal(x, y):
                fail(f"[{tag}] recorded search: the fused entry's {what} "
                     "differs from the plain version")
        shapes.add((n, args[2].shape[0], m.chunk, wild))
        pairs += _pairs(args, kw)
        bound += _bound(args, kw)[0]
        if m.cstart is not None:
            per_group.append((n, ((m.cend - m.cstart).clamp(min=0).long()
                                  * m.chunk * 64).repeat_interleave(
                                      m.tile_n // 64).tolist()))
    if worst != 0.0:
        fail(f"[{tag}] recorded launches: d2 max abs err {worst:.3g}, not 0")
    print(f"[{tag}] the path's corr and the fused and raw entry vs plain on "
          f"the inputs of its {len(calls)} searches (N, Pp, chunk, wild: "
          f"{sorted(shapes)}): "
          f"indices equal, d2 max abs err {worst:.3g}; "
          f"{pairs / len(calls):.0f} scanned pairs per launch, bound "
          f"{bound / len(calls) * 1e3:.3f} us per launch", flush=True)
    if dev is not None:
        # the imbalance a row-per-block design meets: the last search's N
        spread = sum((g for rows, g in per_group if rows == n), [])
        if spread:
            print(f"[{tag}] scanned pairs per 64-row group over the N={n} "
                  f"launches: min {min(spread)}, median "
                  f"{int(np.median(spread))}, max {max(spread)} (mean "
                  f"{np.mean(spread):.0f})", flush=True)
        run = lambda: nn_kernel.nn_match(m, cloud, center, visible, wild,
                                         gate)
        print(f"[{tag}] last recorded search (N={n}, "
              f"{_pairs(args, kw)} pairs): device_ms "
              f"{_device_ms(run, dev):.5f}, host_us {_host_us(run):.2f}, "
              f"call_ms {_time_ms(run):.4f}", flush=True)
    return worst


def _load_state(tracker, fixture, i: int) -> None:
    """Put the tracker in the JAX reference's state before frame i."""
    import torch

    from avatar_tpu_torch.optim.gauss_newton import Theta

    t = lambda k: torch.as_tensor(fixture[k][i], dtype=tracker.model.dtype,
                                  device=tracker.device)
    tracker._theta = Theta(t("state_p"), t("state_rots"), t("state_w"))
    tracker._theta_prev = Theta(t("state_prev_p"), t("state_prev_rots"),
                                t("state_prev_w"))
    tracker.com_pre = t("state_com_pre")
    tracker.reinit = bool(fixture["state_reinit"][i])
    tracker.first_init = bool(fixture["state_first_init"][i])
    tracker._lost_count = int(fixture["state_lost_count"][i])
    tracker._lost_frames = int(fixture["state_lost_frames"][i])
    z = float(fixture["state_last_root_z"][i])
    tracker._last_root_z = None if np.isnan(z) else z
    tracker._frame_no = int(fixture["state_frame_no"][i])
    n = int(fixture["state_shape_refit_in"][i])
    tracker._shape_refit_in = None if n < 0 else n
    tracker._starve = fixture["state_starve"][i].astype(np.int32)


def _joint_mm(a, b) -> float:
    return float(np.linalg.norm(a - b, axis=1).mean() * 1e3)


class Scene:
    """What phases 4-7 share: the model, forest, camera and fixtures."""

    def __init__(self, dev):
        from avatar_tpu_torch.io.calibration import CameraIntrin
        from avatar_tpu_torch.perception.rtree import RTree
        from avatar_tpu_torch.testing import synthetic_model

        self.dev = dev
        self.fixture = np.load(FIXTURE)
        self.refine = np.load(REFINE_FIXTURE)
        self.frames = self.fixture["depth"]
        self.gt = self.fixture["gt_joints"]
        self.model = synthetic_model(detail=6, device=dev)
        self.trees = [RTree(p, device=dev) for p in FORESTS]
        for t in self.trees:
            t.partmap_type = 0
        self.intrin = CameraIntrin(*map(float, self.fixture["intrin"]))
        self.bg_m = float(self.fixture["bg_depth_m"])

    def tracker(self, **cfg_kw):
        from avatar_tpu_torch.perception.partgroups import SMPL24_GROUP_LUT
        from avatar_tpu_torch.tracking import TrackerConfig
        from avatar_tpu_torch.tracking_fused import FusedTracker

        cfg = TrackerConfig(**BENCH_CFG, **cfg_kw,
                            part_groups=tuple(SMPL24_GROUP_LUT))
        tracker = FusedTracker(self.model, self.intrin, (H, W),
                               rtree=self.trees, config=cfg)
        tracker.set_background(np.full((H, W), self.bg_m, np.float32))
        return tracker


def _track_path(scene, tag, ref_fixture, steady_mm=REF_MM, **cfg_kw):
    """Free-running over the frames, then frame by frame from the
    reference's state in ``ref_fixture`` (steady-state frames within
    ``steady_mm`` of the reference), with the kernel held against its plain
    version on the inputs the synced run gave it.  Returns the kernel
    launches of the free-running run, its steady-state wall median and the
    kernel's largest d2 error."""
    import torch

    from avatar_tpu_torch.optim import nn_kernel

    frames, gt, ref = scene.frames, scene.gt, ref_fixture["ref_joints"]
    if not ref_fixture["ref_ok"].all():
        fail(f"[{tag}] the fixture's reference run lost track")
    model = scene.model

    # free-running: the main path as a user drives it
    tracker = scene.tracker(**cfg_kw)
    _reset_counts()
    runs = []
    for frame in frames:
        t0 = time.perf_counter()
        res = tracker.track(frame)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        verts, joints = tracker.pose()
        runs.append((res, ms, verts, joints, dict(tracker.limb_recoveries)))
    launches = dict(nn_kernel.LAUNCHES)
    for i, (res, ms, verts, joints, recov) in enumerate(runs):
        e_gt, e_ref = _joint_mm(joints, gt[i]), _joint_mm(ref[i], gt[i])
        print(f"[{tag}] free-running frame {i}: ok={res.ok} "
              f"reinit={res.reinitialized} n_points={res.n_points} wall "
              f"{ms:.1f} ms; joints vs GT {e_gt:.2f} mm (reference "
              f"{e_ref:.2f} mm), vs reference {_joint_mm(joints, ref[i]):.3f}"
              f" mm; limb recoveries {recov}", flush=True)
        if not (np.isfinite(verts).all() and np.isfinite(joints).all()
                and verts.shape == (model.num_points(), 3)
                and joints.shape == (24, 3)):
            fail(f"[{tag}] frame {i}: pose not finite or of the wrong shape")
        if not res.ok or res.reinitialized != (i == 0):
            fail(f"[{tag}] frame {i}: ok={res.ok} "
                 f"reinit={res.reinitialized}")
        if e_gt > TRACKING_MM:
            fail(f"[{tag}] frame {i}: {e_gt:.1f} mm from ground truth")
    if launches["nn_argmin_ranges"] <= 0:
        fail(f"[{tag}] the path never launched the nn_argmin_ranges kernel")

    # frame by frame from the reference's state
    tracker = scene.tracker(**cfg_kw)
    worst, calls = 0.0, []
    for i, frame in enumerate(frames):
        _load_state(tracker, ref_fixture, i)
        with _recording(calls):
            res = tracker.track(frame)
        _, joints = tracker.pose()
        d_ref = _joint_mm(joints, ref[i])
        e_gt, e_ref = _joint_mm(joints, gt[i]), _joint_mm(ref[i], gt[i])
        worst = max(worst, d_ref)
        print(f"[{tag}] synced frame {i}: ok={res.ok} joints vs reference "
              f"{d_ref:.3f} mm; vs GT {e_gt:.2f} mm (reference {e_ref:.2f} "
              "mm)", flush=True)
        if not res.ok:
            fail(f"[{tag}] synced frame {i} lost track")
        bound = REF_MM if res.reinitialized else steady_mm
        if d_ref > bound:
            fail(f"[{tag}] synced frame {i}: joints {d_ref:.2f} mm from the "
                 f"reference (bound {bound} mm)")
        if e_gt > e_ref + GT_SLACK_MM:
            fail(f"[{tag}] synced frame {i}: GT error {e_gt:.2f} mm > "
                 f"reference {e_ref:.2f} + {GT_SLACK_MM} mm")
    max_err = _hold_recorded(tag, calls, scene.dev)
    steady = float(np.median([r[1] for r in runs[2:]]))
    print(f"[{tag}] {len(runs)} frames ok, kernel launches {launches}, "
          f"synced worst joint distance to reference {worst:.3f} mm, "
          f"free-running steady-state wall median {steady:.1f} ms/frame",
          flush=True)
    return launches, steady, max_err


def phase_slice(scene):
    print(f"[slice] model {scene.model.num_points()} verts, forest "
          f"{len(scene.trees)} trees x {scene.trees[0].forest.num_nodes} "
          f"nodes, {len(scene.frames)} frames {W}x{H}", flush=True)
    return _track_path(scene, "slice", scene.fixture)


BATCH_WIDTH = 16        # bench.py's frames per batch (--batch)


def _copied(v):
    return v.copy() if isinstance(v, (np.ndarray, dict, list)) else v


def _state(tracker) -> dict:
    """The tracker's per-frame state, to be put back by ``_set_state``
    (tensors are never written in place, so they are shared)."""
    return {k: _copied(getattr(tracker, k)) for k in tracker._WARM_STATE}


def _set_state(tracker, state: dict) -> None:
    for k, v in state.items():
        setattr(tracker, k, _copied(v))


def _batch_joints(model, thetas) -> np.ndarray:
    """Joints [B, 24, 3] of a batch of poses."""
    from avatar_tpu_torch.core.lbs import lbs

    return np.stack([lbs(model.params, model.parents, thetas.w[b],
                         thetas.p[b], thetas.rots[b],
                         use_jsr=model.use_joint_shape_regressor)[1]
                     .cpu().numpy() for b in range(thetas.p.shape[0])])


def _bit_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def _same_thetas(a, b) -> bool:
    return all(_bit_equal(x, y) for x, y in zip(a, b))


def _timed(fn):
    """(fn's value, wall seconds to a synchronise)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_batch(scene):
    """The batch and async modes of ``FusedTracker`` at the bench's config
    on the fixture's frames, each from the state after ``track`` on frame
    0.  (a) ``track_batch`` over frames 1-5, the main path; (b) the same
    frames through ``_fused_frame_impl`` one by one, to the bit; (c)
    ``track_batch_async`` in batches of 2 and ``flush_batches``; (d)
    ``track_async`` and ``flush`` against the ``track`` chain; (e)
    ``warmup(batch=16)`` and a 16-frame batch against 16 ``track`` calls.
    Returns B1's launches in (a) and the recorded searches' largest d2
    error."""
    import torch

    from avatar_tpu_torch.optim import nn_kernel
    from avatar_tpu_torch.optim.gauss_newton import Theta
    from avatar_tpu_torch.tracking_fused import _fused_frame_impl

    tag = "batch"
    frames, gt, ref = scene.frames, scene.gt, scene.fixture["ref_joints"]
    seq = list(frames[1:])
    tracker = scene.tracker()
    c = tracker.config
    res0 = tracker.track(frames[0])
    if not (res0.ok and res0.reinitialized):
        fail(f"[{tag}] the reinit on frame 0 failed")
    after0 = _state(tracker)
    fps = {}

    # (a) the main path, with the batch run's own outputs kept for (b)
    runs, run_batch = [], tracker._run_batch
    tracker._run_batch = lambda *a: runs.append(run_batch(*a)) or runs[-1]
    calls = []
    _reset_counts()
    with _recording(calls):
        results, s = _timed(lambda: tracker.track_batch(seq))
    launches = dict(nn_kernel.LAUNCHES)
    del tracker._run_batch
    fps["track_batch"] = len(seq) / s
    thetas = tracker.batch_thetas
    if len(runs) != 1 or len(results) != len(seq) or \
            thetas.p.shape[0] != len(seq):
        fail(f"[{tag}] (a) {len(results)} results, "
             f"{thetas.p.shape[0]} poses and {len(runs)} batch runs for "
             f"{len(seq)} frames")
    if launches["nn_argmin_ranges"] <= 0:
        fail(f"[{tag}] (a) the batch never launched nn_argmin_ranges")
    joints = _batch_joints(scene.model, thetas)
    rows = []
    for i, (res, j) in enumerate(zip(results, joints), start=1):
        e_gt = _joint_mm(j, gt[i])
        rows.append(f"frame {i}: ok={res.ok} n_points={res.n_points} vs GT "
                    f"{e_gt:.2f} mm (reference {_joint_mm(ref[i], gt[i]):.2f}"
                    f"), vs reference {_joint_mm(j, ref[i]):.3f} mm")
        if not res.ok or res.reinitialized:
            fail(f"[{tag}] (a) frame {i}: ok={res.ok}")
        if not np.isfinite(j).all() or e_gt > TRACKING_MM:
            fail(f"[{tag}] (a) frame {i}: {e_gt:.1f} mm from ground truth")
    print(f"[{tag}] (a) track_batch over frames 1-{len(seq)} after track on "
          f"frame 0: " + "; ".join(rows) + f"; {fps['track_batch']:.2f} "
          f"frames per second; kernel launches {launches}", flush=True)
    max_err = _hold_recorded(tag, calls, scene.dev)

    # (b) the batch against _fused_frame_impl frame by frame, to the bit
    _set_state(tracker, after0)
    kw = tracker._frame_kwargs(c.frame_icp_iters * c.iters_per_icp,
                               refine=c.refine_every == 1)
    th_prev, th, com = kw.pop("theta_prev"), tracker._theta, tracker.com_pre
    _, diags, _, com_f, _ = runs[0]
    for i, frame in enumerate(seq):
        out = _fused_frame_impl(
            tracker._ctx, tracker._ctx_fit, tracker._tree,
            tracker.model.parents, tracker._upload(tracker._pre_stride(frame)),
            tracker._zero_labels, tracker._bg, tracker._intrin4, th, com,
            theta_prev=th_prev, **kw)
        th_prev, th, com = th, out.theta, out.com_pre
        if not (_same_thetas(out.theta, Theta(*(t[i] for t in thetas)))
                and _bit_equal(out.host_diag, diags[i])):
            fail(f"[{tag}] (b) frame {i + 1}: the batch differs from "
                 "_fused_frame_impl called frame by frame")
    if not _bit_equal(com, com_f):
        fail(f"[{tag}] (b) the batch's last com_pre differs")
    print(f"[{tag}] (b) thetas, host_diag and the last com_pre of the batch "
          "equal _fused_frame_impl called frame by frame with its arguments,"
          " to the bit", flush=True)

    # (c) batches of 2 in flight, then the flush
    _set_state(tracker, after0)
    got, resolved = [], []

    def run_async():
        for b in range(0, len(seq), 2):
            got.append(tracker.track_batch_async(seq[b:b + 2]))
        got.append(tracker.flush_batches())
    _, s = _timed(run_async)
    fps["track_batch_async"] = len(seq) / s
    counts = [len(g) for g in got]
    for g in got:
        resolved.extend(g)
    cat = Theta(*(torch.cat(f) for f in zip(*(t for _, t in resolved))))
    flags = [(r.ok, r.n_points) for rs, _ in resolved for r in rs]
    if counts != [0, 1, 1, 1] or not _same_thetas(cat, thetas) or \
            flags != [(r.ok, r.n_points) for r in results]:
        fail(f"[{tag}] (c) pairs per call {counts} (want [0, 1, 1, 1]), or "
             "the poses or results differ from (a)'s")
    print(f"[{tag}] (c) track_batch_async over [1, 2] [3, 4] [5], then "
          f"flush_batches: pairs per call {counts}, poses equal (a)'s to the "
          f"bit; {fps['track_batch_async']:.2f} frames per second",
          flush=True)

    # (d) track_async against the track chain
    outs = {}
    for mode in ("track", "track_async"):
        _set_state(tracker, after0)
        kept, run = [], tracker._run
        tracker._run = lambda *a, **k: kept.append(run(*a, **k)) or kept[-1]
        step = getattr(tracker, mode)
        got, s = _timed(lambda: [step(f) for f in seq] + (
            [tracker.flush()] if mode == "track_async" else []))
        del tracker._run
        fps[mode] = len(seq) / s
        outs[mode] = (got, kept, dict(tracker.limb_recoveries))
    (r_sync, o_sync, rec_sync), (r_async, o_async, rec_async) = \
        outs["track"], outs["track_async"]
    depth = c.pipeline_depth
    lagged = r_async[depth:-1] + r_async[-1:]
    want = r_sync[:len(seq) - depth] + r_sync[-1:]
    fired = bool(rec_sync or rec_async)
    if r_async[:depth] != [None] * depth or [
            (r.ok, r.n_points) for r in lagged] != [
            (r.ok, r.n_points) for r in want]:
        fail(f"[{tag}] (d) track_async's results are not track's, "
             f"{depth} calls late, and the flush frame {len(seq)}'s")
    same = all(_same_thetas(a.theta, b.theta)
               for a, b in zip(o_async, o_sync))
    if not fired and not same:
        fail(f"[{tag}] (d) no limb recovery fired, yet track_async's poses "
             "differ from track's")
    print(f"[{tag}] (d) track_async over frames 1-{len(seq)}, then flush: "
          f"{depth} Nones, then frames 1-{len(seq) - depth}'s results and "
          f"the flush frame {len(seq)}'s; limb recovery fired: "
          f"{rec_sync or 'no'} (track), {rec_async or 'no'} (track_async); "
          f"poses equal the track chain's to the bit: {same}; "
          f"{fps['track_async']:.2f} frames per second, track "
          f"{fps['track']:.2f}", flush=True)

    # (e) bench.py's batch width: warmup, then 16 frames ping-ponged over
    # the fixture, as one batch and through track, from the same state
    order = [1, 2, 3, 4, 5, 4, 3, 2]
    wide = [frames[order[i % len(order)]] for i in range(BATCH_WIDTH)]
    _set_state(tracker, after0)
    tracker.batch_thetas = thetas
    before = _tracker_state(tracker)
    _, s = _timed(lambda: tracker.warmup(frames[0], batch=BATCH_WIDTH))
    if not _equal(_tracker_state(tracker), before):
        fail(f"[{tag}] (e) warmup(batch={BATCH_WIDTH}) changed the "
             "tracker's state")
    warm_s = s
    lb = nn_kernel.LAUNCHES["nn_argmin_ranges"]
    res_b, s_b = _timed(lambda: tracker.track_batch(wide))
    lb = nn_kernel.LAUNCHES["nn_argmin_ranges"] - lb
    _set_state(tracker, after0)
    res_t, s_t = _timed(lambda: [tracker.track(f) for f in wide])
    if not all(r.ok for r in res_b + res_t):
        fail(f"[{tag}] (e) a frame of the {BATCH_WIDTH}-frame run lost "
             "track")
    print(f"[{tag}] (e) warmup(batch={BATCH_WIDTH}) {warm_s:.2f} s, state "
          f"after it equal to the state before; {BATCH_WIDTH} frames "
          f"ping-ponged: track_batch {BATCH_WIDTH / s_b:.2f} frames per "
          f"second ({lb} B1 launches), track {BATCH_WIDTH / s_t:.2f}",
          flush=True)
    fps[f"track_batch_{BATCH_WIDTH}"] = BATCH_WIDTH / s_b
    fps[f"track_{BATCH_WIDTH}"] = BATCH_WIDTH / s_t
    print(f"[{tag}] " + json.dumps(dict(
        frames_per_second={k: round(v, 3) for k, v in fps.items()},
        frames=len(seq), batch_width=BATCH_WIDTH)), flush=True)
    return launches, max_err


GRAPH_FRAMES = 3        # phase 4c: a reinit frame and two steady frames


@contextlib.contextmanager
def _fit_calls(calls: list):
    """Append (kind, theta, diag, wall ms) of every ``fit`` and
    ``fit_refine`` the trackers make in the block, each timed from a
    synchronise to a synchronise."""
    import torch

    from avatar_tpu_torch import tracking_fused
    from avatar_tpu_torch.optim import optimizer

    real = (tracking_fused.fit, tracking_fused.fit_refine, optimizer.fit)

    def timed(kind, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            theta, diag = fn(*a, **kw)
            torch.cuda.synchronize()
            calls.append((kind, theta, diag,
                          (time.perf_counter() - t0) * 1e3))
            return theta, diag
        return call

    tracking_fused.fit = timed("fit", real[0])
    tracking_fused.fit_refine = timed("refine", real[1])
    optimizer.fit = timed("fit", real[2])
    try:
        yield
    finally:
        tracking_fused.fit, tracking_fused.fit_refine, optimizer.fit = real


def _graph_run(tracker, drive, searches: bool):
    """Drive a tracker with its fits recorded, and its searches with
    ``searches`` (a run left unrecorded times its fits as a user runs
    them).  Returns (fits, frame rows, kernel launches, B1 searches, B2
    searches, programs captured in the run)."""
    import torch

    from avatar_tpu_torch.optim import gauss_newton, nn_kernel

    fits, b1, b2 = [], [], []
    captures = gauss_newton.CAPTURES
    _reset_counts()
    with contextlib.ExitStack() as stack:
        if searches:
            stack.enter_context(_recording(b1))
            stack.enter_context(_recording(b2, "nn_argmin"))
        stack.enter_context(_fit_calls(fits))
        rows = drive(tracker)
    torch.cuda.synchronize()
    return (fits, rows, dict(nn_kernel.LAUNCHES), b1, b2,
            gauss_newton.CAPTURES - captures)


def _same_fit(a, b) -> bool:
    """Two recorded fits equal to the bit: theta, cost, matches, accepted
    steps, last correspondences and part counts."""
    if a[0] != b[0]:
        return False
    return all(_bit_equal(x, y) for x, y in zip((*a[1], *a[2]),
                                                (*b[1], *b[2])))


def phase_graph(scene):
    """The LM loop as it runs on the card: every step of ``fit`` and
    ``fit_refine`` a replay of one of two captured CUDA graphs, the host
    reading (accept, stop) once after it.  On five paths -- the fused
    tracker's reinit frame (three seeded fits) and steady frames, the
    accuracy mode's refine frames (``fit`` then ``fit_refine``), the host
    tracker's frames and a ``track_batch`` of 16 -- a tracker with graphed
    fits and one whose fits run uncaptured (``eager_steps``) go through the
    same frames from the same state: every fit equal to the bit (theta,
    cost, matches, accepted steps, last correspondences, part counts), the
    frames' poses equal, the same kernel launches (the replays count the
    searches they launch), every search of the eager run equal to its
    plain version (the graphed run is left unrecorded, for its times; the
    other phases hold graphed searches to the plain version).  One eager
    step of the steady fit passes under ``set_sync_debug_mode("error")``.
    Prints, per path, the fit's and the frame's wall ms uncaptured (before)
    and graphed (after).  Returns the
    graphed runs' launches and the recorded searches' largest d2 error."""
    import torch

    from avatar_tpu_torch.optim import gauss_newton, nn_kernel

    tag = "graph"
    frames = scene.frames
    xyzs = [scene.intrin.depth_to_xyz_np(f.astype(np.float32) * 1e-3)
            for f in frames]
    order = [1, 2, 3, 4, 5, 4, 3, 2]
    wide = [frames[order[i % len(order)]] for i in range(BATCH_WIDTH)]

    def frames_of(seq):
        def drive(tracker):
            rows = []
            for frame in seq[:GRAPH_FRAMES]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = tracker.track(frame)
                torch.cuda.synchronize()
                rows.append((res.ok, (time.perf_counter() - t0) * 1e3,
                             _pose_bytes(tracker)))
            return rows
        return drive

    def batch(tracker):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tracker.track_batch(wide)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(wide)
        return [(all(r.ok for r in res), ms, b"".join(
            t.cpu().numpy().tobytes() for t in tracker.batch_thetas))]

    acc = dict(refine_every=1, refine_steps=2)
    paths = (("fused", scene.tracker, frames_of(frames), False),
             ("accuracy", lambda: scene.tracker(**acc), frames_of(frames),
              False),
             ("host", lambda: _host_tracker(scene), frames_of(xyzs), False),
             ("batch16", scene.tracker, batch, True))
    launches = dict.fromkeys(nn_kernel.LAUNCHES, 0)
    max_err, summary = 0.0, {}
    for path, make, drive, steady_first in paths:
        runs = {}
        for mode in ("eager", "graphed"):
            tracker = make()
            with contextlib.ExitStack() as stack:
                if mode == "eager":
                    stack.enter_context(gauss_newton.eager_steps())
                if hasattr(tracker, "warmup"):
                    # the graphs of every fit the tracker makes are
                    # captured here, not inside a timed frame
                    tracker.warmup(frames[0])
                if steady_first:
                    tracker.track(frames[0])
                runs[mode] = _graph_run(tracker, drive, mode == "eager")
        (f_e, r_e, n_e, b1, b2, _), (f_g, r_g, n_g, _, _, caps) = \
            runs["eager"], runs["graphed"]
        if not f_e or len(f_e) != len(f_g):
            fail(f"[{tag}] {path}: {len(f_g)} graphed fits against "
                 f"{len(f_e)} eager ones")
        for i, (a, b) in enumerate(zip(f_e, f_g)):
            if not _same_fit(a, b):
                fail(f"[{tag}] {path}: fit {i} ({a[0]}) graphed differs from "
                     "the eager fit (theta, cost, matches, accepted steps, "
                     "corr or part counts)")
        if [(ok, pose) for ok, _, pose in r_e] != \
                [(ok, pose) for ok, _, pose in r_g] or \
                not all(ok for ok, _, _ in r_g):
            fail(f"[{tag}] {path}: the graphed frames' poses differ from "
                 "the eager frames' (or a frame lost track)")
        # a capture inside the run (the host tracker has no warmup) first
        # runs its step functions once uncaptured: one more search each
        want = {k: v + (caps if k == "nn_argmin_ranges" else 0)
                for k, v in n_e.items()}
        if n_g != want or not n_g["nn_argmin_ranges"]:
            fail(f"[{tag}] {path}: kernel launches graphed {n_g}, eager "
                 f"{n_e} and {caps} captures in the run: the replays must "
                 "count what they launch")
        for name in launches:
            launches[name] += n_g[name]
        max_err = max(max_err, _hold_recorded(f"{tag} {path}", b1))
        if b2:
            max_err = max(max_err, _hold_recorded(f"{tag} {path} B2", b2))
        kinds = sorted({k for k, *_ in f_g})
        fit_ms = {mode: {k: [round(ms, 3) for kind, _, _, ms in fl
                             if kind == k] for k in kinds}
                  for mode, fl in (("eager", f_e), ("graphed", f_g))}
        steps = [int(d.inner_iters) for _, _, d, _ in f_g]
        summary[path] = dict(
            fits=len(f_g), accepted_steps=steps, launches=n_g,
            captures_in_run=caps,
            fit_ms=fit_ms,
            frame_ms={"eager": [round(ms, 3) for _, ms, _ in r_e],
                      "graphed": [round(ms, 3) for _, ms, _ in r_g]})
        for mode, fl, rl in (("eager", f_e, r_e), ("graphed", f_g, r_g)):
            print(f"[{tag}] {path} {mode}"
                  f"{' (before)' if mode == 'eager' else ' (after)'}: fit ms "
                  + "; ".join(f"{k} " + ", ".join(
                      f"{ms:.1f}" for kind, _, _, ms in fl if kind == k)
                      for k in kinds)
                  + "; frame ms " + ", ".join(f"{ms:.1f}" for _, ms, _ in rl),
                  flush=True)
    # one eager step of the steady fit reads nothing from the device
    key, prog = next((k, p) for k, p in reversed(
        tracker._programs.items()) if k[0] == "fit")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prog.fns["lin"]()
        prog.fns["step"]()
    except RuntimeError as e:
        fail(f"[{tag}] an eager LM step synchronised: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[{tag}] " + json.dumps(dict(
        summary, sync_free_step=f"lin and step of the {key[0]} program at N="
                       f"{prog.b.corr.shape[0]} under "
                       "set_sync_debug_mode('error')")), flush=True)
    return launches, max_err


def _pose_bytes(tracker) -> bytes:
    """A tracker's current pose as bytes (the fused tracker's theta, the
    host tracker's avatar)."""
    if hasattr(tracker, "_theta"):
        return b"".join(t.cpu().numpy().tobytes() for t in tracker._theta)
    return b"".join(np.asarray(a).tobytes() for a in (
        tracker.ava.p, tracker.ava.r, tracker.ava.w))


def _edges(img, jump):
    """Pixels with a 3x3 neighbour that differs from them by more than
    ``jump``, or that lie on the image border."""
    pad = np.pad(img.astype(np.int64), 1, mode="edge")
    out = np.zeros(img.shape, bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            nb = pad[dy:dy + img.shape[0], dx:dx + img.shape[1]]
            out |= np.abs(nb - img) > jump
    return out


def phase_render(scene):
    """The ground-truth frames rendered on the card against the fixture."""
    import torch

    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.render import raster, renderer

    rf, model = scene.refine, scene.model
    bg_mm = int(round(scene.bg_m * 1000))
    ava = Avatar(model)
    worst = 0.0
    clouds = []
    for i in range(len(scene.frames)):
        ava.p, ava.r, ava.w = (rf["gt_p"][i].copy(), rf["gt_rots"][i].copy(),
                               rf["gt_w"][i].copy())
        ava.update()
        clouds.append(ava.cloud.copy())
        rend = renderer.AvatarRenderer(ava, scene.intrin)
        depth = rend.render_depth((H, W))
        scene_mm = (np.where(depth > 0, depth, np.float32(scene.bg_m)) *
                    1000).astype(np.uint16)
        ref = scene.frames[i]
        body = (ref != bg_mm) | (scene_mm != bg_mm)
        diff = scene_mm.astype(np.int64) - ref
        edge = _edges(ref, 20) | _edges(scene_mm, 20)
        n_diff = int((diff != 0).sum())
        interior = int(np.abs(diff[~edge]).max()) if (~edge).any() else 0
        frac = n_diff / max(int(body.sum()), 1)
        worst = max(worst, frac)
        print(f"[render] frame {i}: {int(body.sum())} body pixels, "
              f"{n_diff} differ ({frac * 100:.4f}%), largest interior "
              f"difference {interior} mm", flush=True)
        if frac > RENDER_FRAC or interior > RENDER_INTERIOR_MM:
            fail(f"[render] frame {i}: {n_diff} pixels differ, interior up "
                 f"to {interior} mm")
        if i == 0:
            mask = rend.render_part_mask((H, W))
            ref_mask = rf["part_mask0"]
            on_edge = (_edges(ref_mask, 0) | _edges(mask, 0) | edge)
            bad = mask != ref_mask
            frac_m = int(bad.sum()) / max(int(body.sum()), 1)
            off = int((bad & ~on_edge).sum())
            print(f"[render] frame 0 part mask: {int(bad.sum())} pixels "
                  f"differ ({frac_m * 100:.4f}%), {off} off the edges",
                  flush=True)
            if frac_m > RENDER_FRAC or off:
                fail("[render] frame 0 part mask differs from the fixture")
    faces = torch.as_tensor(model.faces, dtype=torch.int32, device=scene.dev)
    vp = torch.as_tensor(model.main_joint, dtype=torch.int32,
                         device=scene.dev)
    cloud = torch.as_tensor(clouds[0], device=scene.dev)
    budget = raster.default_budget(H, W, model.num_faces())
    i = scene.intrin
    ms = _time_ms(lambda: renderer.render_frame(
        cloud, faces, vp, i.fx, i.fy, i.cx, i.cy, H, W, budget))
    print(f"[render] {len(clouds)} frames within bounds (worst "
          f"{worst * 100:.4f}% of body pixels); render_frame at {W}x{H} "
          f"(budget {budget}): {ms:.3f} ms (CUDA events, median of 20)",
          flush=True)
    return ms


def phase_probe(scene):
    """bench.py's converged-fit probe (fit_rmse_mm) on the card."""
    import torch

    from avatar_tpu_torch.core.lbs import lbs
    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.optim import nn_kernel
    from avatar_tpu_torch.optim.gauss_newton import Theta, fit_refine
    from avatar_tpu_torch.optim.surface import vertex_face_rings
    from avatar_tpu_torch.render.renderer import AvatarRenderer
    from avatar_tpu_torch.testing import probe_samples

    rf, model, dev = scene.refine, scene.model, scene.dev
    ava = Avatar(model)
    ava.p, ava.r, ava.w = (rf["gt_p"][0].copy(), rf["gt_rots"][0].copy(),
                           rf["gt_w"][0].copy())
    ava.update()
    rend = AvatarRenderer(ava, scene.intrin)
    depth = rend.render_depth((H, W))
    depth_mm = (np.where(depth > 0, depth, np.float32(scene.bg_m)) *
                1000).astype(np.uint16)
    tracker = scene.tracker()
    pts, parts = probe_samples(depth_mm, rend.render_part_mask((H, W)),
                                scene.intrin, BENCH_CFG["data_interval"],
                                tracker._glut)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    theta = Theta(f32(ava.p), f32(ava.r), f32(ava.w))
    ring = torch.as_tensor(vertex_face_rings(model.faces, model.num_points()),
                           device=dev)
    args = (tracker._ctx, model.parents, ring, f32(pts),
            torch.as_tensor(parts, device=dev), theta, f32(1e-4), f32(1e-4))
    kw = dict(n_steps=20, num_parts=tracker.num_parts)
    calls = []
    _reset_counts()
    with _recording(calls):
        out, diag = fit_refine(*args, **kw)
    torch.cuda.synchronize()
    launches = dict(nn_kernel.LAUNCHES)
    v = lbs(model.params, model.parents, out.w, out.p, out.rots)[0]
    rmse = float(np.sqrt(np.mean(np.sum((v.cpu().numpy() - ava.cloud) ** 2,
                                        -1))) * 1e3)
    ref_rmse = float(rf["probe_fit_rmse_mm"])
    # 20 LM steps with the stop test off (function_tolerance 0)
    step_ms = _time_ms(lambda: fit_refine(*args, **kw,
                                          function_tolerance=0.0),
                       reps=5) / 20
    print(f"[probe] {int((parts >= 0).sum())} samples, {int(diag.n_matched)} "
          f"matched, {int(diag.inner_iters)} accepted steps; fit_rmse_mm "
          f"{rmse:.4f} (reference {ref_rmse:.4f}); kernel launches "
          f"{launches}; {step_ms:.3f} ms per refine LM step "
          "(CUDA events, 20 steps, median of 5)", flush=True)
    if not np.isfinite(rmse) or rmse >= PROBE_MM:
        fail(f"[probe] fit_rmse_mm {rmse:.3f} >= {PROBE_MM}")
    if abs(rmse - ref_rmse) >= PROBE_REF_MM:
        fail(f"[probe] fit_rmse_mm {rmse:.3f} vs reference {ref_rmse:.3f}")
    if launches["nn_argmin_ranges"] <= 0:
        fail("[probe] fit_refine never launched the nn_argmin_ranges kernel")
    return launches, step_ms, _hold_recorded("probe", calls, dev)


def phase_accuracy(scene):
    out = _track_path(scene, "accuracy", scene.refine,
                      steady_mm=REFINE_REF_MM, refine_every=1,
                      refine_steps=2)
    # control: the same synced steady frames with no refine must miss the
    # bound, or the bound does not tell a working refine from none
    tracker, ref = scene.tracker(), scene.refine["ref_joints"]
    near = []
    for i, frame in enumerate(scene.frames):
        if scene.refine["state_reinit"][i]:
            continue
        _load_state(tracker, scene.refine, i)
        tracker.track(frame)
        near.append(_joint_mm(tracker.pose()[1], ref[i]))
    print(f"[accuracy] control, synced with no refine: joints vs reference "
          + ", ".join(f"{d:.3f}" for d in near) + " mm", flush=True)
    if min(near) <= REFINE_REF_MM:
        fail(f"[accuracy] a frame with no refine lands {min(near):.3f} mm "
             f"from the reference, within the {REFINE_REF_MM} mm bound")
    return out


def _host_tracker(scene):
    from avatar_tpu_torch.perception.rtree import RTree
    from avatar_tpu_torch.tracking import Tracker, TrackerConfig

    rtree = RTree(FORESTS[0], device=scene.dev)
    rtree.partmap_type = 0
    tracker = Tracker(scene.model, scene.intrin, (H, W), rtree=rtree,
                      config=TrackerConfig(**BENCH_CFG))
    tracker.set_background(scene.intrin.depth_to_xyz_np(
        np.full((H, W), scene.bg_m, np.float32)))
    return tracker


def _load_host_state(tracker, hf, i: int) -> None:
    """Put the host tracker in the JAX reference's state before frame i."""
    ava = tracker.ava
    ava.p, ava.r, ava.w = (hf["state_p"][i].copy(), hf["state_r"][i].copy(),
                           hf["state_w"][i].copy())
    tracker.com_pre = hf["state_com_pre"][i].copy()
    tracker.reinit = bool(hf["state_reinit"][i])
    tracker.first_init = bool(hf["state_first_init"][i])


def phase_host(scene):
    """The reference's host ``Tracker`` on the card: free-running, then
    frame by frame from the JAX reference's state.  Returns (launches,
    steady wall median, largest d2 error, frame 0's optimizer input)."""
    import torch

    from avatar_tpu_torch.optim import nn_kernel

    hf = np.load(HOST_FIXTURE)
    ref, gt = hf["ref_joints"], scene.gt
    if not hf["ref_ok"].all():
        fail("[host] the fixture's reference run lost track")
    ref_gt = [_joint_mm(ref[i], gt[i]) for i in range(len(gt))]
    bound = max(TRACKING_MM, max(ref_gt) + HOST_SLACK_MM)
    xyzs = [scene.intrin.depth_to_xyz_np(f.astype(np.float32) * 1e-3)
            for f in scene.frames]

    tracker = _host_tracker(scene)
    _reset_counts()
    runs = []
    for xyz in xyzs:
        t0 = time.perf_counter()
        res = tracker.track(xyz)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs.append((res, ms, tracker.ava.cloud.copy(),
                     tracker.ava.joint_pos.copy()))
    launches = dict(nn_kernel.LAUNCHES)
    for i, (res, ms, cloud, joints) in enumerate(runs):
        print(f"[host] free-running frame {i}: ok={res.ok} "
              f"reinit={res.reinitialized} n_points={res.n_points} "
              f"(reference {int(hf['ref_n_points'][i])}) wall {ms:.1f} ms; "
              f"joints vs GT {_joint_mm(joints, gt[i]):.2f} mm (reference "
              f"{ref_gt[i]:.2f} mm, bound {bound:.2f}), vs reference "
              f"{_joint_mm(joints, ref[i]):.3f} mm", flush=True)
    for i, (res, ms, cloud, joints) in enumerate(runs):
        e_gt = _joint_mm(joints, gt[i])
        if not (np.isfinite(cloud).all() and np.isfinite(joints).all()
                and cloud.shape == (scene.model.num_points(), 3)):
            fail(f"[host] frame {i}: pose not finite or of the wrong shape")
        if not res.ok or res.reinitialized != (i == 0):
            fail(f"[host] frame {i}: ok={res.ok} "
                 f"reinit={res.reinitialized}")
        if e_gt > bound:
            fail(f"[host] frame {i}: {e_gt:.1f} mm from ground truth")
    if launches["nn_argmin_ranges"] <= 0:
        fail("[host] the path never launched the nn_argmin_ranges kernel")

    # frame by frame from the reference's state; the optimizer's inputs
    # (samples and the avatar before the fit) are recorded
    tracker = _host_tracker(scene)
    opt_inputs, optimize = [], tracker.optimizer.optimize

    def record_optimize(pts, labels, **kw):
        a = tracker.ava
        opt_inputs.append((np.array(pts), np.array(labels), a.p.copy(),
                           a.r.copy(), a.w.copy(), a.joint_pos.copy()))
        return optimize(pts, labels, **kw)

    tracker.optimizer.optimize = record_optimize
    worst, calls = 0.0, []
    for i, xyz in enumerate(xyzs):
        _load_host_state(tracker, hf, i)
        with _recording(calls):
            res = tracker.track(xyz)
        joints = tracker.ava.joint_pos
        d_ref, e_gt = _joint_mm(joints, ref[i]), _joint_mm(joints, gt[i])
        print(f"[host] synced frame {i}: ok={res.ok} reinit="
              f"{res.reinitialized} n_points={res.n_points} (reference "
              f"{int(hf['ref_n_points'][i])}) joints vs reference "
              f"{d_ref:.3f} mm, vs GT {e_gt:.2f} mm (reference "
              f"{ref_gt[i]:.2f} mm)", flush=True)
        if not res.ok or res.reinitialized != bool(hf["ref_reinit"][i]):
            fail(f"[host] synced frame {i}: ok={res.ok} "
                 f"reinit={res.reinitialized}")
        if res.reinitialized and e_gt > bound:
            fail(f"[host] synced reinit frame {i}: {e_gt:.1f} mm from "
                 "ground truth")
        if not res.reinitialized:
            worst = max(worst, d_ref)
            if d_ref > REF_MM:
                fail(f"[host] synced frame {i}: joints {d_ref:.3f} mm from "
                     f"the reference (bound {REF_MM} mm)")
    # control: the same synced steady frames with the fit a no-op, so the
    # avatar stays at the reference's state before the frame, must miss
    # the bound, or the bound does not tell a working fit from none
    def no_fit(pts, labels, **kw):
        tracker.ava.update()
        return dict(cost=0.0, n_matched=0, inner_iters=0, part_counts=[])

    tracker.optimizer.optimize = no_fit
    near = []
    for i, xyz in enumerate(xyzs):
        if hf["ref_reinit"][i]:
            continue
        _load_host_state(tracker, hf, i)
        tracker.track(xyz)
        near.append(_joint_mm(tracker.ava.joint_pos, ref[i]))
    print("[host] control, synced steady frames with no fit: joints vs "
          "reference " + ", ".join(f"{d:.3f}" for d in near) + " mm "
          f"(bound {REF_MM} mm)", flush=True)
    if min(near) <= REF_MM:
        fail(f"[host] a frame with no fit lands {min(near):.3f} mm from the "
             f"reference, within the {REF_MM} mm bound")
    # the reinit fit where it is determined: its first 8 LM steps
    pts, labels, p, r, w, joints0 = opt_inputs[0]
    tracker.ava.p, tracker.ava.r, tracker.ava.w = p, r, w
    with _recording(calls):
        optimize(pts, labels, icp_iters=2)
    d8 = _joint_mm(tracker.ava.joint_pos, hf["reinit8_joints"])
    control = _joint_mm(joints0, gt[0])
    print(f"[host] reinit fit of frame 0 cut to 8 LM steps: joints vs "
          f"reference {d8:.3f} mm; control, the unfitted reinit pose: "
          f"{control:.2f} mm from GT against the bound {bound:.2f} mm",
          flush=True)
    if d8 > REF_MM:
        fail(f"[host] 8-step reinit fit {d8:.2f} mm from the reference")
    if control <= bound:
        fail("[host] the unfitted pose meets the free-running bound")
    max_err = _hold_recorded("host", calls, scene.dev)
    steady = float(np.median([r[1] for r in runs[2:]]))
    print(f"[host] {len(runs)} frames ok, kernel launches {launches}, "
          f"synced steady frames within {worst:.3f} mm of the reference, "
          f"free-running steady-state wall median {steady:.1f} ms/frame",
          flush=True)
    return launches, steady, max_err, opt_inputs[0][:2]


def phase_library(scene, samples):
    """The public NN on frame 0's unpadded samples: B2 against B1, and
    ``fit`` with N % 256 != 0 against the bucketed fit."""
    import torch

    from avatar_tpu_torch.core.lbs import lbs
    from avatar_tpu_torch.optim import correspond, nn_kernel
    from avatar_tpu_torch.optim.gauss_newton import Theta, fit
    from avatar_tpu_torch.optim.optimizer import _bucket

    hf, model, dev = np.load(HOST_FIXTURE), scene.model, scene.dev
    opt = _host_tracker(scene).optimizer
    pts_np, labels_np = samples
    N = pts_np.shape[0]
    B = _bucket(N)
    if N % 256 == 0:
        fail(f"[library] {N} samples: a multiple of 256, B2 would not run")
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    pts, labels = f32(pts_np), torch.as_tensor(labels_np, device=dev)
    pts_b = torch.cat([pts, torch.zeros(B - N, 3, device=dev)])
    labels_b = torch.cat([labels, torch.full((B - N,), -1, device=dev,
                                             dtype=torch.int32)])
    # the reference's pose after frame 0
    theta = Theta(f32(hf["state_p"][1]), f32(hf["state_r"][1]),
                  f32(hf["state_w"][1]))
    x = lbs(model.params, model.parents, theta.w, theta.p, theta.rots)[0]
    vis = correspond.backface_visibility(x, opt._ctx.faces)
    mpart = opt._ctx.model_part

    _reset_counts()
    b2_calls, b1_calls = [], []
    with _recording(b2_calls, "nn_argmin"):
        st2 = correspond.find_nn_stats(pts, labels, x, mpart, vis)
    with _recording(b1_calls):
        plan = correspond.make_nn_plan(pts_b, labels_b, mpart,
                                       num_parts=opt.num_parts)
        st1 = correspond.find_nn_stats_planned(plan, x, vis)
    order = torch.argsort(labels_b, stable=True)
    corr1 = torch.empty_like(st1.corr)
    corr1[order] = st1.corr
    same = int((corr1[:N] == st2.corr).sum())
    print(f"[library] {N} samples (bucket {B}), {int(vis.sum())} visible "
          f"vertices: find_nn_stats (B2) and the planned NN (B1) agree on "
          f"{same} of {N} correspondences; n_matched {int(st2.n_matched)} "
          f"and {int(st1.n_matched)}", flush=True)
    if same != N or float(st2.n_matched) != float(st1.n_matched):
        fail("[library] B2's correspondences differ from B1's")

    kw = dict(n_steps=int(opt.max_iters_per_icp) * BENCH_CFG[
        "frame_icp_iters"], use_jsr=model.use_joint_shape_regressor,
        enable_occlusion=bool(opt.enable_occlusion), robust=bool(opt.robust),
        plane_weight=float(opt.plane_weight),
        point_weight=float(opt.point_weight), num_parts=int(opt.num_parts),
        huber_k=float(opt.huber_k), robust_per_part=bool(opt.robust_per_part))
    betas = (f32(opt.beta_pose), f32(opt.beta_shape))
    before = nn_kernel.LAUNCHES["nn_argmin"]
    with _recording(b2_calls, "nn_argmin"):
        th2, dg2 = fit(opt._ctx, model.parents, pts, labels, theta, *betas,
                       **kw)
    fit_b2 = nn_kernel.LAUNCHES["nn_argmin"] - before
    with _recording(b1_calls):
        th1, dg1 = fit(opt._ctx, model.parents, pts_b, labels_b, theta,
                       *betas, **kw)
    launches = dict(nn_kernel.LAUNCHES)
    joints = lambda th: lbs(model.params, model.parents, th.w, th.p,
                            th.rots)[1].cpu().numpy()
    j2, j1, j0 = joints(th2), joints(th1), joints(theta)
    d, moved = _joint_mm(j2, j1), _joint_mm(j1, j0)
    print(f"[library] fit on {N} unpadded samples: {fit_b2} B2 launches, "
          f"{int(dg2.inner_iters)} accepted steps, n_matched "
          f"{int(dg2.n_matched)}; bucketed fit {int(dg1.inner_iters)} and "
          f"{int(dg1.n_matched)}; joints {d:.4f} mm apart (bound "
          f"{LIBRARY_FIT_MM} mm); control, the bucketed fit's distance "
          f"from its start: {moved:.4f} mm", flush=True)
    if fit_b2 <= 0:
        fail("[library] the unpadded fit never launched nn_argmin")
    if d > LIBRARY_FIT_MM:
        fail(f"[library] unpadded fit {d:.4f} mm from the bucketed fit")
    if moved <= LIBRARY_FIT_MM:
        fail(f"[library] the fit moves {moved:.4f} mm from its start, within "
             f"the {LIBRARY_FIT_MM} mm bound: a no-op fit would pass")
    err = max(_hold_recorded("library B2", b2_calls),
              _hold_recorded("library B1", b1_calls))
    return launches, err


_TREE_FIELDS = ("u", "v", "thresh", "lnode", "rnode", "leafid", "leaf_data")


def _tree_diff(a, b):
    """The fields in which two forests differ ([] when equal)."""
    return [f for f in _TREE_FIELDS
            if not np.array_equal(getattr(a, f), getattr(b, f))]


class _MemorySource:
    """Frames held in host memory, as a trainer's ``frame_source``."""

    def __init__(self, depth, mask):
        self.depth, self.mask = depth, mask

    def size(self):
        return len(self.depth)

    def load_batch(self, ids):
        ids = np.asarray(ids)
        return self.depth[ids], self.mask[ids]


@contextlib.contextmanager
def _timed_passes(tforest, log: list):
    """CUDA events around every level pass the block makes: ``log`` gets
    (pass name, level index at the time, start event, end event)."""
    import torch

    names = ("pass_minmax_flat", "pass_counts_flat", "pass_assign_flat",
             "split_gains", "split_decide")
    real = {n: getattr(tforest, n) for n in names}
    depth = [0]

    def timed(name):
        def run(*a, **kw):
            if depth[0]:        # split_gains inside split_decide
                return real[name](*a, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            depth[0] += 1
            start.record()
            try:
                out = real[name](*a, **kw)
            finally:
                depth[0] -= 1
            end.record()
            log.append((name, start, end))
            return out
        return run

    for n in names:
        setattr(tforest, n, timed(n))
    try:
        yield
    finally:
        for n in names:
            setattr(tforest, n, real[n])


def phase_train(scene, images=TRAIN_IMAGES, depth=TRAIN_DEPTH, n_eval=16):
    """The forest trainer on the card at the bench forest's widths."""
    import tempfile

    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_bench_forest_torch as bench

    from avatar_tpu_torch.core.lbs import lbs
    from avatar_tpu_torch.io import formats
    from avatar_tpu_torch.perception.rtree import RTree
    from avatar_tpu_torch.render import raster
    from avatar_tpu_torch.render.renderer import render_frame, render_frames
    from avatar_tpu_torch.train import forest as tforest
    from avatar_tpu_torch.train import synth

    dev, model = scene.dev, scene.model
    part_map, num_parts = bench.label_space(True)

    # (a) the main path: ForestTrainer.train by the recipe
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fd, trainer = bench.train_bench_tree(model, images, depth)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cache = trainer._depth_cache
    H_, W_ = trainer.H, trainer.W
    print(f"[train] recipe: detail-6 model ({model.num_points()} vertices, "
          f"{model.num_faces()} faces), {num_parts} groups, {W_}x{H_} frames "
          f"(1280x720 at stride 3), {trainer.S} points per image, "
          f"{trainer.F} features filtered to {trainer.F_filtered}, "
          f"{trainer.T} buckets, min_samples {trainer.min_samples}, balance "
          f"{trainer.sample_balance}, image batch {trainer.B}; scale cut to "
          f"{images} images and depth {depth}", flush=True)
    if (H_, W_, trainer.S, trainer.F, trainer.F_filtered, trainer.T,
            num_parts, trainer.B) != (240, 427, 2000, 512, 64, 16, 14, 72):
        fail("[train] the trainer does not run at the recipe's widths")
    if not (cache.is_cuda and trainer.samples.x.is_cuda
            and cache.shape == (images, H_, W_)
            and cache.element_size() == 2):
        fail("[train] the frame cache or the samples are not on the card")
    n_valid = int(trainer.samples.valid.sum())
    print(f"[train] {images} frames rendered and sampled in "
          f"{trainer.init_seconds:.2f} s ({images / trainer.init_seconds:.1f}"
          f" frames per second), {n_valid} samples; frame cache "
          f"{cache.numel() * cache.element_size()} bytes on the card, peak "
          f"device memory {peak} bytes; training {train_s:.2f} s in all, "
          f"{fd.num_nodes} nodes, {int((fd.leafid >= 0).sum())} leaves",
          flush=True)
    # a frame's parts at the recipe's size: skinning is a loop over poses,
    # the raster one call per image batch
    src, n_keys = trainer.src, model.num_shape_keys()
    w, p, rots = synth.sample_pose(src, np.arange(trainer.B), trainer.seed,
                                   n_keys)
    clouds = torch.stack([lbs(src.lbs, model.parents, w[b], p[b],
                              rots[b])[0] for b in range(trainer.B)])
    budget = raster.default_budget(H_, W_, model.num_faces())
    rest = (src.faces, src.vertex_part, *src.intrin.unbind(0), H_, W_,
            budget)
    t0 = time.perf_counter()
    for _ in range(10):
        synth.sample_pose(src, np.arange(trainer.B), trainer.seed, n_keys)
    torch.cuda.synchronize()
    pose_ms = (time.perf_counter() - t0) * 100 / trainer.B
    lbs_ms = _time_ms(lambda: lbs(src.lbs, model.parents, w[0], p[0],
                                  rots[0]))
    one_ms = _time_ms(lambda: render_frame(clouds[0], *rest))
    batch_ms = _time_ms(lambda: render_frames(clouds, *rest), reps=5)
    print(f"[train] a frame at {W_}x{H_}: sample_pose {pose_ms:.3f} ms "
          f"(host clock, per pose of a batch), lbs {lbs_ms:.3f} ms, "
          f"render_frame alone {one_ms:.3f} ms, render_frames of "
          f"{trainer.B} poses {batch_ms:.3f} ms = "
          f"{batch_ms / trainer.B:.3f} ms per frame (budget {budget}; events"
          " around one call, median of 20, of 5 for the batch)", flush=True)
    evals = sum(s["probe_evals"] for s in trainer.level_stats)
    wall = sum(s["wall_s"] for s in trainer.level_stats)
    print(f"[train] {len(trainer.level_stats)} levels in {wall:.2f} s: "
          f"{evals} probe evaluations, {evals / wall:.4g} per second",
          flush=True)

    # (b) the tree is sound
    internal = fd.leafid < 0
    kids = np.concatenate([fd.lnode[internal], fd.rnode[internal]])
    sums = fd.leaf_data.sum(1)
    if not (internal.sum() > 3 and kids.min() > 0
            and kids.max() < fd.num_nodes
            and len(np.unique(kids)) == fd.num_nodes - 1):
        fail("[train] children out of range or not a tree")
    if not (np.isfinite(fd.leaf_data).all()
            and np.abs(sums - 1.0).max() <= 1e-5):
        fail(f"[train] leaf distributions sum to {sums.min()}..{sums.max()}")

    # (c) the export round-trips, through the reader the tracker uses
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trained.srtr")
        bench.write_forest(path, fd, True, dev)
        back = formats.read_srtr(path)
        tree = RTree(path, device=dev)
    diff = _tree_diff(back, fd)
    if diff or back.num_parts != num_parts or \
            list(tree.part_map) != list(part_map):
        fail(f"[train] the exported .srtr reads back different in {diff}")
    print(f"[train] tree sound ({int(internal.sum())} splits, every leaf "
          f"sums to 1 within {np.abs(sums - 1.0).max():.2g}); exported "
          ".srtr and .partmap read back equal", flush=True)

    # (d) held-out accuracy, beside the committed forest and a control
    t0 = time.perf_counter()
    ev_depth, ev_mask = bench.held_out_frames(model, True, n_eval)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    acc, per_part, total = bench.held_out_accuracy([tree], ev_depth, ev_mask,
                                                   num_parts)
    committed = RTree(GROUP_FOREST, device=dev)
    acc_c, _, _ = bench.held_out_accuracy([committed], ev_depth, ev_mask,
                                          num_parts)
    hist = np.bincount(trainer.samples.part[trainer.samples.valid]
                       .cpu().numpy(), minlength=num_parts)
    root = RTree(num_parts, device=dev)
    root.set_forest(formats.ForestData(
        np.zeros((1, 2), np.float32), np.zeros((1, 2), np.float32),
        np.zeros(1, np.float32), np.full(1, -1, np.int32),
        np.full(1, -1, np.int32), np.zeros(1, np.int32),
        (hist / hist.sum()).astype(np.float32)[None], num_parts))
    acc_0, _, _ = bench.held_out_accuracy([root], ev_depth, ev_mask,
                                          num_parts)
    print(f"[train] held-out accuracy on {n_eval} fresh {W}x{H} frames "
          f"(seed {bench.EVAL_SEED}, rendered in {render_s:.2f} s, "
          f"{int(total.sum())} pixels at stride 3, group space): trained "
          f"{acc:.4f} (bound {TRAIN_ACCURACY}), committed "
          f"bench_forest_g14c.srtr {acc_c:.4f}, control (the tree cut to its "
          f"root's leaf, group {int(np.argmax(hist))}) {acc_0:.4f}; worst "
          "groups " + " ".join(f"g{p}={per_part[p]:.2f}"
                               for p in np.argsort(per_part)[:4]),
          flush=True)
    if not acc > TRAIN_ACCURACY:
        fail(f"[train] held-out accuracy {acc:.4f} <= {TRAIN_ACCURACY}")
    if not acc_0 < TRAIN_ACCURACY:
        fail(f"[train] the control's accuracy {acc_0:.4f} meets the bound")

    # (e) flat and batch pass modes grow one tree on the card
    small = dict(features=24, filtered=0, seed=7)
    fd_f, tr_f = bench.train_bench_tree(model, 16, 6, pass_mode="flat",
                                        **small)
    fd_b, _ = bench.train_bench_tree(model, 16, 6, pass_mode="batch",
                                     **small)
    diff = _tree_diff(fd_f, fd_b)
    print(f"[train] 16 images, depth 6, 24 features: flat and batch modes "
          f"grow {fd_f.num_nodes} and {fd_b.num_nodes} nodes, differing in "
          f"{diff or 'nothing'}", flush=True)
    if diff or fd_f.num_nodes < 7:
        fail("[train] flat and batch pass modes grow different trees")

    # (f) the card grows the CPU's tree from the same frames in memory
    # (every random choice numpy's)
    source = _MemorySource(
        tforest._decode_mm(tr_f._depth_cache).cpu().numpy(),
        synth.render_batch(tr_f.src, model.parents, np.arange(16), 7,
                           tr_f.H, tr_f.W,
                           model.num_shape_keys())[1].cpu().numpy())
    kw = dict(num_parts=num_parts, num_images=16, num_points_per_image=2000,
              num_features=24, max_probe_offset=220.0 / 3, min_samples=48,
              max_tree_depth=6, image_batch=72, seed=7, frame_source=source)
    fd_card = tforest.ForestTrainer(None, None, (tr_f.H, tr_f.W), device=dev,
                                    **kw).train()
    fd_cpu = tforest.ForestTrainer(None, None, (tr_f.H, tr_f.W),
                                   device="cpu", **kw).train()
    diff = _tree_diff(fd_card, fd_cpu)
    print(f"[train] in-memory frame source, 16 images, depth 6: the card "
          f"grows {fd_card.num_nodes} nodes, the CPU {fd_cpu.num_nodes}, "
          f"differing in {diff or 'nothing'}", flush=True)
    if diff:
        n = min(fd_card.num_nodes, fd_cpu.num_nodes)
        bad = [i for i in range(n) if any(
            not np.array_equal(getattr(fd_card, f)[i], getattr(fd_cpu, f)[i])
            for f in _TREE_FIELDS[:6])]
        i = bad[0] if bad else n
        fail(f"[train] the card's tree differs from the CPU's from node {i}:"
             f" card u {fd_card.u[i]} v {fd_card.v[i]} thresh "
             f"{fd_card.thresh[i]}, CPU u {fd_cpu.u[i]} v {fd_cpu.v[i]} "
             f"thresh {fd_cpu.thresh[i]}")

    # (g) leaf transfer on fresh full-resolution frames
    old_leaf = tree.forest.leaf_data.copy()
    t0 = time.perf_counter()
    tree.train_transfer(model, None, scene.intrin, (H, W), num_images=8,
                        seed=31)
    transfer_s = time.perf_counter() - t0
    new_leaf = tree.forest.leaf_data
    moved = int((np.abs(new_leaf - old_leaf).max(1) > 1e-6).sum())
    print(f"[train] train_transfer on 8 fresh {W}x{H} frames in "
          f"{transfer_s:.2f} s: {moved} of {len(new_leaf)} leaves changed, "
          f"sums within {np.abs(new_leaf.sum(1) - 1.0).max():.2g} of 1",
          flush=True)
    if moved == 0 or np.abs(new_leaf.sum(1) - 1.0).max() > 1e-5 or \
            not np.array_equal(tree.forest.thresh, fd.thresh):
        fail("[train] train_transfer left the leaves unchanged or "
             "unnormalized")

    # where a level's time goes: the same training again with CUDA events
    # around every pass; it must grow the same tree
    log = []
    with _timed_passes(tforest, log):
        trainer2 = bench.make_trainer(model, images, depth)
        marks, level = [], trainer2._train_level

        def mark_level():
            marks.append(len(log))
            level()

        trainer2._train_level = mark_level
        fd2 = trainer2.train()
    torch.cuda.synchronize()
    fd2.u, fd2.v = fd2.u * 3.0, fd2.v * 3.0
    if _tree_diff(fd2, fd):
        fail("[train] a second training run grew another tree: "
             f"{_tree_diff(fd2, fd)}")
    marks.append(len(log))
    totals = {}
    for lv, (st1, st2) in enumerate(zip(trainer.level_stats,
                                        trainer2.level_stats)):
        by = {}
        for name, start, end in log[marks[lv]:marks[lv + 1]]:
            by[name] = by.get(name, 0.0) + start.elapsed_time(end)
        for k, v in by.items():
            totals[k] = totals.get(k, 0.0) + v
        dev_ms = sum(by.values())
        print(f"[train] level {lv}: {st1['nodes']} nodes, "
              f"{st1['frontier_samples']} samples in them, "
              f"{st1['probe_evals']} probe evaluations; wall "
              f"{st1['wall_s'] * 1e3:.1f} ms (instrumented run "
              f"{st2['wall_s'] * 1e3:.1f} ms), device {dev_ms:.1f} ms: "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(by.items())),
              flush=True)
    wall2 = sum(s["wall_s"] for s in trainer2.level_stats) * 1e3
    print(f"[train] second run grew the same tree; all levels: device "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(totals.items()))
          + f" = {sum(totals.values()):.1f} ms of {wall2:.1f} ms wall (the "
          "rest: host bookkeeping, uploads, downloads and idle device)",
          flush=True)

    # the count scatter at the dense pass's shape, deterministic
    # algorithms on and off (whole-number counts: the same either way)
    for what, cells in (("512 nodes", 512 * 64 * 16 * 14),
                        ("1 node", 64 * 16 * 14)):
        gen = torch.Generator(device=dev).manual_seed(0)
        idx = torch.randint(0, cells, ((1 << 17) * 64,), device=dev,
                            generator=gen)
        ones = torch.ones(1, device=dev).expand(idx.shape[0])
        scatter = lambda: torch.zeros(cells + 1, device=dev).scatter_add_(
            0, idx, ones)
        det = scatter()
        ms_on = _device_ms(scatter, dev, n=5, runs=3)
        torch.use_deterministic_algorithms(False)
        try:
            free = scatter()
            ms_off = _device_ms(scatter, dev, n=5, runs=3)
        finally:
            torch.use_deterministic_algorithms(True)
        if not (torch.equal(det, free) and torch.equal(
                free, tforest._count(idx, cells + 1))):
            fail("[train] the count scatter depends on its algorithm")
        print(f"[train] count scatter, {idx.shape[0]} ones into {cells} "
              f"cells ({what} x 64 features x 16 buckets x 14 groups): "
              f"device_ms {ms_on:.3f} with deterministic algorithms, "
              f"{ms_off:.3f} without; counts equal", flush=True)


TOOLS_LIMIT_S = 240     # wall-clock limit of one live_demo run


def _timed_median_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


@contextlib.contextmanager
def _wall_limit(seconds: int, what: str):
    """Fail, instead of hanging, when the block outlasts ``seconds``."""
    import signal

    def expired(signum, frame):
        raise TimeoutError(f"{what} ran past its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    except TimeoutError as e:
        fail(f"[tools] {e}")
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _tools_native(scene, depths):
    """The native library: built, serving, the codec byte-equal to the
    numpy one on the 6 frames, and the host labeler equal to the device
    labeler on frame 0's bgsub mask, on its forest segmentation (a
    component per part region) and on a seeded random mask."""
    import torch

    from avatar_tpu_torch.native import build as nbuild
    from avatar_tpu_torch.native import labeling, rle
    from avatar_tpu_torch.perception import cc
    from avatar_tpu_torch.perception.bgsub import BGSubtractor
    from avatar_tpu_torch.perception.rtree import RTree

    t0 = time.perf_counter()
    path = nbuild.build(verbose=False)
    build_s = time.perf_counter() - t0
    if not rle._load_native():
        fail(f"[tools] native library built at {path} but not serving")
    for i, d in enumerate(depths):
        data = rle.encode(d)
        lib, rle._LIB = rle._LIB, False
        try:
            plain = rle.encode(d)
            plain_back = rle.decode(plain)
        finally:
            rle._LIB = lib
        if data != plain:
            fail(f"[tools] frame {i}: native RLE bytes differ from numpy's")
        back = rle.decode(data)
        if back.tobytes() != d.tobytes() or \
                plain_back.tobytes() != d.tobytes():
            fail(f"[tools] frame {i}: RLE decode differs from the frame")
    bg = scene.intrin.depth_to_xyz_np(np.full((H, W), scene.bg_m,
                                              np.float32))
    mask = BGSubtractor(bg, stride=1, device=scene.dev).run(
        scene.intrin.depth_to_xyz_np(depths[0]))
    seg = RTree(FORESTS[0], device=scene.dev).predict_best(depths[0])
    rng = np.random.default_rng(0)
    noise = rng.random((H, W)) < 0.5
    cases = (("bgsub mask", mask != 255, None),
             ("forest segmentation", seg != 255, seg),
             ("random mask", noise, None),
             ("random mask and values", noise,
              rng.integers(0, 3, (H, W)).astype(np.uint8)))
    counts = []
    for what, active, values in cases:
        host = labeling.connected_components_host(active, values)
        dev = cc.connected_components(
            torch.as_tensor(active, device=scene.dev),
            values=None if values is None else torch.as_tensor(
                values, device=scene.dev), max_iters=4096).cpu().numpy()
        if not np.array_equal(host, dev):
            fail(f"[tools] connected_components_host differs from "
                 f"perception.cc.connected_components on the card ({what})")
        counts.append(f"{what} {int(active.sum())} pixels, "
                      f"{len(np.unique(host[active]))} components")
    print(f"[tools] native library {os.path.basename(path)} built in "
          f"{build_s:.2f} s and serving; RLE bytes equal to numpy's on "
          f"{len(depths)} frames; host labels equal the card's at "
          f"{W}x{H}: " + "; ".join(counts), flush=True)


def _write_dataset(scene, root, depths):
    """The 6 frames and the background frame 9999 through ``DatasetWriter``
    as ``.depth`` RLE, read back equal; ``Dataset.xyz`` ms per frame,
    native and numpy."""
    from avatar_tpu_torch.io.dataset import Dataset, DatasetWriter
    from avatar_tpu_torch.native import rle

    # RLE even where OpenCV could write EXR: the native codec is on the path
    w = DatasetWriter(root, scene.intrin, pad=4, use_exr=False)
    for i, d in enumerate(depths):
        w.write_depth(i + 1, d)
    bg = np.full((H, W), scene.bg_m, np.float32)
    w.write_depth(9999, bg)
    ds = Dataset(root, pad=4)
    if list(ds.frames()) != list(range(1, len(depths) + 1)):
        fail(f"[tools] dataset frames {list(ds.frames())}")
    for i, d in enumerate(depths):
        if ds.depth(i + 1).tobytes() != d.tobytes():
            fail(f"[tools] dataset frame {i + 1} reads back different")
    if ds.depth(9999).tobytes() != bg.tobytes():
        fail("[tools] dataset background frame reads back different")
    ms = {}
    for name, lib in (("native", rle._load_native()), ("numpy", False)):
        keep, rle._LIB = rle._LIB, lib
        try:
            ms[name] = _timed_median_ms(
                lambda: [ds.xyz(i + 1) for i in range(len(depths))], 5) / \
                len(depths)
        finally:
            rle._LIB = keep
    print(f"[tools] dataset written (RLE) and read back equal; "
          f"Dataset.xyz ms per {W}x{H} frame: native "
          f"{ms['native']:.3f}, numpy {ms['numpy']:.3f}", flush=True)
    return ds


class _Recorder:
    """Per ``track`` of a tracker class: (ok, n_points, reinitialized,
    joints) and the host clock at its entry; the trackers built."""

    def __init__(self, cls, fused: bool):
        self.built, self.rows, self.entries = [], [], []
        rec = self

        class Recording(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec.built.append(self)

            def track(self, *a, **kw):
                rec.entries.append(time.perf_counter())
                res = super().track(*a, **kw)
                rec.rows.append(_track_row(self, res, fused))
                return res

        self.cls = Recording


def _track_row(tracker, res, fused):
    joints = tracker.pose()[1] if fused else tracker.ava.joint_pos.copy()
    return (res.ok, res.n_points, res.reinitialized, joints)


def _tools_demo(scene, root, fused, calls, launches):
    """``demo.main`` over the dataset against the same tracker class,
    built with the same config, driven directly over the same arrays.
    The tool's kernel launches go to ``launches``; the searches of both
    drives are recorded into ``calls``."""
    import dataclasses

    import torch

    from avatar_tpu_torch import tracking_fused
    from avatar_tpu_torch.io.dataset import Dataset
    from avatar_tpu_torch.tools import demo

    tag = "demo fused" if fused else "demo host"
    owner, name = ((tracking_fused, "FusedTracker") if fused
                   else (demo, "Tracker"))
    real = getattr(owner, name)
    rec = _Recorder(real, fused)
    setattr(owner, name, rec.cls)
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                _tool_launches(calls, launches):
            log = os.path.join(tmp, "metrics.jsonl")
            demo.main([root, FORESTS[0], "-I", "6", "-t", "2", "-T", "6",
                       "--inner-iters", "4", "-M", "1000",
                       "--synthetic-model", "6", "--part-groups",
                       "--metrics", log] + (["--fused"] if fused else []))
            with open(log) as f:
                logged = len(f.readlines())
    finally:
        setattr(owner, name, real)
    torch.cuda.synchronize()
    rows = rec.rows
    if len(rows) != len(scene.frames) or len(rec.built) != 1:
        fail(f"[{tag}] {len(rows)} frames tracked by {len(rec.built)} "
             "trackers")
    if logged != sum(r[0] for r in rows):
        fail(f"[{tag}] metrics log has {logged} lines")
    built = rec.built[0]
    direct = real(built.model, built.intrin, built.image_size,
                  rtree=built.rtree, config=dataclasses.replace(built.config))
    ds = Dataset(root, pad=4)
    direct.set_background(ds.xyz(9999))
    walls = []
    with _recording(calls):
        for i, row in enumerate(rows):
            xyz = ds.xyz(i + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = direct.track(xyz)
            got = _track_row(direct, res, fused)
            walls.append((time.perf_counter() - t0) * 1e3)
            if got[:3] != row[:3] or got[3].tobytes() != row[3].tobytes():
                fail(f"[{tag}] frame {i}: the tool's result {row[:3]} "
                     f"differs from the direct drive's {got[:3]}, or its "
                     "joints")
            if not row[0]:
                fail(f"[{tag}] frame {i} lost track")
    gaps = np.diff(rec.entries) * 1e3
    err = [_joint_mm(r[3], scene.gt[i]) for i, r in enumerate(rows)]
    print(f"[{tag}] {len(rows)} frames: ok, n_points, reinit and joints "
          f"equal to the bit to the direct drive's; joints vs GT "
          + ", ".join(f"{e:.2f}" for e in err) + " mm (mean "
          f"{np.mean(err):.2f}); steady wall ms per frame: demo "
          f"{np.median(gaps[1:]):.1f} (frame to frame), direct "
          f"{np.median(walls[1:]):.1f}", flush=True)


def _tools_segmentation(scene, root, depths):
    """``rtree_run_dataset`` with the three r5 trees and ``rtree_run`` on
    one frame, against ``RTree.predict`` / ``predict_best`` and
    ``post_process`` called directly."""
    from avatar_tpu_torch.perception.rtree import RTree
    from avatar_tpu_torch.tools import rtree_run, rtree_run_dataset
    from avatar_tpu_torch.utils import palette_color_table

    def same(path, seg, parts):
        if path.endswith(".npy"):
            return np.array_equal(np.load(path), seg)
        import cv2

        table = (palette_color_table(max(parts, 17)) * 255).astype(np.uint8)
        vis = table[np.minimum(seg, parts - 1)]
        vis[seg == 255] = 0
        return np.array_equal(cv2.imread(path), vis)

    trees = [RTree(p, device=scene.dev) for p in FORESTS]
    P = trees[0].num_parts
    n = 2
    with tempfile.TemporaryDirectory() as tmp:
        rtree_run_dataset.main([root, *FORESTS, "--out", tmp,
                                "--max-frames", str(n)])
        com_pre = np.full((2, P), -1.0)
        com_pre[1, :] = 0.0
        files = sorted(os.listdir(tmp))
        if len(files) != n:
            fail(f"[tools] rtree_run_dataset wrote {files}")
        for i in range(n):
            dist = None
            for t in trees:
                d = t.predict(depths[i], interval=2)
                dist = d if dist is None else dist + d
            seg = np.where(dist.sum(-1) > 0,
                           np.argmax(dist, -1).astype(np.uint8), 255)
            seg = trees[0].post_process(seg, com_pre, interval=2)
            if not same(os.path.join(tmp, files[i]), seg, P):
                fail(f"[tools] rtree_run_dataset frame {i + 1} differs from "
                     "predict + post_process")
        out = os.path.join(tmp, "one.png")
        rtree_run.main([os.path.join(root, "depth_exr", "depth_0001.depth"),
                        FORESTS[0], "-o", out])
        out = out if os.path.exists(out) else out + ".npy"
        if not same(out, trees[0].predict_best(depths[0]), P):
            fail("[tools] rtree_run differs from predict_best")
    print(f"[tools] rtree_run_dataset ({len(FORESTS)} trees, {n} frames) "
          f"and rtree_run (one tree) equal to predict / predict_best + "
          f"post_process; written as {os.path.splitext(files[0])[1]}",
          flush=True)


def _live_dataset(scene, root, depths, walls=120, repeat=150):
    """A recording for ``live_demo``: ``walls`` frames of the empty scene
    (4 s at the camera's 30 fps, so that frame 1, the background capture,
    sees it) and then each of the 6 frames ``repeat`` times (slow motion,
    30 s in all).  Repeats are hard links."""
    from avatar_tpu_torch.io.dataset import DatasetWriter

    w = DatasetWriter(root, scene.intrin, pad=4, use_exr=False)
    name = lambda i: os.path.join(root, "depth_exr", f"depth_{i:04d}.depth")
    firsts = [1] + [walls + 1 + k * repeat for k in range(len(depths))]
    w.write_depth(1, np.full((H, W), scene.bg_m, np.float32))
    for first, d in zip(firsts[1:], depths):
        w.write_depth(first, d)
    for first, n in zip(firsts, [walls] + [repeat] * len(depths)):
        for j in range(1, n):
            os.link(name(first), name(first + j))


def _tools_live(tag, argv, frames):
    """One ``live_demo.main`` run under the wall-clock limit: frames
    tracked, frames ok, tracked frames per second and the camera thread's
    share of the run (the time it spent in ``next_frame``)."""
    from avatar_tpu_torch.tools import live_demo

    stamps, results, busy = [], [], []
    real_open = live_demo.open_camera

    def open_camera(spec, **kw):
        cam = real_open(spec, **kw)
        produce = cam.next_frame

        def timed():
            t0 = time.perf_counter()
            out = produce()
            busy.append(time.perf_counter() - t0)
            return out

        cam.next_frame = timed
        return cam

    def on_frame(n, state, res):
        stamps.append(time.perf_counter())
        results.append(res)

    live_demo.open_camera = open_camera
    t0 = time.perf_counter()
    try:
        with _wall_limit(TOOLS_LIMIT_S, f"live_demo {tag}"):
            live_demo.main(argv + ["--frames", str(frames)],
                           on_frame=on_frame)
    except RuntimeError as e:           # the capture thread died
        fail(f"[live {tag}] {e}")
    finally:
        live_demo.open_camera = real_open
    wall = time.perf_counter() - t0
    tracked = [r for r in results if r is not None]
    if len(results) != frames or len(tracked) != frames:
        fail(f"[live {tag}] {len(results)} frames, {len(tracked)} tracked")
    ok = sum(r.ok for r in tracked)
    fps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    print(f"[live {tag}] {len(tracked)} frames tracked, {ok} ok, "
          f"{fps:.2f} tracked frames per second (frame 1 to the last), "
          f"{wall:.1f} s in all; camera thread in next_frame "
          f"{sum(busy):.2f} s over {len(busy)} frames "
          f"({sum(busy) / wall:.1%} of the run); per frame ok / n_points / "
          "s after the start: " + ", ".join(
              f"{int(r.ok)}/{r.n_points}/{t - t0:.1f}"
              for r, t in zip(tracked, stamps)), flush=True)


@contextlib.contextmanager
def _tool_launches(calls: list, counts: dict):
    """Record the block's B1 searches into ``calls`` and add the kernel
    launches it makes to ``counts`` (the counts are reset before it)."""
    from avatar_tpu_torch.optim import nn_kernel

    _reset_counts()
    with _recording(calls):
        yield
    for k, v in nn_kernel.LAUNCHES.items():
        counts[k] = counts.get(k, 0) + v


def _tools_models(scene, root, calls, launches):
    """The model tools at the card's defaults: ``optim_tool`` (the
    synthetic-GT fit; its B1 searches go to ``calls``, its launches to
    ``launches``), ``smpltrim``, ``smpl_viewer`` in each mode,
    ``face_landmark_tracking`` over the recording at ``root``, and, where
    matplotlib imports, ``scratch`` and ``smpl_viewer --interactive``."""
    import io

    import torch

    from avatar_tpu_torch.core.model import Avatar, AvatarModel
    from avatar_tpu_torch.tools import (face_landmark_tracking, optim_tool,
                                        smpl_viewer, smpltrim)

    def printed(fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(argv)
        return out, buf.getvalue()

    t0 = time.perf_counter()
    with _tool_launches(calls, launches):
        post, text = printed(optim_tool.main, ["--synthetic-model", "6"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    line = next(ln for ln in text.splitlines() if ln.startswith("vertex"))
    pre = float(line.split()[2]) * 1e-3
    if not (np.isfinite(post) and post < pre):
        fail(f"[tools] optim_tool: vertex RMSE {pre} -> {post} m did not "
             "fall")
    if launches.get("nn_argmin_ranges", 0) <= 0:
        fail("[tools] optim_tool never launched B1")
    print(f"[tools] optim_tool --synthetic-model 6 at 512x512 (the card's "
          f"defaults, 100 LM steps): {line.strip()} (the reference test's "
          f"bar: under 80 mm), {wall:.2f} s wall; kernel launches "
          f"{launches}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        trim = os.path.join(tmp, "trim")
        smpltrim.main([trim, "--synthetic-model", "6", "-d", "L_HIP", "-d",
                       "R_HIP"])
        m = AvatarModel(trim, device=scene.dev)
        ava = Avatar(m)
        ava.update()
        if m.num_joints() != 16 or not np.isfinite(ava.cloud).all():
            fail(f"[tools] smpltrim's model: {m.num_joints()} joints, or "
                 "its posed cloud not finite")
        body = {}
        for mode in ("lambert", "depth", "parts"):
            out = os.path.join(tmp, f"{mode}.png")
            smpl_viewer.main(["-o", out, "--synthetic-model", "6",
                              "--random", "3", "--mode", mode])
            if os.path.exists(out):
                import cv2

                img = cv2.imread(out, cv2.IMREAD_UNCHANGED)
            else:
                img = np.load(out + ".npy")
            fg = img != 0
            body[mode] = int((fg.any(-1) if fg.ndim == 3 else fg).sum())
            if body[mode] < 1000:
                fail(f"[tools] smpl_viewer --mode {mode}: {body[mode]} body "
                     "pixels")
        print(f"[tools] smpltrim: {m.num_points()} of "
              f"{scene.model.num_points()} vertices and 16 joints, loaded and"
              f" posed on the card; smpl_viewer at 512x512, body pixels per "
              f"mode {body}", flush=True)
        _, text = printed(face_landmark_tracking.main,
                          [root, "--max-frames", str(len(scene.frames))])
        lines = [ln for ln in text.splitlines() if ln.startswith("frame")]
        if len({ln.split()[1].rstrip(":") for ln in lines}) != \
                len(scene.frames):
            fail(f"[tools] face_landmark_tracking printed {lines}")
        print(f"[tools] face_landmark_tracking over the recording: "
              f"{len(lines)} lines for {len(scene.frames)} frames, first: "
              f"{lines[0]}", flush=True)
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("[tools] scratch and smpl_viewer --interactive skipped: "
                  "matplotlib is not installed here", flush=True)
            return
        from avatar_tpu_torch.tools import scratch

        display = os.environ.pop("DISPLAY", None)     # plot to files
        try:
            shots = [os.path.join(tmp, "scratch.png"),
                     os.path.join(tmp, "iview.png")]
            printed(scratch.main, ["-o", shots[0], "--synthetic-model", "6",
                                   "--random", "5"])
            printed(smpl_viewer.main, ["-o", shots[1], "--synthetic-model",
                                       "6", "--interactive",
                                       "--lbs-weights-of", "4"])
        finally:
            if display is not None:
                os.environ["DISPLAY"] = display
        sizes = [os.path.getsize(p) if os.path.exists(p) else 0
                 for p in shots]
        if min(sizes) == 0:
            fail(f"[tools] scratch / smpl_viewer --interactive wrote {sizes}")
        print(f"[tools] scratch and smpl_viewer --interactive wrote "
              f"{sizes} bytes of PNG (matplotlib, headless)", flush=True)


def phase_tools(scene):
    """The camera-to-tracker tools on the card at 1280x720: the native
    library, a dataset written and read, ``demo`` (host and fused),
    ``rtree_run_dataset`` / ``rtree_run``, ``live_demo`` (synthetic camera
    and a recording), ``data_recording`` / ``smplsynth`` where OpenCV is
    installed; then the model tools (``_tools_models``).  Returns, for the
    camera-to-tracker tools and for ``optim_tool``, the kernel launches and
    the recorded searches' largest d2 error."""
    from avatar_tpu_torch.io.camera import SyntheticCamera

    depths = [f.astype(np.float32) * 1e-3 for f in scene.frames]
    _tools_native(scene, depths)
    for size in ((360, 640), (H, W)):
        cam = SyntheticCamera(image_size=size, device=scene.dev)
        cam.next_frame()
        print(f"[tools] SyntheticCamera.next_frame at {size[1]}x{size[0]}: "
              f"{_timed_median_ms(cam.next_frame, 5):.2f} ms (median of 5)",
              flush=True)
    calls, launches, per_frame = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ds")
        _write_dataset(scene, root, depths)
        for fused in (False, True):
            got = {}
            _tools_demo(scene, root, fused, calls, got)
            per_frame["demo fused" if fused else "demo host"] = (
                got, len(depths))
        _tools_segmentation(scene, root, depths)
        live = os.path.join(tmp, "live")
        _live_dataset(scene, live, depths)
        # the recording's empty frames are lost fast: 24 frames reach the
        # body's
        for tag, argv, n in (
                ("synthetic", ["--camera", "synthetic", "--synthetic-model",
                               "2", "-I", "4", "-M", "200"], 8),
                ("recording", [FORESTS[0], "--camera", live, "--fused",
                               "--synthetic-model", "6", "-I", "6", "-t",
                               "2", "-T", "6", "--inner-iters", "4",
                               "--capture-bg-after", "1"], 24)):
            got = {}
            with _tool_launches(calls, got):
                _tools_live(tag, argv, n)
            per_frame[f"live {tag}"] = (got, n)
        optim_calls, optim_launches = [], {}
        _tools_models(scene, root, optim_calls, optim_launches)
    for tag, (got, n) in per_frame.items():
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[tools] {tag}: kernel launches {got}, "
              f"{got['nn_argmin_ranges'] / n:.1f} B1 per frame", flush=True)
    if launches["nn_argmin_ranges"] <= 0:
        fail("[tools] the tools never launched the nn_argmin_ranges kernel")
    try:
        import cv2  # noqa: F401
    except ImportError:
        print("[tools] data_recording and smplsynth not run: they write RGB "
              "frames, part masks and joint YAML through OpenCV, which is "
              "not installed here", flush=True)
    else:
        from avatar_tpu_torch.tools import data_recording, smplsynth

        with tempfile.TemporaryDirectory() as tmp:
            data_recording.main([os.path.join(tmp, "rec"), "--camera",
                                 "synthetic", "--frames", "3", "--fps", "0",
                                 "--verify"])
            smplsynth.main([os.path.join(tmp, "synth"), "-n", "2",
                            "--batch", "2", "--synthetic-model", "6"])
        print("[tools] data_recording --verify and smplsynth ran", flush=True)
    return ((launches, _hold_recorded("tools", calls, scene.dev)),
            (optim_launches, _hold_recorded("optim_tool", optim_calls,
                                            scene.dev)))


@contextlib.contextmanager
def _timed_collectives(log: list):
    """CUDA events around every all-reduce and all-gather of the sharded
    passes: ``log`` gets (start event, end event)."""
    import torch

    from avatar_tpu_torch.parallel import training as ptrain

    real = {n: getattr(ptrain, n) for n in ("_reduce", "_gather")}

    def timed(fn):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            log.append((start, end))
            return out
        return run

    for n, fn in real.items():
        setattr(ptrain, n, timed(fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(ptrain, n, fn)


def _mesh_train(scene, images, depth):
    """(a) the bench recipe over a world of one, against batch mode with
    no mesh: the same tree, node for node."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_bench_forest_torch as bench

    from avatar_tpu_torch.parallel.training import make_mesh

    model = scene.model
    t0 = time.perf_counter()
    fd_b, tr_b = bench.train_bench_tree(model, images, depth,
                                        pass_mode="batch")
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    log, marks = [], []
    with make_mesh(1, device=scene.dev) as mesh, _timed_collectives(log):
        backend = dist_backend()
        if (mesh.size, backend) != (1, "nccl" if scene.dev.type == "cuda"
                                    else "gloo"):
            fail(f"[mesh] the world of one is {mesh} over {backend}")
        trainer = bench.make_trainer(model, images, depth, mesh=mesh)
        level = trainer._train_level

        def mark_level():
            marks.append(len(log))
            level()

        trainer._train_level = mark_level
        t0 = time.perf_counter()
        fd_m = trainer.train()
        torch.cuda.synchronize()
        wall_m = time.perf_counter() - t0
    marks.append(len(log))
    fd_m.u, fd_m.v = fd_m.u * 3.0, fd_m.v * 3.0
    diff = _tree_diff(fd_m, fd_b)
    if (trainer.pass_mode, trainer.B) != ("batch", 72):
        fail(f"[mesh] the mesh trainer runs {trainer.pass_mode} passes of "
             f"{trainer.B} images")
    if diff or fd_m.num_nodes < 100:
        fail(f"[mesh] the world of one grew {fd_m.num_nodes} nodes, "
             f"differing from batch mode's {fd_b.num_nodes} in {diff}")
    print(f"[mesh] (a) bench recipe over a world of one ({backend}), "
          f"{images} images, depth {depth}: "
          f"{fd_m.num_nodes} nodes, node for node the tree of batch mode "
          f"without a mesh; wall {wall_m:.2f} s (init "
          f"{trainer.init_seconds:.2f} s) against {wall_b:.2f} s (init "
          f"{tr_b.init_seconds:.2f} s)", flush=True)
    for lv, (sm, sb) in enumerate(zip(trainer.level_stats,
                                      tr_b.level_stats)):
        coll = [s.elapsed_time(e) for s, e in log[marks[lv]:marks[lv + 1]]]
        print(f"[mesh] level {lv}: {sm['nodes']} nodes, wall "
              f"{sm['wall_s'] * 1e3:.1f} ms (no mesh "
              f"{sb['wall_s'] * 1e3:.1f} ms); {len(coll)} all-reduces and "
              f"all-gathers, {sum(coll):.3f} ms on the device", flush=True)


def dist_backend() -> str:
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else "none"


def _mesh_tool(scene, images, depth):
    """(b) ``rtree_train --devices 1`` writes the bytes of ``--devices 0``;
    ``--devices 2`` exits naming the one visible card."""
    import torch

    from avatar_tpu_torch.tools import rtree_train

    args = ["--synthetic-model", "6", "--images", str(images), "--depth",
            str(depth), "--features", "64", "-q"]
    data, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in (0, 1):
            path = os.path.join(tmp, f"d{n}.srtr")
            t0 = time.perf_counter()
            rtree_train.main([path, *args, "--devices", str(n)])
            torch.cuda.synchronize()
            walls[n] = time.perf_counter() - t0
            with open(path, "rb") as f:
                data[n] = f.read()
        out = os.path.join(tmp, "d2.srtr")
        try:
            rtree_train.main([out, *args, "--devices", "2"])
        except SystemExit as e:
            refused = e.code
        else:
            refused = None
        written = os.path.exists(out)
    if data[1] != data[0]:
        fail("[mesh] rtree_train --devices 1 wrote other bytes than "
             "--devices 0")
    n_cards = torch.cuda.device_count()
    if not refused or refused == 0 or written or \
            f"{n_cards} CUDA device(s) visible" not in str(refused):
        fail(f"[mesh] rtree_train --devices 2 on {n_cards} card(s) was not "
             f"refused naming the count: {refused!r}")
    print(f"[mesh] (b) rtree_train at 1280x720, {images} images, depth "
          f"{depth}: --devices 1 wrote the {len(data[0])} bytes of "
          f"--devices 0 (wall {walls[1]:.2f} s and {walls[0]:.2f} s); "
          f"--devices 2 refused: {refused}", flush=True)


def _mesh_track(scene, frames=(1, 2)):
    """(c) ``sharded_track_step`` over a world of one, a stream per
    fixture frame from the reference's state before it, against
    ``_fused_frame_impl`` called directly on each stream; and
    ``FusedTracker.track`` from the same state, for its time.  Returns the
    B1 launches of the sharded step and the recorded searches."""
    import torch

    from avatar_tpu_torch.optim import nn_kernel
    from avatar_tpu_torch.optim.gauss_newton import Theta
    from avatar_tpu_torch.parallel.training import (make_mesh,
                                                     sharded_track_step)
    from avatar_tpu_torch.tracking_fused import _fused_frame_impl

    tracker = scene.tracker()
    c = tracker.config
    n_steps = c.frame_icp_iters * c.iters_per_icp
    streams, direct, kw = [], [], None
    for i in frames:
        _load_state(tracker, scene.fixture, i)
        if tracker.reinit or tracker._shape_refit_due():
            fail(f"[mesh] fixture frame {i} is no plain steady frame")
        kw_i = tracker._frame_kwargs(n_steps)
        prev = kw_i.pop("theta_prev")
        kw = kw or kw_i
        xyz = tracker._upload(tracker._pre_stride(scene.frames[i]))
        streams.append((xyz, tracker._theta, prev, tracker.com_pre))
        direct.append(_fused_frame_impl(
            tracker._ctx, tracker._ctx_fit, tracker._tree,
            tracker.model.parents, xyz, tracker._zero_labels, tracker._bg,
            tracker._intrin4, tracker._theta, tracker.com_pre,
            theta_prev=prev, **kw_i))
    stack = lambda k: torch.stack([s[k] for s in streams])
    thetas = lambda k: Theta(*(torch.stack([s[k][f] for s in streams])
                               for f in range(3)))
    labels = torch.stack([tracker._zero_labels] * len(frames))
    calls = []
    with make_mesh(1, device=scene.dev) as mesh:
        _reset_counts()
        with _recording(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sharded_track_step(
                mesh, tracker._ctx, tracker._ctx_fit, tracker._tree,
                tracker.model.parents, stack(0), labels, tracker._bg,
                tracker._intrin4, thetas(1), stack(3), kw,
                thetas_prev_b=thetas(2))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        launches = dict(nn_kernel.LAUNCHES)
    if launches["nn_argmin_ranges"] <= 0:
        fail("[mesh] the sharded track step never launched B1")
    ref, gt = scene.fixture["ref_joints"], scene.gt
    rows = []
    for s, (i, one) in enumerate(zip(frames, direct)):
        got = (*(t[s] for t in out.theta), out.labels_strided[s],
               out.host_diag[s])
        want = (*one.theta, one.labels_strided, one.host_diag)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"[mesh] stream {s} (fixture frame {i}) differs from "
                 "_fused_frame_impl called directly on it")
        tracker._theta = Theta(*got[:3])
        joints = tracker.pose()[1]
        d_ref = _joint_mm(joints, ref[i])
        if d_ref > REF_MM:
            fail(f"[mesh] stream {s}: joints {d_ref:.2f} mm from the "
                 f"reference's synced frame {i} (bound {REF_MM} mm)")
        rows.append(f"frame {i} vs reference {d_ref:.3f} mm, vs GT "
                    f"{_joint_mm(joints, gt[i]):.2f} mm")
    walls = []
    for i in frames:
        _load_state(tracker, scene.fixture, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.track(scene.frames[i])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[mesh] (c) sharded_track_step, {len(frames)} streams at "
          f"{W}x{H} over a world of one: theta, labels and host_diag of "
          f"every stream equal to _fused_frame_impl on it, to the bit; "
          + "; ".join(rows) + f"; {ms:.1f} ms per stream, "
          f"FusedTracker.track {np.mean(walls):.1f} ms per frame (the same "
          f"frames and states); kernel launches {launches}", flush=True)
    return launches, calls


def _mesh_lbs(scene):
    """(d) ``sharded_multistream_lbs`` against ``lbs_batched``."""
    import torch

    from avatar_tpu_torch.core import rotation
    from avatar_tpu_torch.core.lbs import lbs_batched
    from avatar_tpu_torch.parallel.training import (make_mesh,
                                                     sharded_multistream_lbs)

    model, dev = scene.model, scene.dev
    rng = np.random.default_rng(1)
    n = 4
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    w = t(rng.normal(0, 0.5, (n, model.num_shape_keys())))
    p = t(rng.normal(0, 0.5, (n, 3)))
    rots = rotation.so3_exp(t(rng.normal(0, 0.3, (n, 24, 3))))
    with make_mesh(1, device=dev) as mesh:
        got = sharded_multistream_lbs(mesh, model.params, model.parents, w,
                                      p, rots)
    want = lbs_batched(model.params, model.parents, w, p, rots)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("[mesh] sharded_multistream_lbs differs from lbs_batched")
    print(f"[mesh] (d) sharded_multistream_lbs of {n} poses of the "
          f"{model.num_points()}-vertex model equals lbs_batched to the bit",
          flush=True)


def phase_mesh(scene, images=TRAIN_IMAGES, depth=TRAIN_DEPTH,
               tool_images=32, tool_depth=6):
    """The multi-device layer through its entry points, over a world of one
    (NCCL on the card: one card, and NCCL puts no two ranks on one GPU).
    Returns the sharded step's B1 launches and the recorded searches'
    largest d2 error."""
    _mesh_train(scene, images, depth)
    _mesh_tool(scene, tool_images, tool_depth)
    launches, calls = _mesh_track(scene)
    _mesh_lbs(scene)
    return launches, _hold_recorded("mesh", calls, scene.dev)


# the scopes of items that every fused frame reaches, and of one LM step
FRAME_SCOPES = ("bgsub", "forest_walk", "blob_suppress", "fit")
LM_SCOPES = ("lbs", "vis", "nn", "weights", "jacobian", "gram", "solve",
             "trial", "sync")
GRAPHED_LM_SCOPES = ("lbs", "step", "sync")     # a replay is one scope
SYNC_REPORT = "called a synchronizing CUDA operation"   # PyTorch's warning
# a steady frame's reads in the scopes that label components, on the card.
# Gone with the kernel: the loop's flag reads (one before the sweeps and
# one after each, in ``bgsub/sync`` and ``blob_suppress/sync``: ~18 a fused
# frame, ~54 a host frame) and ``component_sizes``' ``bincount`` (two in
# each scope), now an integer scatter.  What stays is the CPU's pins
# (``tests/test_torch_counters.py``) less the bincount's: the host
# tracker's thresholds and mask reads in ``bgsub``, its blob filter's
# copies in ``blob_suppress``.
CARD_CC_READS = {"fused": {"bgsub": 0, "blob_suppress": 0},
                 "host": {"bgsub": 4, "blob_suppress": 6}}
def _fused_outputs(tracker):
    """Keep what every ``_run`` of ``tracker`` returns; the returned
    function reads the last one's (theta, labels, diag) as numpy arrays.
    Called after the frame, so the frame's clock holds none of these
    reads."""
    last, run = [], tracker._run

    def keep(*a, **kw):
        out = run(*a, **kw)
        last[:] = [out]
        return out

    tracker._run = keep
    return lambda: [a.cpu().numpy() for out in last for a in (
        *out.theta, out.labels_strided, out.host_diag)]


def _tracker_state(tracker) -> dict:
    """The fused tracker's per-frame state and its timer's, as numpy and
    plain values."""
    import torch

    state = {}
    for k in tracker._WARM_STATE + ("_use_bgsub",):
        v = getattr(tracker, k)
        if isinstance(v, tuple):
            v = [t.cpu().numpy() for t in v]
        elif isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        elif isinstance(v, (np.ndarray, dict)):
            v = v.copy()
        state[k] = v
    state["timer.stats"] = {k: list(v) for k, v in
                            tracker.timer.stats.items()}
    return state


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def _drive(track, frames, dev, outputs, mode: str = "plain"):
    """Track ``frames``.  Per frame: the result, wall ms (host clock to a
    synchronise) and ``outputs()``; in mode "clock" also the stage clock's
    stages and its counted reads (``reads``) per scope."""
    import torch

    from avatar_tpu_torch import profiling

    rows = []
    for frame in frames:
        clock = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "plain":
            res = track(frame)
        else:
            with profiling.stage_clock(dev) as clock:
                res = track(frame)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        stages = clock.stages if clock is not None else {}
        rows.append(dict(res=res, wall_ms=ms, out=outputs(), stages=stages,
                         syncs={k: v["counts"]["reads"]
                                for k, v in stages.items()
                                if v["counts"].get("reads")}))
    return rows


def _summary(tag, path, rows, steps="eager") -> dict:
    """One path's JSON line: per scope the medians over ``rows`` of the
    clock's elapsed ms (device timeline), host ms, entries and counted
    synchronising copies and reads; the frames' wall ms with its spread;
    and how far the scopes directly below a frame cover its own
    event-to-event ms."""
    med = lambda vals: float(np.median(vals))
    names = sorted({k for r in rows for k in r["stages"]})
    scopes = {}
    for k in names:
        per = [r["stages"].get(k, {}) for r in rows]
        scopes[k] = dict(
            {f: round(med([p.get(f, 0) for p in per]), 3)
             for f in ("elapsed_ms", "host_ms", "entries")},
            syncs=med([r["syncs"].get(k, 0) for r in rows]))
    walls = [r["wall_ms"] for r in rows]
    cover = []
    for r in rows:
        st = r["stages"]
        top = sum(v["elapsed_ms"] for v in st.values() if v["depth"] == 1)
        cover.append(top / st["frame"]["elapsed_ms"])
    line = dict(
        path=path, lm_steps=steps, frames=len(rows),
        deterministic_algorithms=True, wall_ms=round(med(walls), 3),
        wall_ms_spread=[round(min(walls), 3), round(max(walls), 3)],
        frame_elapsed_ms=scopes["frame"]["elapsed_ms"],
        scopes_cover_frame=round(med(cover), 4),
        host_syncs_per_frame=med([sum(r["syncs"].values()) for r in rows]),
        scopes=scopes)
    print(f"[{tag}] " + json.dumps(line), flush=True)
    for c in cover:
        if not 0.9 <= c <= 1.1:
            fail(f"[{tag}] {path}: the scopes' elapsed ms sum to {c:.3f} of "
                 "the frame's own event-to-event ms (bound: within 10%)")
    if line["host_syncs_per_frame"] <= 0:
        fail(f"[{tag}] {path}: no synchronising read was counted")
    return line


def _hold_reads(tag, path, tracker, track, frames, dev, eager=True):
    """Track ``frames`` from a reinit on, its LM steps uncaptured if
    ``eager``, twice: under ``profiling.counted_syncs_only()``, where a
    synchronisation outside a counted read raises at its site; then each
    frame under the stage clock with PyTorch's sync reports on
    (``set_sync_debug_mode("warn")``; a pass of its own, since a report
    costs the host far more than the read).  Fail unless each frame's
    counted ``reads`` equal the synchronisations PyTorch reports for it.
    Returns the reads per frame."""
    import warnings

    import torch

    from avatar_tpu_torch import profiling
    from avatar_tpu_torch.optim import gauss_newton

    counted = []
    with contextlib.ExitStack() as stack:
        if eager:
            stack.enter_context(gauss_newton.eager_steps())
        for strict in (True, False):
            tracker.reinit = True
            for i, frame in enumerate(frames):
                torch.cuda.synchronize()
                if strict:
                    with profiling.counted_syncs_only():
                        res = track(frame)
                else:
                    with warnings.catch_warnings(record=True) as seen:
                        warnings.simplefilter("always")
                        with profiling.stage_clock(dev) as clock:
                            torch.cuda.set_sync_debug_mode("warn")
                            try:
                                res = track(frame)
                            finally:
                                torch.cuda.set_sync_debug_mode("default")
                    # not the one-time notice that the mode is a prototype
                    reported = sum(SYNC_REPORT in str(w.message)
                                   for w in seen)
                    reads = sum(v["counts"].get("reads", 0)
                                for v in clock.stages.values())
                    if reads != reported or reported == 0:
                        fail(f"[{tag}] {path} frame {i}: {reads} counted "
                             f"reads, {reported} synchronisations reported "
                             "by PyTorch")
                    counted.append(reads)
                    if i:
                        _hold_cc_reads(tag, path, clock.stages)
                if not res.ok or res.reinitialized != (i == 0):
                    fail(f"[{tag}] {path}: witnessed frame {i} ok={res.ok}")
    print(f"[{tag}] {path}: no uncounted synchronisation, and counted reads "
          f"equal PyTorch's sync reports, on a reinit and a steady frame: "
          f"{counted}", flush=True)
    return counted


def _hold_cc_reads(tag, path, stages) -> None:
    """A steady frame labels its components with one kernel launch in each
    of ``bgsub`` and ``blob_suppress``, whose reads are ``CARD_CC_READS``',
    and reads no sweep flag."""
    want = CARD_CC_READS["host" if path.startswith("host") else "fused"]
    got = {k: stages[k]["counts"].get("reads", 0) for k in want}
    launches = {k: stages[k]["counts"].get("cc_launches", 0) for k in want}
    sweeps = sorted(set(stages) & {f"{k}/sync" for k in want})
    if got != want or set(launches.values()) != {1} or sweeps:
        fail(f"[{tag}] {path}: a steady frame's reads {got} (want {want}), "
             f"connected-components launches {launches} (want 1 each), "
             f"sweep-flag scopes {sweeps} (want none)")


def _need_scopes(tag, path, have, fits=("fit",), graphed=False):
    lm = GRAPHED_LM_SCOPES if graphed else LM_SCOPES
    want = set(FRAME_SCOPES) | {f"{f}/{s}" for f in fits for s in lm}
    want |= set(fits) if graphed else (
        {f"{f}/trial/lbs" for f in fits} | set(fits))
    missing = sorted(want - set(have))
    if missing:
        fail(f"[{tag}] {path}: scopes missing: {missing}")


def first_track(mode: str) -> None:
    """Child process of the ``stages`` phase: the wall ms of a process's
    first ``track``, cold (the kernel built into an empty directory inside
    that call) or after ``warmup`` on the same frame."""
    import tempfile
    from pathlib import Path

    import torch

    from avatar_tpu_torch.device import get_device
    from avatar_tpu_torch.optim import nn_kernel
    from avatar_tpu_torch.perception import walk_kernel

    torch.use_deterministic_algorithms(True)
    scene = Scene(get_device("cuda:0"))
    tracker = scene.tracker()
    frame = scene.frames[0]
    out = dict(mode=mode, warmup_ms=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        if mode == "cold":              # nothing built: nvcc runs
            nn_kernel._BUILD = walk_kernel._BUILD = Path(tmp)
        torch.cuda.synchronize()
        if mode == "warm":
            t0 = time.perf_counter()
            tracker.warmup(frame)
            torch.cuda.synchronize()
            out["warmup_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        res = tracker.track(frame)
        torch.cuda.synchronize()
        out["first_track_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tracker.track(scene.frames[1])
        torch.cuda.synchronize()
        out["second_track_ms"] = (time.perf_counter() - t0) * 1e3
    out["ok"] = bool(res.ok and res.reinitialized)
    out["pose"] = b"".join(t.cpu().numpy().tobytes()
                           for t in tracker._theta).hex()
    print(json.dumps(out), flush=True)


def phase_stages(scene):
    """Where a tracked frame's time goes: the stage clock over the fused
    slice (with ``warmup`` and the metrics log, as a user drives it), the
    accuracy mode and the host tracker, their LM steps uncaptured (the
    per-part view of a step), then the fused and host paths graphed.
    Returns the kernel launches of the graphed clocked fused run, the
    recorded searches' largest d2 error and, per path, the clock's summary
    for the trace phase."""
    import tempfile

    import torch

    from avatar_tpu_torch.optim import gauss_newton, nn_kernel

    dev, frames = scene.dev, scene.frames
    tag = "stages"
    lines = {}

    # warmup leaves the tracker as it was, and a warmed tracker tracks a
    # cold one's frames
    cold, warm = scene.tracker(), scene.tracker()
    before = _tracker_state(warm)
    t0 = time.perf_counter()
    warm.warmup(frames[0])
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    if not _equal(_tracker_state(warm), before):
        fail(f"[{tag}] warmup changed the tracker's state")
    warm.warmup(frames[0], batch=2)
    if not _equal(_tracker_state(warm), before):
        fail(f"[{tag}] warmup(batch=2) changed the tracker's state")
    out_c, out_w = _fused_outputs(cold), _fused_outputs(warm)
    rows_c = _drive(cold.track, frames, dev, out_c)
    with tempfile.TemporaryDirectory() as tmp:
        # the main path of this phase: warmed, logged, under the clock
        log = os.path.join(tmp, "metrics.jsonl")
        warm.open_metrics(log)
        warm.warmup(frames[0])              # must not reach the log
        calls = []
        _reset_counts()
        with _recording(calls), gauss_newton.eager_steps():
            rows_w = _drive(warm.track, frames, dev, out_w,
                            "clock")
        launches = dict(nn_kernel.LAUNCHES)
        warm.close_metrics()
        with open(log) as f:
            logged = [json.loads(ln) for ln in f]
    for i, (rc, rw) in enumerate(zip(rows_c, rows_w)):
        if not rw["res"].ok or rw["res"].reinitialized != (i == 0):
            fail(f"[{tag}] clocked frame {i}: ok={rw['res'].ok}")
        if not _equal(rc["out"], rw["out"]):
            fail(f"[{tag}] frame {i}: a warmed tracker under the stage "
                 "clock differs from a cold one without it (theta, labels "
                 "or diag)")
    if not _equal({k: v for k, v in _tracker_state(warm).items()
                   if not k.startswith(("_metrics", "timer"))},
                  {k: v for k, v in _tracker_state(cold).items()
                   if not k.startswith(("_metrics", "timer"))}):
        fail(f"[{tag}] the warmed tracker's state after the frames differs")
    keys = {"frame", "ok", "reinit", "n_points", "cost", "n_matched",
            "part_counts", "hard_overflow", "reinit_ms"}
    if [r["frame"] for r in logged] != list(range(len(frames))) or any(
            not keys <= r.keys() for r in logged) or any(
            "frame_ms" not in r for r in logged[1:]):
        fail(f"[{tag}] the metrics log has not one line per tracked frame "
             f"with the reference's keys: {logged}")
    if launches["nn_argmin_ranges"] <= 0:
        fail(f"[{tag}] the clocked path never launched nn_argmin_ranges")
    print(f"[{tag}] (LM steps uncaptured) warmup {warmup_ms:.1f} ms "
          "(reinit, steady and shape-refit variants on frame 0), state "
          "after it equal to the "
          f"state before; {len(frames)} frames of a warmed tracker under the "
          "stage clock equal a cold tracker's without it to the bit (theta, "
          f"labels, diag); metrics log {len(logged)} lines, none from "
          f"warmup; kernel launches {launches}", flush=True)
    _need_scopes(tag, "fused", rows_w[1]["stages"])
    _need_scopes(tag, "fused reinit", rows_w[0]["stages"])
    _hold_reads(tag, "fused", warm, warm.track, frames[:2], dev)
    lines["fused_reinit"] = _summary(tag, "fused_reinit", rows_w[:1])
    lines["fused_steady"] = _summary(tag, "fused_steady", rows_w[1:])
    plain = [r["wall_ms"] for r in rows_c[1:]]
    print(f"[{tag}] fused steady wall ms with no clock (the cold tracker): "
          f"median {np.median(plain):.1f}, spread {min(plain):.1f}-"
          f"{max(plain):.1f}; reinit frame {rows_c[0]['wall_ms']:.1f} "
          f"(first use of this configuration in the process); under the "
          f"clock: median {lines['fused_steady']['wall_ms']:.1f}",
          flush=True)
    max_err = _hold_recorded(tag, calls)

    # accuracy mode: every steady frame refines
    acc = dict(refine_every=1, refine_steps=2)
    a_plain, a_clock = scene.tracker(**acc), scene.tracker(**acc)
    out_p, out_k = _fused_outputs(a_plain), _fused_outputs(a_clock)
    rows_p = _drive(a_plain.track, frames, dev, out_p)
    calls = []
    with _recording(calls), gauss_newton.eager_steps():
        rows_k = _drive(a_clock.track, frames, dev, out_k,
                        "clock")
    for i, (rp, rk) in enumerate(zip(rows_p, rows_k)):
        if not rk["res"].ok or not _equal(rp["out"], rk["out"]):
            fail(f"[{tag}] accuracy frame {i}: the clocked run differs from "
                 "the plain one")
    _need_scopes(tag, "accuracy", rows_k[1]["stages"], ("fit", "refine"))
    _hold_reads(tag, "accuracy", a_clock, a_clock.track, frames[:2], dev)
    lines["accuracy_steady"] = _summary(tag, "accuracy_steady", rows_k[1:])
    plain = [r["wall_ms"] for r in rows_p[1:]]
    print(f"[{tag}] accuracy steady wall ms with no clock: median "
          f"{np.median(plain):.1f}, spread {min(plain):.1f}-"
          f"{max(plain):.1f}", flush=True)
    max_err = max(max_err, _hold_recorded(tag + " accuracy", calls))

    # the host tracker, frames as XYZ maps
    xyzs = [scene.intrin.depth_to_xyz_np(f.astype(np.float32) * 1e-3)
            for f in frames]
    h_plain, h_clock = _host_tracker(scene), _host_tracker(scene)
    host_out = lambda t: lambda: [t.ava.p.copy(), t.ava.r.copy(),
                                  t.ava.w.copy(), t.com_pre.copy()]
    rows_p = _drive(h_plain.track, xyzs, dev, host_out(h_plain))
    calls = []
    with _recording(calls), gauss_newton.eager_steps():
        rows_k = _drive(h_clock.track, xyzs, dev, host_out(h_clock), "clock")
    for i, (rp, rk) in enumerate(zip(rows_p, rows_k)):
        if not rk["res"].ok or not _equal(rp["out"], rk["out"]) or \
                not np.array_equal(rp["res"].part_mask, rk["res"].part_mask):
            fail(f"[{tag}] host frame {i}: the clocked run differs from the "
                 "plain one")
    _need_scopes(tag, "host", rows_k[1]["stages"])
    _hold_reads(tag, "host", h_clock, h_clock.track, xyzs[:2], dev)
    lines["host_steady"] = _summary(tag, "host_steady", rows_k[1:])
    plain = [r["wall_ms"] for r in rows_p[1:]]
    print(f"[{tag}] host steady wall ms with no clock: median "
          f"{np.median(plain):.1f}, spread {min(plain):.1f}-"
          f"{max(plain):.1f}", flush=True)
    max_err = max(max_err, _hold_recorded(tag + " host", calls))

    # the fused and host paths again with their LM steps graphed, as a
    # user runs them (the clocked runs above run their steps uncaptured:
    # the per-part view of a step)
    g_clock = scene.tracker()
    g_clock.warmup(frames[0])
    out_g = _fused_outputs(g_clock)
    _reset_counts()
    rows_g = _drive(g_clock.track, frames, dev, out_g,
                    "clock")
    launches = dict(nn_kernel.LAUNCHES)
    for i, (rc, rg) in enumerate(zip(rows_c, rows_g)):
        if not rg["res"].ok or not _equal(rc["out"], rg["out"]):
            fail(f"[{tag}] graphed frame {i}: the clocked run differs from "
                 "the plain one")
    if launches["nn_argmin_ranges"] <= 0:
        fail(f"[{tag}] the graphed clocked path never launched "
             "nn_argmin_ranges")
    print(f"[{tag}] {len(frames)} frames of a warmed tracker with graphed "
          f"LM steps under the stage clock equal the cold tracker's; kernel "
          f"launches {launches}", flush=True)
    _need_scopes(tag, "fused graphed", rows_g[1]["stages"], graphed=True)
    _need_scopes(tag, "fused reinit graphed", rows_g[0]["stages"],
                 graphed=True)
    lines["fused_reinit_graphed"] = _summary(
        tag, "fused_reinit_graphed", rows_g[:1], "graphed")
    lines["fused_steady_graphed"] = _summary(
        tag, "fused_steady_graphed", rows_g[1:], "graphed")
    _hold_reads(tag, "fused graphed", g_clock, g_clock.track, frames[:2],
                dev, eager=False)
    # the host tracker has no warmup: frame 0 captures the reinit fit's
    # graphs and frame 1 the steady fit's, so its steady line takes frames
    # 2-5
    h_graph = _host_tracker(scene)
    rows_hg = _drive(h_graph.track, xyzs, dev, host_out(h_graph), "clock")
    for i, (rp, rg) in enumerate(zip(rows_p, rows_hg)):
        if not rg["res"].ok or not _equal(rp["out"], rg["out"]):
            fail(f"[{tag}] graphed host frame {i}: differs from the plain "
                 "run")
    _need_scopes(tag, "host graphed", rows_hg[2]["stages"], graphed=True)
    lines["host_steady_graphed"] = _summary(
        tag, "host_steady_graphed", rows_hg[2:], "graphed")
    # its fits' graphs were captured on frames 0 and 1: the same frames
    # again reuse them
    _hold_reads(tag, "host graphed", h_graph, h_graph.track, xyzs[:2], dev,
                eager=False)

    # the graphed paths again with every walk through the plain eager
    # version: the walk before its kernel
    with _plain_walks():
        p_clock = scene.tracker()
        p_clock.warmup(frames[0])
        out_pw = _fused_outputs(p_clock)
        rows_pw = _drive(p_clock.track, frames, dev, out_pw,
                         "clock")
        h_pw = _host_tracker(scene)
        rows_hpw = _drive(h_pw.track, xyzs, dev, host_out(h_pw), "clock")
    for i, (rc, rp) in enumerate(zip(rows_c, rows_pw)):
        if not rp["res"].ok or not _equal(rc["out"], rp["out"]):
            fail(f"[{tag}] plain-walk frame {i}: differs from the kernel's "
                 "(theta, labels or diag)")
    for i, (rp, rg) in enumerate(zip(rows_p, rows_hpw)):
        if not rg["res"].ok or not _equal(rp["out"], rg["out"]):
            fail(f"[{tag}] plain-walk host frame {i}: differs from the "
                 "kernel's")
    lines["fused_steady_graphed_plain_walk"] = _summary(
        tag, "fused_steady_graphed_plain_walk", rows_pw[1:], "graphed")
    lines["host_steady_graphed_plain_walk"] = _summary(
        tag, "host_steady_graphed_plain_walk", rows_hpw[2:], "graphed")
    walk_line = {}
    for path, after, before, want in (
            ("fused_steady_graphed", rows_g[1:], rows_pw[1:], 2),
            ("host_steady_graphed", rows_hg[2:], rows_hpw[2:], 1)):
        read = lambda rows, f: float(np.median([
            r["stages"]["forest_walk"][f] if f == "elapsed_ms" else
            r["stages"]["forest_walk"]["counts"].get(f, 0) for r in rows]))
        walk_line[path] = dict(
            forest_walk_ms=dict(before=read(before, "elapsed_ms"),
                                after=read(after, "elapsed_ms")),
            walk_launches=dict(before=read(before, "walk_launches"),
                               after=read(after, "walk_launches")))
        if walk_line[path]["walk_launches"]["after"] != want or \
                walk_line[path]["walk_launches"]["before"] != 0:
            fail(f"[{tag}] {path}: walk launches per steady frame "
                 f"{walk_line[path]['walk_launches']}, want {want} after and"
                 " 0 before")
    print(f"[{tag}] forest walk per steady frame, plain eager walk (before)"
          " and kernel (after), LM steps graphed: " + json.dumps(walk_line),
          flush=True)

    # a process's first track, cold against warmed, each in a process of
    # its own
    first = {}
    for mode in ("cold", "warm"):
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--first-track",
             mode], capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            fail(f"[{tag}] the {mode} first-track process failed:\n"
                 f"{child.stdout[-2000:]}\n{child.stderr[-2000:]}")
        first[mode] = json.loads(child.stdout.strip().splitlines()[-1])
        if not first[mode]["ok"]:
            fail(f"[{tag}] the {mode} process's first track lost the body")
    if first["cold"]["pose"] != first["warm"]["pose"]:
        fail(f"[{tag}] a warmed process's pose after two frames differs "
             "from a cold process's")
    print(f"[{tag}] " + json.dumps(dict(
        first_track={m: {k: round(v, 1) for k, v in first[m].items()
                         if k.endswith("_ms")} for m in first},
        cold_means="a fresh process, the CUDA context and the model on the "
        "card, nothing else: its first track builds the kernel with nvcc "
        "into an empty directory and loads it",
        poses_equal=True)), flush=True)
    return launches, max_err, lines


def phase_trace(scene, lines):
    """``device_trace`` over a reinit frame and a few steady frames of each
    path, read back by ``trace_attribution``: the device's busy ms and its
    launches per frame by stage and scope, beside the stage clock's elapsed
    ms of ``phase_stages``.  After every other phase that times frames:
    the profiler slows every later launch of its process."""
    import tempfile

    import torch

    from avatar_tpu_torch import profiling
    from avatar_tpu_torch.optim import gauss_newton

    dev, frames = scene.dev, scene.frames
    tag = "trace"
    xyzs = [scene.intrin.depth_to_xyz_np(f.astype(np.float32) * 1e-3)
            for f in frames]
    acc = dict(refine_every=1, refine_steps=2)

    def warmed(tracker):
        tracker.warmup(frames[0])
        return tracker

    # the eager paths (LM steps uncaptured: the per-part view of a step),
    # then the graphed ones as a user runs them (the host tracker, with no
    # warmup, captures its graphs on frames 0 and 1)
    paths = (("fused_reinit", scene.tracker(), frames, 0, 1, ("fit",), 0),
             ("fused_steady", scene.tracker(), frames, 1, 5, ("fit",), 0),
             ("accuracy_steady", scene.tracker(**acc), frames, 1, 4,
              ("fit", "refine"), 0),
             ("host_steady", _host_tracker(scene), xyzs, 1, 4, ("fit",), 0),
             ("fused_reinit_graphed", warmed(scene.tracker()), frames, 0, 1,
              ("fit",), 1),
             ("fused_steady_graphed", warmed(scene.tracker()), frames, 1, 5,
              ("fit",), 1),
             ("host_steady_graphed", _host_tracker(scene), xyzs, 2, 5,
              ("fit",), 1),
             # the walk before its kernel: every walk plain and eager
             ("fused_steady_graphed_plain_walk", warmed(scene.tracker()),
              frames, 1, 5, ("fit",), 1),
             ("host_steady_graphed_plain_walk", _host_tracker(scene), xyzs,
              2, 5, ("fit",), 1))
    walk_launches = {}
    for path, tracker, seq, lo, hi, fits, graphed in paths:
        with contextlib.ExitStack() as stack:
            if not graphed:
                stack.enter_context(gauss_newton.eager_steps())
            if path.endswith("_plain_walk"):
                stack.enter_context(_plain_walks())
            for frame in seq[:lo]:
                tracker.track(frame)
            with tempfile.TemporaryDirectory() as tmp:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profiling.device_trace(tmp, dev):
                    for frame in seq[lo:hi]:
                        if not tracker.track(frame).ok:
                            fail(f"[{tag}] {path}: a traced frame lost "
                                 "track")
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / (hi - lo)
                size = sum(os.path.getsize(os.path.join(tmp, f))
                           for f in os.listdir(tmp))
                t0 = time.perf_counter()
                out = profiling.trace_attribution(tmp, hi - lo)
                parse_s = time.perf_counter() - t0
        if not out["on_device"] or out["total_ms"] <= 0:
            fail(f"[{tag}] {path}: the trace holds no device event")
        if out["total_ms"] > wall:
            fail(f"[{tag}] {path}: busy {out['total_ms']} ms per frame above "
                 f"the traced frames' wall {wall:.1f} ms")
        if abs(sum(out["stages"].values()) - out["total_ms"]) > 0.05:
            fail(f"[{tag}] {path}: the stages do not sum to total_ms")
        _need_scopes(tag, path, out["scopes"], fits, bool(graphed))
        clock = lines[path]["scopes"]
        share = {k: round(v["ms"] / clock[k]["elapsed_ms"], 4)
                 for k, v in out["scopes"].items()
                 if clock.get(k, {}).get("elapsed_ms", 0) > 0}
        print(f"[{tag}] " + json.dumps(dict(
            path=path, lm_steps="graphed" if graphed else "eager",
            frames=hi - lo, traced_wall_ms=round(wall, 3),
            busy_ms=out["total_ms"], launches=out["launches"],
            busy_share_of_traced_wall=round(out["total_ms"] / wall, 4),
            stages_busy_ms=out["stages"], scopes=out["scopes"],
            busy_over_clock_elapsed=share,
            trace_gz_bytes=size, parse_s=round(parse_s, 2))), flush=True)
        walk_launches[path] = dict(
            forest_walk=out["scopes"].get("forest_walk", {}).get("launches"),
            frame=out["launches"])
    print(f"[{tag}] launches per steady frame (the profiler's runtime and "
          "driver launch calls), the walk plain and eager (before) and its "
          "kernel (after): " + json.dumps({
              path: dict(before=walk_launches[path + "_plain_walk"],
                         after=walk_launches[path])
              for path in ("fused_steady_graphed", "host_steady_graphed")}),
          flush=True)


def main():
    if not os.path.isdir(os.path.join(ROOT, "avatar_tpu_torch")):
        fail("run from a checkout of the repository: avatar_tpu_torch/ "
             "is missing")
    dev = phase_device()
    import torch

    # reproducible runs: the scatter-adds take their deterministic kernels
    torch.use_deterministic_algorithms(True)
    from avatar_tpu_torch.perception import cc_kernel, walk_kernel

    phase_build()
    rec, search = phase_kernel(dev)
    scene = Scene(dev)
    walk_rec = phase_walk(scene)
    cc_rec = phase_cc(scene)
    walks, ccs = {}, {}

    def walked(name, fn, *a):
        """Run a phase, keeping its walk and connected-components kernel
        launches under ``name``."""
        before, before_cc = walk_kernel.LAUNCHES, cc_kernel.LAUNCHES
        out = fn(*a)
        walks[name] = walk_kernel.LAUNCHES - before
        ccs[name] = cc_kernel.LAUNCHES - before_cc
        return out

    paths = {"slice": walked("slice", phase_slice, scene)}
    paths["batch"] = walked("batch", phase_batch, scene)
    paths["graph"] = walked("graph", phase_graph, scene)
    phase_render(scene)
    paths["probe"] = phase_probe(scene)
    paths["accuracy"] = walked("accuracy", phase_accuracy, scene)
    *host, samples = walked("host", phase_host, scene)
    paths["host"] = tuple(host)
    paths["library"] = phase_library(scene, samples)
    walked("train", phase_train, scene)
    paths["tools"], paths["optim_tool"] = walked("tools", phase_tools, scene)
    paths["mesh"] = walked("mesh", phase_mesh, scene)
    *stages, lines = walked("stages", phase_stages, scene)
    paths["stages"] = tuple(stages)
    for name in ("slice", "batch", "graph", "accuracy", "host", "train",
                 "tools", "mesh", "stages"):
        if walks[name] <= 0:
            fail(f"the {name} phase walked no forest through the kernel")
    for name in ("slice", "host", "stages"):
        if ccs[name] <= 0:
            fail(f"the {name} phase labelled no components through the "
                 "kernel")
    # every recorded launch of each path was held against the plain
    # version, to the last bit
    path_err = max(out[-1] for out in paths.values())
    phase_profile(search)
    phase_trace(scene, lines)

    kernels = []
    for name, replaces, key in (
            ("nn_argmin_ranges", "avatar_tpu/optim/nn_pallas.py:123",
             ("nn_argmin_ranges", 8192)),
            ("nn_argmin", "avatar_tpu/optim/nn_pallas.py:170",
             ("nn_argmin", "8192 unplanned"))):
        by_path = {p: out[0][name] for p, out in paths.items()}
        if not any(by_path.values()):
            fail(f"{name} was launched on no path")
        r = rec[key]
        err = max([v["max_abs_err"] for (n, _), v in rec.items()
                   if n == name] + [path_err])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "avatar_tpu_torch/csrc/nn_argmin.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": r["ms"], "device_ms": r["device_ms"],
            "host_us": r["host_us"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "n_rows": 8192,
            "model_slots": 6656 if name == "nn_argmin_ranges" else 7168})
    r = walk_rec["bucket"]
    kernels.append({
        "name": "forest_walk", "route": "cuda",
        "source": "avatar_tpu_torch/csrc/forest_walk.cu",
        "replaces": None, "launches": sum(walks.values()),
        "launches_by_path": walks, "max_abs_err": 0,
        "ms": r["ms"], "device_ms": r["device_ms"], "host_us": r["host_us"],
        "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "pixels": r["pixels"], "cases": walk_rec})
    r = cc_rec["fused_blob_suppress"]
    kernels.append({
        "name": "cc_label", "route": "cuda",
        "source": "avatar_tpu_torch/csrc/cc_label.cu",
        "replaces": None, "launches": sum(ccs.values()),
        "launches_by_path": ccs, "max_abs_err": 0,
        "ms": r["ms"], "device_ms": r["device_ms"], "host_us": r["host_us"],
        "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "pixels": r["pixels"], "cases": cc_rec})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--first-track"]:
        first_track(sys.argv[2])
    else:
        main()
