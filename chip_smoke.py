#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; imports nothing of JAX.  Phases, one line
each (any failure exits non-zero and prints no result):

1. device — the card's name and power limit from nvidia-smi;
2. build — compiles the hand-written kernel (avatar_tpu_torch/csrc/
   nn_argmin.cu) from the checkout;
3. kernel — the kernel against its plain PyTorch version at the fit's
   shapes (N = 8192 steady state and 32768 reinit rows, 6656 model slots,
   14 groups, wildcards and padding): indices equal, d2 within rtol 1e-6,
   ranged (the main path's) and full-range; CUDA-event times, median of 20;
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

The kernel counts are reset before each main path (phases 4, 6 and 7) and
read after it.  The line before the last is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# cuBLAS needs a fixed workspace for deterministic results; set before
# torch initializes CUDA
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_720p.npz")
REFINE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                              "torch_port_720p_refine.npz")
FORESTS = [os.path.join(ROOT, "data", f"bench_forest_r5{s}.srtr")
           for s in ("", "_1", "_2")]
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

    t0 = time.perf_counter()
    log = nn_kernel.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] nn_argmin.cu built in {time.perf_counter() - t0:.2f} s; "
          + " | ".join(ptxas), flush=True)


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
    from avatar_tpu_torch.optim import nn_kernel
    from avatar_tpu_torch.perception.partgroups import SMPL24_NUM_GROUPS
    from avatar_tpu_torch.testing import synthetic_nn_inputs

    wild = SMPL24_NUM_GROUPS
    rec = {}
    for n_rows in (8192, 32768):
        args = synthetic_nn_inputs(n_rows, seed=n_rows, device=dev)
        # B2 (full range) at chunk 512: 6656 slots are not a multiple of
        # the reference's 1024, and the tie rule makes the result
        # independent of the chunk
        for name, fn, ref_fn, a in (
                ("nn_argmin_ranges", nn_kernel.nn_argmin_ranges,
                 nn_kernel.nn_argmin_ranges_ref, args),
                ("nn_argmin", nn_kernel.nn_argmin, nn_kernel.nn_argmin_ref,
                 args[:5])):
            kw = dict(wild=wild, chunk=512)
            got = fn(*a, **kw)
            ref = ref_fn(*a, **kw)
            max_abs, rel = _compare(name, got, ref, n_rows)
            ms = _time_ms(lambda: fn(*a, **kw))
            plain_ms = _time_ms(lambda: ref_fn(*a, **kw))
            matched = int((got[1] >= 0).sum())
            print(f"[kernel] {name} N={n_rows} Pp={a[2].shape[0]}: indices "
                  f"equal ({matched} matched), d2 max abs err {max_abs:.3g}, "
                  f"max rel {rel:.3g}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (CUDA events, median of 20)",
                  flush=True)
            rec[(name, n_rows)] = dict(max_abs_err=max_abs, ms=ms,
                                       plain_ms=plain_ms)
    return rec


def _reset_counts() -> None:
    from avatar_tpu_torch.optim import nn_kernel

    nn_kernel.LAUNCHES.update(dict.fromkeys(nn_kernel.LAUNCHES, 0))


@contextlib.contextmanager
def _recording(calls: list):
    """Append a copy of the inputs of every ``nn_argmin_ranges`` call made
    inside the block to ``calls``: the tensors a path hands the kernel."""
    from avatar_tpu_torch.optim import nn_kernel

    real = nn_kernel.nn_argmin_ranges

    def record(*args, **kw):
        calls.append(([a.clone() if hasattr(a, "clone") else a
                       for a in args], dict(kw)))
        return real(*args, **kw)

    nn_kernel.nn_argmin_ranges = record
    try:
        yield
    finally:
        nn_kernel.nn_argmin_ranges = real


def _hold_recorded(tag: str, calls: list) -> float:
    """The kernel against its plain version on every recorded input.
    Returns the largest d2 abs error."""
    from avatar_tpu_torch.optim import nn_kernel

    if not calls:
        fail(f"[{tag}] no nn_argmin_ranges call recorded")
    worst, shapes = 0.0, set()
    for args, kw in calls:
        kw.pop("_name", None)
        n = args[0].shape[0]
        got = nn_kernel.nn_argmin_ranges(*args, **kw)
        ref = nn_kernel.nn_argmin_ranges_ref(*args, **kw)
        worst = max(worst, _compare(f"[{tag}] recorded", got, ref, n)[0])
        shapes.add((n, args[2].shape[0], kw.get("wild")))
    print(f"[{tag}] kernel vs plain on the inputs of its {len(calls)} "
          f"launches (N, Pp, wild: {sorted(shapes)}): indices equal, d2 max "
          f"abs err {worst:.3g}", flush=True)
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
    max_err = _hold_recorded(tag, calls)
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
    return launches, step_ms, _hold_recorded("probe", calls)


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


def main():
    if not os.path.isdir(os.path.join(ROOT, "avatar_tpu_torch")):
        fail("run from a checkout of the repository: avatar_tpu_torch/ "
             "is missing")
    dev = phase_device()
    import torch

    # reproducible runs: the scatter-adds take their deterministic kernels
    torch.use_deterministic_algorithms(True)
    phase_build()
    rec = phase_kernel(dev)
    scene = Scene(dev)
    paths = {"slice": phase_slice(scene)}
    phase_render(scene)
    paths["probe"] = phase_probe(scene)
    paths["accuracy"] = phase_accuracy(scene)
    # the paths launch only nn_argmin_ranges; their recorded inputs are
    # held against its plain version
    path_err = max(out[-1] for out in paths.values())

    kernels = []
    for name, replaces in (
            ("nn_argmin_ranges", "avatar_tpu/optim/nn_pallas.py:121"),
            ("nn_argmin", "avatar_tpu/optim/nn_pallas.py:170")):
        by_path = {p: out[0][name] for p, out in paths.items()}
        r = rec[(name, 8192)]
        err = max(v["max_abs_err"] for (n, _), v in rec.items() if n == name)
        if name == "nn_argmin_ranges":
            err = max(err, path_err)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "avatar_tpu_torch/csrc/nn_argmin.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "n_rows": 8192})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
