"""The stage clock's counters (``profiling.count``, ``host_read``,
``host_sync``) and the trackers' frame root, at the tests' small size
(256x256, the detail-2 model, the committed 3-tree forest, background
subtraction, the tracked window and the wildcard channel), and on the card
that every synchronisation of a tracked frame is a counted read.

Imports no JAX: on the card

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_counters.py
"""

import contextlib
import time
import warnings

import numpy as np
import pytest
import torch

from avatar_tpu_torch import profiling
from avatar_tpu_torch.core.model import Avatar
from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.optim import gauss_newton
from avatar_tpu_torch.perception import walk_kernel
from avatar_tpu_torch.perception.partgroups import SMPL24_GROUP_LUT
from avatar_tpu_torch.perception.rtree import RTree, walk_pixels
from avatar_tpu_torch.render.renderer import AvatarRenderer
from avatar_tpu_torch.testing import synthetic_model
from avatar_tpu_torch.tracking import Tracker, TrackerConfig
from avatar_tpu_torch.tracking_fused import FusedTracker

H = W = 256
INTRIN = dict(fx=606.438, fy=606.351, cx=128.0, cy=128.0)
WALL = 6.0
FORESTS = [f"data/bench_forest_r5{s}.srtr" for s in ("", "_1", "_2")]
FUSED_CFG = dict(data_interval=3, min_points=300, rtree_interval=3,
                 frame_icp_iters=1, reinit_icp_iters=1, initial_icp_iters=1,
                 iters_per_icp=3, label_conf_thresh=0.55, beta_pose=0.3,
                 seg_window=(252, 210), part_groups=tuple(SMPL24_GROUP_LUT))
HOST_CFG = dict(data_interval=3, min_points=300, rtree_interval=3,
                iters_per_icp=2, initial_icp_iters=1)
# the reads of a steady fused frame outside the per-sweep and per-step
# flags: the upload; bincount's two in each of bgsub and blob_suppress;
# the walk's background label; the window's origin; the diagnostics; and
# limb recovery's part map
FUSED_STEADY_READS = {"upload": 1, "bgsub": 2, "glue/walk_setup": 1,
                      "forest_walk/sync": 1, "blob_suppress": 2,
                      "diag_read": 1, "glue/update": 1}
# a steady host frame's: the XYZ map and background, the thresholds and
# the two mask reads; the forest's depth upload and labels read; the blob
# filter's four copies, its threshold and bincount's two; the fit's five
# uploads, three pose reads, four diagnostics and Avatar.update's six
HOST_STEADY_READS = {"bgsub/upload": 2, "bgsub": 6, "forest_walk": 2,
                     "blob_suppress": 8, "fit": 18}
SWEEPS = ("bgsub/sync", "blob_suppress/sync", "fit/sync")


def _frames(model, intrin, n=3):
    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 4.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    frames = []
    for _ in range(n):
        gt.update()
        depth = AvatarRenderer(gt, intrin).render_depth((H, W))
        frames.append((np.where(depth > 0, depth, WALL) * 1000).astype(
            np.uint16))
        gt.p = gt.p + np.array([0.02, 0.0, 0.01])
    return frames


@pytest.fixture(scope="module")
def scene():
    model = synthetic_model(detail=2, device="cpu")
    intrin = CameraIntrin(**INTRIN)
    trees = [RTree(p, device="cpu") for p in FORESTS]
    for t in trees:
        t.partmap_type = 0
    return model, intrin, trees, _frames(model, intrin)


def _fused(model, intrin, trees):
    tracker = FusedTracker(model, intrin, (H, W), rtree=trees,
                           config=TrackerConfig(**FUSED_CFG))
    tracker.set_background(np.full((H, W), WALL, np.float32))
    return tracker


def _host(model, intrin, tree):
    tracker = Tracker(model, intrin, (H, W), rtree=tree,
                      config=TrackerConfig(**HOST_CFG))
    tracker.set_background(intrin.depth_to_xyz_np(
        np.full((H, W), WALL, np.float32)))
    return tracker


def _xyz(intrin, frame):
    return intrin.depth_to_xyz_np(frame.astype(np.float32) * 1e-3)


def _reads(stages) -> dict:
    return {k: v["counts"]["reads"] for k, v in stages.items()
            if v["counts"].get("reads")}


def test_count_goes_to_the_innermost_open_scope():
    """With no clock a count records nothing; under one it goes to the
    innermost open scope (its own counts, not its children's), or to
    ``UNSCOPED`` outside every scope; a scope that counted nothing has
    empty counts."""
    profiling.count("steps", 5)            # no clock: nothing to record to
    with profiling.stage_clock("cpu") as clock:
        profiling.count("reads", 2)
        with profiling.scope("frame"):
            with profiling.scope("fit"):
                profiling.count("steps")
                with profiling.scope("sync"):
                    profiling.count("steps", 2)
                profiling.count("steps")
            with profiling.scope("fit"):
                profiling.count("steps", 0.5)
        with profiling.unclocked():
            profiling.count("steps", 100)
    st = clock.stages
    assert st["fit"]["counts"] == {"steps": 2.5}
    assert st["fit/sync"]["counts"] == {"steps": 2}
    assert st["frame"]["counts"] == {}
    assert st[profiling.UNSCOPED] == dict(elapsed_ms=0.0, host_ms=0.0,
                                          entries=0, depth=0,
                                          counts={"reads": 2})
    with profiling.stage_clock("cpu") as clock:
        with profiling.scope("fit"):
            pass
    assert profiling.UNSCOPED not in clock.stages


def test_host_read_returns_the_plain_read_and_counts(monkeypatch):
    """``host_read`` gives what ``.cpu().numpy()`` gives and ``to_device``
    what ``torch.as_tensor`` gives; they and ``host_sync`` count their
    reads and blocked ms in the enclosing scope, open no scope, and enter
    the profiler's ``READ_SPAN`` while a profiler records."""
    spans = []
    real = torch.profiler.record_function

    class spy(real):
        def __init__(self, name, *a):
            spans.append(name)
            super().__init__(name, *a)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    flags = torch.tensor([True, False])
    assert np.array_equal(profiling.host_read(t), t.cpu().numpy())
    up = profiling.to_device(np.arange(3), "cpu", torch.float32)
    assert up.dtype == torch.float32 and up.tolist() == [0.0, 1.0, 2.0]
    assert not spans                       # no profiler: no span
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert profiling.host_read(flags).tolist() == flags.tolist()
        assert bool(profiling.host_read(flags.any())) is bool(flags.any())
    assert spans == [profiling.READ_SPAN] * 2
    with profiling.stage_clock("cpu") as clock:
        with profiling.scope("sync"):
            got = profiling.host_read(t)
            with profiling.host_sync(2):
                time.sleep(0.002)
        profiling.host_read(flags)
    assert np.array_equal(got, t.numpy())
    st = clock.stages
    assert set(st) == {"sync", profiling.UNSCOPED}
    assert st["sync"]["counts"]["reads"] == 3
    assert st["sync"]["counts"]["read_ms"] >= 2.0
    assert st["sync"]["host_ms"] >= st["sync"]["counts"]["read_ms"]
    assert st[profiling.UNSCOPED]["counts"]["reads"] == 1


def _walk_launches(stages) -> int:
    return sum(v["counts"].get("walk_launches", 0) for v in stages.values())


def test_cpu_walks_launch_no_kernel(scene):
    """A walk of CPU tensors takes the plain version: ``walk_pixels`` over
    a stacked range and ``RTree.predict_best`` leave
    ``walk_kernel.LAUNCHES`` and the ``walk_launches`` count untouched."""
    _, _, trees, frames = scene
    depth = frames[1].astype(np.float32) * 1e-3
    before = walk_kernel.LAUNCHES
    with profiling.stage_clock("cpu") as clock:
        with profiling.scope("forest_walk"):
            labels = trees[0].predict_best(depth, interval=3)
            t = trees[0]._tree
            ys = torch.arange(64)
            walk_pixels(t, ys, ys, torch.full((64,), 2.0),
                        torch.ones(64, dtype=torch.bool),
                        torch.as_tensor(depth.reshape(-1)), (H, W),
                        trees[0]._max_depth, (0, 0), (W - 1, H - 1))
    assert (labels != 255).any()
    assert walk_kernel.LAUNCHES == before
    assert clock.stages["forest_walk"]["entries"] == 1
    assert _walk_launches(clock.stages) == 0


def test_fused_frames_count_steps_and_reads(scene):
    """A reinit and two steady fused frames under the clock: one ``frame``
    root per track call holding ``upload`` and ``diag_read``, with the
    stages at the paths they had; ``fit``'s ``steps`` equal its
    ``fit/sync`` entries; every flag scope one read per entry, and the
    steady frames' reads pinned; the CPU's walks launch no kernel."""
    model, intrin, trees, frames = scene
    tracker = _fused(model, intrin, trees)
    launches = walk_kernel.LAUNCHES
    totals = []
    for i, frame in enumerate(frames):
        with profiling.stage_clock("cpu") as clock:
            res = tracker.track(frame)
        assert res.ok and res.reinitialized == (i == 0)
        st = clock.stages
        assert st["frame"]["entries"] == 1 and st["frame"]["depth"] == 0
        for name in ("upload", "diag_read", "bgsub", "forest_walk",
                     "blob_suppress", "fit", "glue/update"):
            assert st[name]["depth"] == 1, name
        assert st["fit/nn"]["depth"] == 2
        fit = st["fit"]["counts"]
        assert fit["steps"] == st["fit/sync"]["entries"] > 0
        reads = _reads(st)
        for name in SWEEPS:
            assert reads[name] == st[name]["entries"], name
        assert profiling.UNSCOPED not in st
        assert _walk_launches(st) == 0
        totals.append(sum(reads.values()))
        if i:                     # the tracked window's origin is read
            assert st["forest_walk/sync"]["depth"] == 2
            assert {k: v for k, v in reads.items()
                    if k not in SWEEPS} == FUSED_STEADY_READS
            assert sum(v["counts"]["read_ms"] for v in st.values()
                       if "read_ms" in v["counts"]) <= st["frame"]["host_ms"]
    assert totals[1:] == [22, 22]
    assert walk_kernel.LAUNCHES == launches


def test_host_frames_count_steps_and_reads(scene):
    """The host tracker's reinit and steady frames: the XYZ map's upload
    in ``bgsub/upload``, ``fit``'s steps as on the fused path, and the
    steady frames' reads pinned."""
    model, intrin, trees, frames = scene
    tracker = _host(model, intrin, trees[0])
    totals = []
    for i, frame in enumerate(frames):
        with profiling.stage_clock("cpu") as clock:
            res = tracker.track(_xyz(intrin, frame))
        assert res.ok and res.reinitialized == (i == 0)
        st = clock.stages
        assert st["frame"]["entries"] == st["bgsub/upload"]["entries"] == 1
        fit = st["fit"]["counts"]
        assert st["fit"]["entries"] == 1
        assert fit["steps"] == st["fit/sync"]["entries"] > 0
        reads = _reads(st)
        for name in SWEEPS:
            assert reads[name] == st[name]["entries"], name
        totals.append(sum(reads.values()))
        if i:
            assert {k: v for k, v in reads.items()
                    if k not in SWEEPS} == HOST_STEADY_READS
        else:                  # the reinit's Avatar.update at the root
            assert reads["frame"] == 6
    assert totals == [63, 56, 55]


def test_batch_and_async_frames_have_one_root_each(scene):
    """``track_async`` opens one ``frame`` root per call, ``track_batch``
    one per frame of the batch (the head frame's through ``track``), and
    ``flush`` none."""
    model, intrin, trees, frames = scene
    tracker = _fused(model, intrin, trees)
    with profiling.stage_clock("cpu") as clock:
        tracker.track_async(frames[0])          # lost: through track
        for frame in frames[1:]:
            tracker.track_async(frame)
        tracker.flush()
    assert clock.stages["frame"]["entries"] == len(frames)
    assert clock.stages["upload"]["entries"] == len(frames)
    assert clock.stages["fit"]["counts"]["steps"] == \
        clock.stages["fit/sync"]["entries"]
    tracker = _fused(model, intrin, trees)
    with profiling.stage_clock("cpu") as clock:
        assert len(tracker.track_batch(frames)) == len(frames)
    assert clock.stages["frame"]["entries"] == len(frames)
    assert clock.stages["fit"]["entries"] == \
        len(frames) - 1 + tracker.config.reinit_seeds


def test_frames_under_the_clock_equal_frames_without_it(scene):
    """Counting changes no result: the fused and host trackers' poses
    after three frames under the clock equal those without it, to the
    bit."""
    model, intrin, trees, frames = scene
    runs = []
    for clocked in (False, True):
        fused, host = _fused(model, intrin, trees), _host(model, intrin,
                                                          trees[0])
        for frame in frames:
            if clocked:
                with profiling.stage_clock("cpu"):
                    fused.track(frame)
                    host.track(_xyz(intrin, frame))
            else:
                fused.track(frame)
                host.track(_xyz(intrin, frame))
        runs.append((fused._theta, fused.com_pre, host.ava.p, host.ava.r,
                     host.com_pre))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][1], runs[1][1])
    for a, b in zip(runs[0][2:], runs[1][2:]):
        assert np.array_equal(a, b)


def _syncs_reported(run) -> int:
    """The synchronisations PyTorch reports while ``run`` runs
    (``set_sync_debug_mode("warn")``)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # PyTorch's report of a sync; its one-time notice that the debug mode
    # is a prototype also speaks of synchronizing, and is no sync
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in seen)


@pytest.fixture(scope="module")
def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: synchronisations exist only there")
    dev = torch.device("cuda")
    model = synthetic_model(detail=2, device=dev)
    intrin = CameraIntrin(**INTRIN)
    trees = [RTree(p, device=dev) for p in FORESTS]
    for t in trees:
        t.partmap_type = 0
    return dev, model, intrin, trees, _frames(model, intrin, 4)


def _card_calls(path, dev, model, intrin, trees, frames):
    """The tracker of ``path`` and its calls from a reinit on: each call
    tracks one frame (a batch: its frames) and returns the results it
    resolved, each of which must be ok."""
    seq = frames[1:]
    if path.startswith("host"):
        # the demo's forest as it is stored: its own part map type
        tracker = _host(model, intrin, RTree(FORESTS[0], device=dev))
        xyzs = [_xyz(intrin, f) for f in seq]
        return tracker, [lambda x=x: [tracker.track(x)] for x in xyzs]
    cfg = dict(FUSED_CFG, refine_every=1, refine_steps=2) \
        if path == "accuracy" else FUSED_CFG
    tracker = FusedTracker(model, intrin, (H, W), rtree=trees,
                           config=TrackerConfig(**cfg))
    tracker.set_background(np.full((H, W), WALL, np.float32))
    tracker.warmup(frames[0], batch=2 if path == "batch" else 0)
    if path == "batch":
        return tracker, [lambda: tracker.track_batch(seq[:2]),
                         lambda: tracker.track_batch(seq[1:])]
    if path == "async":
        one = lambda r: [r] if r is not None else []
        return tracker, [lambda x=x: one(tracker.track_async(x))
                         for x in seq] + [lambda: one(tracker.flush())]
    return tracker, [lambda x=x: [tracker.track(x)] for x in seq]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "fused_eager", "accuracy",
                                  "batch", "async", "host", "host_eager"])
def test_every_sync_of_a_frame_is_a_counted_read(card_scene, monkeypatch,
                                                 path):
    """On the card, every path of both trackers from a reinit on: the
    fused tracker warmed (its LM steps graphed or, ``_eager``, uncaptured;
    accuracy mode refining every steady frame; ``track_batch``;
    ``track_async`` and ``flush``), the host tracker after a first pass
    that captures its fits' graphs.  Under ``counted_syncs_only()`` any
    synchronisation outside a counted read raises; a pass in warn mode
    under the clock then holds each call's ``reads`` equal to the
    synchronisations PyTorch reports for it, and counts the forest walk's
    kernel launches of each steady frame: two on the fused tracker (tree 0
    over the bucket, trees 1-2 over its hard pixels), one on the host
    tracker; and the connected-components kernel's, two on every tracker
    (``bgsub``, ``blob_suppress``), whose sweeps read nothing."""
    # the clocks' pooled events stay with this test, not with the process
    monkeypatch.setattr(profiling, "_event_pool", [])
    dev = card_scene[0]
    tracker, calls = _card_calls(path, *card_scene)
    eager = gauss_newton.eager_steps if path.endswith("_eager") else \
        contextlib.nullcontext
    with eager():
        for mode in ("first", "strict", "witness"):
            if path == "async" and mode != "first":
                # a reinit forced after flush() loses the body at this
                # size: each pass starts from a fresh tracker
                tracker, calls = _card_calls(path, *card_scene)
            tracker.reinit = True
            torch.cuda.synchronize()
            for i, call in enumerate(calls):
                out = []
                if mode == "first":
                    out.extend(call())
                elif mode == "strict":
                    with profiling.counted_syncs_only():
                        out.extend(call())
                else:
                    with profiling.stage_clock(dev) as clock:
                        n = _syncs_reported(lambda: out.extend(call()))
                    reads = sum(_reads(clock.stages).values())
                    assert reads == n > 0, (path, i, _reads(clock.stages))
                    if i and path not in ("batch", "async"):
                        walks = clock.stages["forest_walk"]["counts"]
                        assert walks["walk_launches"] == (
                            1 if path.startswith("host") else 2), path
                        st = clock.stages
                        assert [st[k]["counts"].get("cc_launches", 0)
                                for k in ("bgsub", "blob_suppress")] == \
                            [1, 1], path
                        assert not set(st) & {"bgsub/sync",
                                              "blob_suppress/sync"}, path
                assert all(r.ok for r in out), (path, mode, i)
            torch.cuda.synchronize()
