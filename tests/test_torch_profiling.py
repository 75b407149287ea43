"""The port's ``profiling.py`` on the CPU: the timers beside the JAX
package's, the stage clock and the trace attribution over tracked frames
at a small size (256x256, the detail-2 model, the committed 3-tree forest,
background subtraction, the tracked window and the wildcard channel).

Counts are exact: a scope's entries equal the calls of what it wraps
(``nn`` the searches, ``solve`` the Cholesky factorizations, ``sync`` the
LM steps).  Frames tracked under the clock equal frames tracked without
it to the bit.  Times are only held to be positive and, for the trace, to
sum: the stage buckets add up to ``total_ms`` within 0.01 ms of rounding.
"""

import time

import numpy as np
import pytest
import torch

from avatar_tpu import profiling as jprofiling
from avatar_tpu_torch import profiling
from avatar_tpu_torch.core.model import Avatar
from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.optim import nn_kernel
from avatar_tpu_torch.perception.partgroups import SMPL24_GROUP_LUT
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.render.renderer import AvatarRenderer
from avatar_tpu_torch.testing import synthetic_model
from avatar_tpu_torch.tracking import Tracker, TrackerConfig
from avatar_tpu_torch.tracking_fused import FusedTracker

H = W = 256
INTRIN = dict(fx=606.438, fy=606.351, cx=128.0, cy=128.0)
WALL = 6.0
FORESTS = [f"data/bench_forest_r5{s}.srtr" for s in ("", "_1", "_2")]
CFG = dict(data_interval=3, min_points=300, rtree_interval=3,
           frame_icp_iters=1, reinit_icp_iters=1, initial_icp_iters=1,
           iters_per_icp=3, label_conf_thresh=0.55, beta_pose=0.3,
           seg_window=(252, 210), part_groups=tuple(SMPL24_GROUP_LUT),
           refine_every=2, refine_steps=2)
# the scopes of one LM step, below ``fit`` and below ``refine``
LM_SCOPES = ("plan", "lbs", "vis", "nn", "weights", "cost", "jacobian",
             "gram", "solve", "trial", "trial/lbs", "sync")
FRAME_SCOPES = ("bgsub", "bgsub/sync", "forest_walk", "forest_walk/sync",
                "blob_suppress", "fit", "glue/xyz", "glue/centroids",
                "glue/splat", "glue/sample", "glue/diag")


@pytest.fixture(scope="module")
def scene():
    """The model, the forest and three uint16 frames of a moving avatar in
    front of a wall, rendered by the port."""
    model = synthetic_model(detail=2, device="cpu")
    intrin = CameraIntrin(**INTRIN)
    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 4.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    frames = []
    for _ in range(3):
        gt.update()
        depth = AvatarRenderer(gt, intrin).render_depth((H, W))
        frames.append((np.where(depth > 0, depth, WALL) * 1000).astype(
            np.uint16))
        gt.p = gt.p + np.array([0.02, 0.0, 0.01])
    trees = [RTree(p, device="cpu") for p in FORESTS]
    for t in trees:
        t.partmap_type = 0
    return model, intrin, trees, frames


def _tracker(scene):
    model, intrin, trees, _ = scene
    tracker = FusedTracker(model, intrin, (H, W), rtree=trees,
                           config=TrackerConfig(**CFG))
    tracker.set_background(np.full((H, W), WALL, np.float32))
    return tracker


def _count_calls(monkeypatch, owner, name):
    calls = []
    real = getattr(owner, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(owner, name, spy)
    return calls


def test_timers_return_the_reference_keys(monkeypatch):
    """``time_jitted`` and ``time_amortized`` of both packages on one
    function that takes 2 ms: equal keys, and every time between 2 ms and
    50 ms."""
    fn = lambda x: time.sleep(0.002) or x
    for name, kw in (("time_jitted", {}), ("time_amortized", {})):
        ref = getattr(jprofiling, name)(fn, np.ones(3), iters=5, warmup=1,
                                        **kw)
        got = getattr(profiling, name)(fn, np.ones(3), iters=5, warmup=1,
                                       device="cpu", **kw)
        assert set(got) == set(ref), name
        assert got["iters"] == ref["iters"] == 5
        for k in set(got) - {"iters"}:
            assert 2.0 <= got[k] < 50.0 and 2.0 <= ref[k] < 50.0, (name, k)
    assert set(profiling.time_jitted(fn, 0, iters=2, device="cpu")) == {
        "mean_ms", "min_ms", "p50_ms", "iters"}
    assert set(profiling.time_amortized(fn, 0, iters=2, device="cpu")) == {
        "ms", "iters"}
    # the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.time_jitted(fn, 0)


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: elapsed time is the number of
    events recorded between the two."""
    made = 0
    clock = 0

    def __init__(self):
        type(self).made += 1
        self.at = None

    def record(self):
        type(self).clock += 1
        self.at = type(self).clock

    def elapsed_time(self, other):
        return float(other.at - self.at)


def test_scope_allocates_events_only_under_a_clock(monkeypatch):
    """With no clock active a scope makes no event; under a clock on a
    card it makes two per entry, reads them after the one synchronise, and
    a second clock reuses them."""
    syncs = []
    monkeypatch.setattr(profiling, "_new_event", _FakeEvent)
    monkeypatch.setattr(profiling, "_synchronize", syncs.append)
    monkeypatch.setattr(profiling, "get_device", torch.device)
    monkeypatch.setattr(profiling, "_event_pool", [])
    _FakeEvent.made = _FakeEvent.clock = 0

    def work():
        with profiling.scope("frame"):
            for _ in range(3):
                with profiling.scope("fit"):
                    with profiling.scope("nn"):
                        pass

    work()
    assert _FakeEvent.made == 0 and not syncs
    with profiling.stage_clock("cuda") as clock:
        work()
        assert not syncs and not clock.stages      # nothing read inside
    assert _FakeEvent.made == 2 * 7 and len(syncs) == 1
    assert {k: v["entries"] for k, v in clock.stages.items()} == {
        "frame": 1, "fit": 3, "fit/nn": 3}
    assert [clock.stages[k]["depth"] for k in ("frame", "fit", "fit/nn")] == \
        [0, 1, 2]
    # nested scopes nest: nn's two events lie between fit's, fit's in frame's
    assert clock.stages["fit/nn"]["elapsed_ms"] == 3 * 1.0
    assert clock.stages["fit"]["elapsed_ms"] == 3 * 3.0
    assert clock.stages["frame"]["elapsed_ms"] == 13.0
    with profiling.stage_clock("cuda"):
        work()
    assert _FakeEvent.made == 2 * 7, "the second clock reuses the pool"
    with profiling.stage_clock("cuda"):
        with pytest.raises(RuntimeError, match="already active"):
            with profiling.stage_clock("cuda"):
                pass
    work()
    assert _FakeEvent.made == 2 * 7


def test_stage_clock_over_tracked_frames(scene, monkeypatch):
    """A reinit, a steady and a refine frame under the clock: every scope
    the frames reach is there, with the entry counts the LM steps imply,
    and the frames equal those of a tracker with no clock to the bit."""
    frames = scene[3]
    plain = _tracker(scene)
    results = [plain.track(f) for f in frames]
    searches = _count_calls(monkeypatch, nn_kernel, "nn_match")
    factorizations = _count_calls(monkeypatch, torch.linalg, "cholesky_ex")
    tracker = _tracker(scene)
    clocks = []
    for i, frame in enumerate(frames):
        del searches[:], factorizations[:]
        with profiling.stage_clock("cpu") as clock:
            res = tracker.track(frame)
        clocks.append(clock)
        st = clock.stages
        assert (res.ok, res.reinitialized, res.n_points, res.fit_info) == (
            results[i].ok, results[i].reinitialized, results[i].n_points,
            results[i].fit_info)
        refine = i == 2                      # refine_every=2: _frame_no 2
        fits = ("fit", "refine") if refine else ("fit",)
        want = set(FRAME_SCOPES) | {f"{f}/{s}" for f in fits
                                    for s in LM_SCOPES} | {"frame",
                                                            "diag_read"}
        if refine:
            want |= {"refine", "refine/surface"}
        if i == 0:                           # no window, no splat work
            want -= {"forest_walk/sync"}
        missing = want - set(st)
        assert not missing, f"frame {i}: {sorted(missing)}"
        steps = sum(st[f"{f}/sync"]["entries"] for f in fits)
        assert steps == len(factorizations) > 0
        assert sum(st[f"{f}/nn"]["entries"] for f in fits) == len(searches)
        # the reinit runs the frame once per seed
        runs = tracker.config.reinit_seeds if i == 0 else 1
        for f in fits:
            n = st[f"{f}/sync"]["entries"]
            assert runs <= n <= (2 if f == "refine" else 3) * runs
            assert st[f"{f}/solve"]["entries"] == n
            assert st[f"{f}/trial"]["entries"] == n
            assert st[f"{f}/trial/lbs"]["entries"] == n
            # one linearization to start with, one more per accepted step
            lin = st[f"{f}/nn"]["entries"]
            assert runs <= lin <= n
            for s in ("vis", "weights", "cost", "jacobian", "gram"):
                assert st[f"{f}/{s}"]["entries"] == lin, s
            assert st[f"{f}/lbs"]["entries"] == st[f]["entries"] == runs
            assert st[f"{f}/plan"]["entries"] == runs
        assert st["frame"]["entries"] == st["bgsub"]["entries"] == runs
        assert st["diag_read"]["entries"] == runs
        assert st["frame"]["depth"] == 0 and st["fit"]["depth"] == 1
        assert st["fit/trial/lbs"]["depth"] == 3
        for name, v in st.items():
            assert v["elapsed_ms"] >= 0 and v["host_ms"] >= 0, name
        # the stages cover the frame: on the CPU the clock is the host's
        top = sum(v["elapsed_ms"] for k, v in st.items()
                  if v["depth"] == 1 and k != "diag_read")
        assert 0.9 * st["frame"]["elapsed_ms"] <= top <= \
            st["frame"]["elapsed_ms"]
    for a, b in zip(tracker._theta, plain._theta):
        assert torch.equal(a, b)
    assert torch.equal(tracker.com_pre, plain.com_pre)


def test_device_trace_and_attribution(scene, tmp_path):
    """``device_trace`` around two steady frames on the CPU, read back by
    ``trace_attribution``: the reference's stage keys, buckets that sum to
    ``total_ms``, and every scope of the frames with its nesting."""
    frames = scene[3]
    tracker = _tracker(scene)
    tracker.track(frames[0])
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir, device="cpu"):
        for frame in frames[1:]:
            assert tracker.track(frame).ok
    out = profiling.trace_attribution(log_dir, reps=2)
    assert not out["on_device"]
    assert out["total_ms"] > 0 and out["launches"] > 100
    assert set(out["stages"]) == {"bgsub", "walk", "blob_cc", "fit",
                                  "frame_glue", "other"}
    assert abs(sum(out["stages"].values()) - out["total_ms"]) <= 0.01
    for k in ("bgsub", "walk", "blob_cc", "fit", "frame_glue"):
        assert out["stages"][k] > 0, k
    scopes = out["scopes"]
    for name in ("frame", "bgsub", "forest_walk", "blob_suppress", "fit",
                 "fit/nn", "fit/trial/lbs", "refine", "refine/nn",
                 "glue/sample"):
        assert scopes[name]["ms"] > 0 and scopes[name]["launches"] > 0, name
    # a scope holds its children; the stages are the frame's scopes
    assert scopes["fit"]["ms"] >= scopes["fit/nn"]["ms"] + \
        scopes["fit/gram"]["ms"]
    assert abs(scopes["frame"]["ms"] + out["stages"]["other"]
               - out["total_ms"]) <= 0.01
    fit_ms = scopes["fit"]["ms"] + scopes["refine"]["ms"]
    assert abs(fit_ms - out["stages"]["fit"]) <= 0.01
    # an empty directory attributes nothing
    assert profiling.trace_attribution(str(tmp_path / "none"), 1)[
        "total_ms"] == 0


def test_host_tracker_scopes(scene):
    """``tracking.Tracker`` marks its stages with the fused tracker's scope
    names, and its fit shows the LM step's parts."""
    model, intrin, trees, frames = scene
    tracker = Tracker(model, intrin, (H, W), rtree=trees[0],
                      config=TrackerConfig(data_interval=3, min_points=300,
                                           rtree_interval=3, iters_per_icp=2,
                                           initial_icp_iters=1))
    tracker.set_background(intrin.depth_to_xyz_np(
        np.full((H, W), WALL, np.float32)))
    xyz = intrin.depth_to_xyz_np(frames[0].astype(np.float32) * 1e-3)
    with profiling.stage_clock("cpu") as clock:
        res = tracker.track(xyz)
    assert res.ok
    st = clock.stages
    for name in ("frame", "bgsub", "forest_walk", "blob_suppress",
                 "glue/sample", "fit", "fit/nn", "fit/solve", "fit/sync"):
        assert st[name]["entries"] >= 1, name
    assert st["fit/sync"]["entries"] == st["fit/solve"]["entries"] <= 2
