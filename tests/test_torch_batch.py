"""The port's batch and async tracker (``FusedTracker.track_batch``,
``track_batch_async`` / ``flush_batches``, ``track_async`` / ``flush``)
against the JAX reference's, on the detail-2 model, the 256x256 frames and
the configuration of ``tests/test_torch_tracker.py`` (the 3-tree r5 forest,
background subtraction, the tracked window, the wildcard channel), with
the reference's fit on its planned NN (the Pallas kernel in interpret
mode).  Every batch holds two frames, so the reference compiles one batch
program for all the cases.

Per frame the ok flag and n_points are equal, and each pose's joints lie
within ``JOINT_MM`` of the reference's (both computed by the port's LBS
from the two poses).  After each call the host state of the tracking loss
state machine is equal (``_last_root_z`` within ``JOINT_MM``: it is a mean
of the fitted parts' depths).  The last case holds the batch to the
frame-by-frame ``track`` chain on the port alone, to the bit.
"""

import numpy as np
import pytest
import torch

import jax

from avatar_tpu.io.calibration import CameraIntrin
from avatar_tpu.optim import correspond as jcorr
from avatar_tpu.optim import nn_pallas
from avatar_tpu.perception.rtree import RTree as JRTree
from avatar_tpu.testing import synthetic_model as j_synthetic_model
from avatar_tpu.tracking import TrackerConfig as JConfig
from avatar_tpu.tracking_fused import FusedTracker as JTracker
from avatar_tpu_torch.core.lbs import lbs
from avatar_tpu_torch.io.calibration import CameraIntrin as TIntrin
from avatar_tpu_torch.perception.rtree import RTree as TRTree
from avatar_tpu_torch.testing import synthetic_model as t_synthetic_model
from avatar_tpu_torch.tracking import TrackerConfig as TConfig
from avatar_tpu_torch.tracking_fused import FusedTracker as TTracker
from test_torch_tracker import CFG, CX, CY, FX, FY, H, W, WALL, _frames, \
    _trees

JOINT_MM = 1.0
STATE = ("reinit", "_frame_no", "_lost_frames", "_lost_count",
         "_shape_refit_in")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the trackers' many small operators contend
    badly when parallel test workers each take every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene():
    """Both models, 6 frames (a reinit and 5 steady) and an empty one, with
    the reference's fit on its planned NN for the whole module: the JAX
    programs compile once for all the cases."""
    kernel = nn_pallas.nn_argmin_ranges

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return kernel(*args, **kw)

    jmodel = j_synthetic_model(detail=2)
    tmodel = t_synthetic_model(detail=2, device="cpu")
    frames = _frames(jmodel, 6)
    empty = np.full((H, W), int(WALL * 1000), np.uint16)
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorr, "_pallas_enabled", lambda: True)
        mp.setattr(nn_pallas, "nn_argmin_ranges", interpreted)
        yield jmodel, tmodel, frames, empty
    jax.clear_caches()


def _pair(scene, **cfg):
    jmodel, tmodel, _, _ = scene
    cfg = dict(CFG, **cfg)
    jt = JTracker(jmodel, CameraIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(JRTree), config=JConfig(**cfg))
    tt = TTracker(tmodel, TIntrin(fx=FX, fy=FY, cx=CX, cy=CY), (H, W),
                  rtree=_trees(TRTree, device="cpu"), config=TConfig(**cfg))
    bg = np.full((H, W), WALL, np.float32)
    jt.set_background(bg)
    tt.set_background(bg)
    return jt, tt


def _joints(tmodel, thetas) -> np.ndarray:
    """Joints [B, J, 3] of a batch of poses (numpy p, rots, w), by the
    port's LBS."""
    p, rots, w = (torch.as_tensor(np.array(a)) for a in thetas)
    return np.stack([lbs(tmodel.params, tmodel.parents, w[b], p[b], rots[b],
                         use_jsr=tmodel.use_joint_shape_regressor)[1].numpy()
                     for b in range(p.shape[0])])


def _same_results(rt, rj, reinit=False):
    flags = lambda rs: [(r.ok, r.reinitialized, r.n_points) for r in rs]
    assert flags(rt) == flags(rj)
    if not reinit:
        assert not any(r.reinitialized for r in rt)


def _same_poses(tmodel, tt_thetas, jt_thetas, n):
    jp = _joints(tmodel, [np.asarray(a) for a in jt_thetas])
    tp = _joints(tmodel, [a.numpy() for a in tt_thetas])
    assert tp.shape == jp.shape == (n, 24, 3)
    err = np.linalg.norm(tp - jp, axis=-1).mean(axis=-1) * 1e3
    assert (err < JOINT_MM).all(), f"joints {err} mm from the reference's"


def _same_state(tt, jt):
    for k in STATE:
        assert getattr(tt, k) == getattr(jt, k), k
    assert (tt._last_root_z is None) == (jt._last_root_z is None)
    if tt._last_root_z is not None:
        assert abs(tt._last_root_z - jt._last_root_z) < JOINT_MM * 1e-3


def test_track_batch_matches_reference(scene):
    """A reinit through ``track``, then frames 1-2 and 3-4 as batches: per
    frame the same (ok, n_points), poses within ``JOINT_MM``, one pose per
    result, and the same host state; a batch advances no frame number and
    counts the shape refit down by its length."""
    _, tmodel, frames, _ = scene
    jt, tt = _pair(scene)
    _same_results([tt.track(frames[0])], [jt.track(frames[0])], reinit=True)
    for n, batch in enumerate((frames[1:3], frames[3:5]), start=1):
        rj, rt = jt.track_batch(batch), tt.track_batch(batch)
        _same_results(rt, rj)
        assert all(r.ok for r in rt) and len(rt) == 2
        _same_poses(tmodel, tt.batch_thetas, jt.batch_thetas, 2)
        _same_state(tt, jt)
        assert tt._frame_no == 0
        assert tt._shape_refit_in == TConfig().shape_refit_after - 2 * n
        for a, b in zip(tt._theta, tt.batch_thetas):
            assert torch.equal(a, b[-1])


@pytest.mark.parametrize("due", ["reinit", "shape_refit"])
def test_track_batch_head_split_matches_reference(scene, due):
    """While lost, or with the shape refit due, the batch's head frame goes
    through ``track`` and the rest is a batch; ``batch_thetas`` holds one
    pose per result, the head's first."""
    _, tmodel, frames, _ = scene
    jt, tt = _pair(scene, shape_refit_after=1)
    if due == "reinit":
        batch = frames[:3]
    else:
        for t in (jt, tt):
            assert t.track(frames[0]).ok and t.track(frames[1]).ok
            assert t._shape_refit_due()
        batch = frames[2:5]
    rj, rt = jt.track_batch(batch), tt.track_batch(batch)
    _same_results(rt, rj, reinit=True)
    assert all(r.ok for r in rt)
    assert rt[0].reinitialized == (due == "reinit")
    _same_poses(tmodel, tt.batch_thetas, jt.batch_thetas, 3)
    _same_state(tt, jt)
    assert tt._shape_refit_in == (-1 if due == "reinit" else None)


def test_loss_inside_a_batch_matches_reference(scene):
    """An empty frame inside a batch: that frame is lost, the frame after
    it still gets a result, and the next call starts with a reinit through
    ``track``."""
    _, tmodel, frames, empty = scene
    jt, tt = _pair(scene)
    for t in (jt, tt):
        assert t.track(frames[0]).ok
    batch = [empty, frames[1]]
    rj, rt = jt.track_batch(batch), tt.track_batch(batch)
    _same_results(rt, rj)
    assert not rt[0].ok and rt[0].n_points == 0 and len(rt) == 2
    assert tt.reinit
    _same_state(tt, jt)
    rj, rt = jt.track_batch(frames[2:5]), tt.track_batch(frames[2:5])
    _same_results(rt, rj, reinit=True)
    assert rt[0].reinitialized and all(r.ok for r in rt)
    _same_poses(tmodel, tt.batch_thetas, jt.batch_thetas, 3)
    _same_state(tt, jt)


def test_track_batch_async_matches_reference(scene):
    """Batches [1, 2], [3, 4], [5, 1], then ``flush_batches``: no pair from
    the first call, one from each later call and one from the flush, each
    the previous batch's; the same results and poses as the reference's."""
    _, tmodel, frames, _ = scene
    jt, tt = _pair(scene)
    for t in (jt, tt):
        assert t.track(frames[0]).ok
    got_j, got_t = [], []
    for batch in (frames[1:3], frames[3:5], [frames[5], frames[1]]):
        got_j.append(jt.track_batch_async(batch))
        got_t.append(tt.track_batch_async(batch))
    got_j.append(jt.flush_batches())
    got_t.append(tt.flush_batches())
    assert [len(g) for g in got_t] == [len(g) for g in got_j] == [0, 1, 1, 1]
    assert tt.flush_batches() == [] and not tt._batch_q
    for gt_, gj in zip(got_t[1:], got_j[1:]):
        (rt, tht), = gt_
        (rj, thj), = gj
        _same_results(rt, rj)
        assert len(rt) == 2
        _same_poses(tmodel, tht, thj, 2)
    _same_state(tt, jt)


def test_track_async_matches_reference(scene):
    """``track_async`` over frames 1-5: ``pipeline_depth`` (2) Nones, then
    the results of frames 1-3; ``flush`` returns frame 5's and drops frame
    4's.  Then an empty frame: its loss shows two calls later, and the next
    call drops the frames in flight and runs the reinit of ``track`` (which
    loses the body here in both packages: ``track_async`` never updates the
    body depth that gates the reinit, so it still holds the reinit seed's
    first frame)."""
    _, tmodel, frames, empty = scene
    jt, tt = _pair(scene)
    for t in (jt, tt):
        assert t.track(frames[0]).ok
    assert tt.config.pipeline_depth == 2
    seq = list(frames[1:6])
    rj = [jt.track_async(f) for f in seq] + [jt.flush()]
    rt = [tt.track_async(f) for f in seq] + [tt.flush()]
    assert rt[:2] == rj[:2] == [None, None]
    _same_results(rt[2:], rj[2:])
    assert all(r.ok for r in rt[2:]) and not tt._pending_q
    assert tt.flush() is None
    _same_poses(tmodel, [a[None] for a in tt._theta],
                [np.asarray(a)[None] for a in jt._theta], 1)
    _same_state(tt, jt)

    seq = [empty, frames[1], frames[2], frames[3]]
    rj = [jt.track_async(f) for f in seq]
    rt = [tt.track_async(f) for f in seq]
    assert rt[:2] == rj[:2] == [None, None]
    _same_results(rt[2:], rj[2:], reinit=True)
    assert not rt[2].ok and rt[2].n_points == 0
    assert not rt[3].ok and tt._lost_frames == 1 and tt.reinit
    assert not tt._pending_q and tt.flush() is None
    _same_state(tt, jt)


def test_track_batch_matches_sync():
    """On the port alone, the reference's ``test_track_batch_matches_sync``
    with oracle labels and float depth (no forest, so no limb recovery):
    ``track_batch`` gives the poses of frame-by-frame ``track`` to the
    bit."""
    from avatar_tpu_torch.core import rotation
    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.render.renderer import AvatarRenderer

    model = t_synthetic_model(detail=2, device="cpu")
    intrin = TIntrin(fx=220.0, fy=220.0, cx=128.0, cy=128.0)
    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 2.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(8)
    step = rotation.so3_exp(torch.as_tensor(
        rng.normal(0, 0.02, (24, 3)), dtype=torch.float32)).numpy()
    frames = []
    for _ in range(5):
        gt.update()
        rend = AvatarRenderer(gt, intrin)
        frames.append((rend.render_depth((256, 256)),
                       rend.render_part_mask((256, 256))))
        gt.r = np.einsum("jab,jbc->jac", step, gt.r)
        gt.p = gt.p + rng.normal(0, 0.01, 3)
    cfg = TConfig(data_interval=4, min_points=200, iters_per_icp=4,
                  initial_icp_iters=2, reinit_seeds=1)
    sync, batch = (TTracker(model, intrin, (256, 256), config=cfg)
                   for _ in range(2))
    for t in (sync, batch):
        assert t.track(*frames[0]).reinitialized
    poses = []
    for depth, mask in frames[1:]:
        assert sync.track(depth, mask).ok
        poses.append(sync._theta)
    results = batch.track_batch([f[0] for f in frames[1:]],
                                [f[1] for f in frames[1:]])
    assert len(results) == 4 and all(r.ok for r in results)
    for f, got in enumerate(batch.batch_thetas):
        assert torch.equal(got, torch.stack([p[f] for p in poses]))
    for a, b in zip(batch._theta, sync._theta):
        assert torch.equal(a, b)
    assert torch.equal(batch.com_pre, sync.com_pre)
