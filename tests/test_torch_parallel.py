"""The port's multi-device layer (``avatar_tpu_torch/parallel/training.py``
and the trainer's mesh dispatch) on the CPU, in gloo worlds of 2 and 4 ranks
spawned by the port's launcher, at ``tests/test_parallel.py``'s sizes (the
detail-1 model, 96x96 frames).

Each world runs every check once and returns its results; every rank must
hold the same global results.  Against the one-process computation: the
sharded min/max, counts, count step and assign, LBS, render and the
tracking step equal to the bit.  The mesh trainer grows the tree of
``mesh=None`` (batch and flat) from the synthetic source, and from one
in-memory frame source the JAX trainer's tree (``u``, ``v``, ``lnode``,
``leafid`` equal, ``thresh`` within rtol 1e-6, ``leaf_data`` within 1e-7).
With ``image_batch`` 8 and no filter stage, B is 8 in every world, so the
batches are the same.  Stream 3 of the tracking step also matches the JAX
``_fused_frame_impl`` on that stream alone within the fused-frame parity
tolerances (labels and n_points equal; p and rotations 1e-4, shape keys
1e-3).  JAX is imported only inside the tests that compare with it, so the
spawned ranks, which import this module, stay JAX-free.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.core.lbs import lbs_batched
from avatar_tpu_torch.core.model import Avatar
from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.optim.gauss_newton import Theta
from avatar_tpu_torch.parallel import training as ptrain
from avatar_tpu_torch.render.renderer import AvatarRenderer
from avatar_tpu_torch.testing import synthetic_model
from avatar_tpu_torch.tracking import TrackerConfig
from avatar_tpu_torch.tracking_fused import FusedTracker, _fused_frame_impl
from avatar_tpu_torch.train import forest, synth

H = W = 96
INTRIN = dict(fx=120.0, fy=120.0, cx=48.0, cy=48.0)
SEED = 2
B, S, F, NC, T, P = 8, 64, 12, 2, 8, 24
STREAMS = 4
# test_parallel.py's tracker config; beta_pose 0.3 as in
# test_torch_tracker.py: at this size a limb gets a handful of samples and
# under the default prior its rotation is ill-conditioned enough for two
# float32 implementations' summation order to show above 1e-4
TRACK_CFG = dict(data_interval=4, min_points=50, iters_per_icp=2,
                 seg_window=None, beta_pose=0.3)
TRAIN_KW = dict(num_parts=24, num_images=16, num_points_per_image=150,
                num_features=16, max_probe_offset=48.0, min_samples=16,
                max_tree_depth=5, image_batch=8, seed=9)
TREE_FIELDS = ("u", "v", "thresh", "lnode", "rnode", "leafid", "leaf_data")
DEADLINE_S = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in every rank (the launcher gives each
    rank its share of the caller's): the one-process results must round
    as the ranks' do."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class MemorySource:
    """Frames held in memory, as a trainer's ``frame_source``."""

    def __init__(self, depth, mask):
        self.depth, self.mask = depth, mask

    def size(self):
        return len(self.depth)

    def load_batch(self, ids):
        ids = np.asarray(ids)
        return self.depth[ids], self.mask[ids]


def _scene():
    model = synthetic_model(detail=1, device="cpu")
    src = synth.make_source(model, CameraIntrin(**INTRIN), n_images=16,
                            seed=SEED)
    return model, src


def _tracker(model):
    return FusedTracker(model, CameraIntrin(**INTRIN), (H, W),
                        config=TrackerConfig(**TRACK_CFG))


def _frame_kwargs(tr):
    """``tests/test_parallel.py``'s frame arguments, from either package's
    tracker."""
    c = tr._consts()
    return dict(
        beta_pose=c["beta_pose"], beta_shape=c["beta_shape"],
        nn_t=c["nn_t"], nb_t=c["nb_t"], min_cc_pts=c["min_cc"],
        dist_to_pre_weight=c["d2p"], seg_stride=1,
        data_substride=tr._data_substride, n_steps=4,
        num_parts=tr.num_parts, max_depth=0, use_forest=False,
        use_bgsub=False, use_jsr=tr.model.use_joint_shape_regressor,
        pad_n=tr._pad_n, seg_window=None, point_weight=c["point_weight"],
        plane_weight=c["plane_weight"], huber_k=c["huber_k"])


def _forest_arrays(fd):
    return {f: getattr(fd, f) for f in TREE_FIELDS}


def _np(x):
    return tuple(t.numpy() for t in x)


@pytest.fixture(scope="module")
def inputs():
    """Every input of the checks, made once here from seeds and handed to
    the ranks as numpy arrays."""
    model, src = _scene()
    K = model.num_shape_keys()
    depth, mask, _ = synth.render_batch(src, model.parents, np.arange(B),
                                        SEED, H, W, K)
    depth, mask = depth.numpy(), mask.numpy()
    rng = np.random.default_rng(0)
    sx, sy = np.zeros((B, S), np.int32), np.zeros((B, S), np.int32)
    part, valid = np.zeros((B, S), np.int32), np.zeros((B, S), bool)
    for b in range(B):
        ys, xs = np.nonzero(depth[b] > 0)
        take = min(S, len(ys))
        pick = rng.choice(len(ys), take, replace=False)
        sx[b, :take], sy[b, :take] = xs[pick], ys[pick]
        part[b, :take] = mask[b][ys[pick], xs[pick]]
        valid[b, :take] = True
    inp = dict(
        depth=depth, sx=sx, sy=sy, part=part, valid=valid,
        node_local=np.where(valid, rng.integers(0, NC, (B, S)), -1
                            ).astype(np.int32),
        fu=rng.uniform(-40, 40, (F, 2)).astype(np.float32),
        fv=rng.uniform(-40, 40, (F, 2)).astype(np.float32),
        node=rng.integers(0, 3, (B, S)).astype(np.int32),
        best_u=rng.uniform(-40, 40, (3, 2)).astype(np.float32),
        best_v=rng.uniform(-40, 40, (3, 2)).astype(np.float32),
        best_thresh=rng.uniform(-0.2, 0.2, 3).astype(np.float32),
        lchild=np.array([3, 5, 7], np.int32),
        rchild=np.array([4, 6, 8], np.int32),
        is_split=np.array([True, True, False]),
        w=rng.normal(0, 0.5, (B, K)).astype(np.float32),
        p=rng.normal(0, 0.5, (B, 3)).astype(np.float32),
        rots=rotation.so3_exp(torch.as_tensor(
            rng.normal(0, 0.3, (B, 24, 3)), dtype=torch.float32)).numpy())
    # the streams: one scene, shifted per stream (test_parallel.py's)
    ava = Avatar(model)
    ava.randomize(seed=5)
    ava.w *= 0.2
    ava.r[0] = np.diag([-1.0, 1.0, -1.0])
    depths, labels = [], []
    for s in range(STREAMS):
        ava.p = np.array([0.02 * s - 0.08, 0.1, 2.0])
        ava.update()
        rend = AvatarRenderer(ava, CameraIntrin(**INTRIN))
        depths.append(rend.render_depth((H, W)))
        labels.append(rend.render_part_mask((H, W)))
    rots = np.tile(np.eye(3, dtype=np.float32), (STREAMS, 24, 1, 1))
    rots[:, 0] = np.diag([-1.0, 1.0, -1.0])
    com = np.concatenate([np.full((1, 24), -1.0), np.zeros((1, 24))])
    inp.update(
        depth_b=np.stack(depths), labels_b=np.stack(labels),
        theta_p=np.tile(np.float32([0.0, 0.1, 2.0]), (STREAMS, 1)),
        theta_rots=rots, theta_w=np.zeros((STREAMS, K), np.float32),
        com_b=np.tile(com.astype(np.float32), (STREAMS, 1, 1)))
    # 16 frames for the trainer's in-memory source
    fdepth, fmask, _ = synth.render_batch(src, model.parents, np.arange(16),
                                          SEED, H, W, K)
    inp.update(frames_depth=fdepth.numpy(), frames_mask=fmask.numpy())
    return inp


def _pass_args(t):
    return (t["depth"], t["sx"], t["sy"], t["valid"], t["node_local"],
            t["fu"], t["fv"])


def _assign_args(t):
    return (t["depth"], t["sx"], t["sy"], t["valid"], t["node"],
            t["best_u"], t["best_v"], t["best_thresh"], t["lchild"],
            t["rchild"], t["is_split"])


def _checks(inp, ckpt_dir):
    """One rank's run of every check, in a world launched by
    ``run_world``: the global results, as numpy."""
    mesh = ptrain.make_mesh(device="cpu")
    model, src = _scene()
    K = model.num_shape_keys()
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    out = {"rank": mesh.rank, "size": mesh.size}
    out["render"] = _np(ptrain.sharded_render_batch(
        mesh, src, model.parents, np.arange(B), SEED, H, W, K))
    out["count_step"] = _np(ptrain.sharded_count_step(
        mesh, model.parents, src, np.arange(B), t["sx"], t["sy"],
        t["part"], t["valid"], t["node_local"], t["fu"], t["fv"], NC, T, P,
        SEED, H, W, K))
    smin, smax = ptrain.sharded_pass_minmax(mesh, *_pass_args(t), NC)
    out["minmax"] = (smin.numpy(), smax.numpy())
    a = _pass_args(t)
    out["counts"] = ptrain.sharded_pass_counts(
        mesh, *a[:3], t["part"], *a[3:], smin, smax, NC, T, P).numpy()
    out["assign"] = ptrain.sharded_pass_assign(mesh,
                                               *_assign_args(t)).numpy()
    out["lbs"] = _np(ptrain.sharded_multistream_lbs(
        mesh, model.params, model.parents, t["w"], t["p"], t["rots"]))
    tr = _tracker(model)
    fo = ptrain.sharded_track_step(
        mesh, tr._ctx, tr._ctx_fit, None, model.parents, t["depth_b"],
        t["labels_b"], tr._bg, tr._intrin4,
        Theta(t["theta_p"], t["theta_rots"], t["theta_w"]), t["com_b"],
        _frame_kwargs(tr))
    out["track"] = (*_np(fo.theta), fo.com_pre.numpy(),
                    fo.labels_strided.numpy(), fo.host_diag.numpy())
    out["tree_synthetic"] = _forest_arrays(forest.ForestTrainer(
        model, CameraIntrin(**INTRIN), (H, W), mesh=mesh,
        **TRAIN_KW).train())
    # interrupted on rank 0 after level 1, as its SIGINT handler would:
    # every rank stops there, and every rank resumes from rank 0's file
    kw = dict(TRAIN_KW, checkpoint_path=os.path.join(ckpt_dir, "m.ckpt"))
    cut = forest.ForestTrainer(model, CameraIntrin(**INTRIN), (H, W),
                               mesh=mesh, **kw)
    level = cut._train_level

    def interrupted():
        level()
        if cut.level == 1 and mesh.rank == 0:
            cut._panic = True

    cut._train_level = interrupted
    cut.train()
    out["cut_after"] = cut.level
    out["tree_resumed"] = _forest_arrays(forest.ForestTrainer(
        model, CameraIntrin(**INTRIN), (H, W), mesh=mesh, **kw).train(
        resume_from=kw["checkpoint_path"]))
    source = MemorySource(inp["frames_depth"], inp["frames_mask"])
    out["tree_source"] = _forest_arrays(forest.ForestTrainer(
        None, None, (H, W), frame_source=source, device="cpu", mesh=mesh,
        **TRAIN_KW).train())
    # refused: a leading axis that does not divide, a mesh of another size
    refused = []
    for call in (lambda: ptrain.sharded_pass_minmax(
                     mesh, *(x[:mesh.size + 1] for x in a[:5]), *a[5:],
                     NC),
                 lambda: ptrain.make_mesh(mesh.size + 1, device="cpu")):
        try:
            call()
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


@pytest.fixture(scope="module")
def local(inputs):
    """The one-process computation of every check."""
    model, src = _scene()
    K = model.num_shape_keys()
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    out = {"render": _np(synth.render_batch(src, model.parents, np.arange(B),
                                            SEED, H, W, K))}
    smin, smax = forest.pass_minmax(*_pass_args(t), NC)
    a = _pass_args(t)
    counts = forest.pass_counts(*a[:3], t["part"], *a[3:], smin, smax, NC,
                                T, P)
    out["minmax"] = (smin.numpy(), smax.numpy())
    out["counts"] = counts.numpy()
    depth_r = torch.as_tensor(out["render"][0])
    mn, mx = forest.pass_minmax(depth_r, *a[1:], NC)
    out["count_step"] = (forest.pass_counts(
        depth_r, *a[1:3], t["part"], *a[3:], mn, mx, NC, T, P).numpy(),
        mn.numpy(), mx.numpy())
    out["assign"] = forest.pass_assign(*_assign_args(t)).numpy()
    out["lbs"] = _np(lbs_batched(model.params, model.parents, t["w"],
                                 t["p"], t["rots"]))
    tr = _tracker(model)
    kw = _frame_kwargs(tr)
    frames = []
    for s in range(STREAMS):
        th = Theta(t["theta_p"][s], t["theta_rots"][s], t["theta_w"][s])
        fo = _fused_frame_impl(tr._ctx, tr._ctx_fit, None, model.parents,
                               t["depth_b"][s], t["labels_b"][s], tr._bg,
                               tr._intrin4, th, t["com_b"][s], **kw)
        frames.append((*_np(fo.theta), fo.com_pre.numpy(),
                       fo.labels_strided.numpy(), fo.host_diag.numpy()))
    out["track"] = tuple(np.stack(f) for f in zip(*frames))
    for mode in ("batch", "flat"):
        out[f"tree_{mode}"] = _forest_arrays(forest.ForestTrainer(
            model, CameraIntrin(**INTRIN), (H, W), pass_mode=mode,
            **TRAIN_KW).train())
    return out


@pytest.fixture(scope="module", params=[2, 4])
def world(request, inputs, tmp_path_factory):
    """The checks in a gloo world of 2 or 4 ranks; rank 0's results, after
    every other rank's are found equal to them."""
    t0 = time.monotonic()
    ranks = ptrain.run_world(_checks, request.param, "cpu", inputs,
                             str(tmp_path_factory.mktemp("ckpt")),
                             timeout_s=DEADLINE_S)
    assert time.monotonic() - t0 < DEADLINE_S
    assert [r["rank"] for r in ranks] == list(range(request.param))
    for r in ranks[1:]:
        _assert_equal(r, ranks[0], ("rank",))
    return ranks[0]


def _assert_equal(got, ref, skip=()):
    if isinstance(ref, dict):
        for k in ref:
            if k not in skip:
                _assert_equal(got[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_equal(g, r)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["minmax", "counts", "count_step", "assign"])
def test_sharded_passes_equal_one_process(world, local, inputs, name):
    """The level passes and the count step, to the bit."""
    _assert_equal(world[name], local[name])
    if name == "count_step":
        assert world[name][0].sum() == inputs["valid"].sum() * F


@pytest.mark.parametrize("name", ["render", "lbs", "track"])
def test_sharded_streams_equal_one_process(world, local, name):
    """Render, LBS and the tracking step compute each image, pose or
    stream alone: to the bit."""
    _assert_equal(world[name], local[name])


def test_mesh_trainer_grows_the_one_device_tree(world, local):
    assert (world["tree_synthetic"]["leafid"] < 0).sum() > 3
    for mode in ("batch", "flat"):
        _assert_equal(world["tree_synthetic"], local[f"tree_{mode}"])


def test_mesh_trainer_stops_and_resumes_on_every_rank(world, local):
    """Rank 0's interrupt stops every rank after the same level; resumed
    from rank 0's checkpoint, every rank grows the uninterrupted tree."""
    assert world["cut_after"] == 2
    _assert_equal(world["tree_resumed"], local["tree_batch"])


def test_mesh_refuses_what_does_not_divide(world):
    size = world["size"]
    assert len(world["refused"]) == 2
    assert f"does not divide by the mesh size ({size})" in \
        world["refused"][0]
    assert f"must be 0 or {size}" in world["refused"][1]


# ---------------------------------------------------------------------------
# against the JAX reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_tree(inputs):
    """The JAX trainer's tree (one device) from the in-memory frames."""
    from avatar_tpu.train import forest as jforest

    source = MemorySource(inputs["frames_depth"], inputs["frames_mask"])
    return jforest.ForestTrainer(None, None, (H, W), frame_source=source,
                                 pass_mode="batch", **TRAIN_KW).train()


def test_mesh_trainer_grows_the_reference_tree(world, reference_tree):
    """From one in-memory frame source, the mesh trainer and the JAX
    trainer grow the same tree."""
    ref, got = reference_tree, world["tree_source"]
    assert (ref.leafid < 0).sum() > 3
    for f in ("u", "v", "lnode", "rnode", "leafid"):
        np.testing.assert_array_equal(got[f], getattr(ref, f), err_msg=f)
    np.testing.assert_allclose(got["thresh"], ref.thresh, rtol=1e-6)
    np.testing.assert_allclose(got["leaf_data"], ref.leaf_data, atol=1e-7)


@pytest.fixture(scope="module")
def reference_stream(inputs):
    """The JAX frame on stream 3 alone (unsharded: ``tests/test_parallel.py``
    holds the JAX sharded step to it), its fit through the part-sorted NN
    kernel in interpret mode (its TPU path), as the port's fit plans its
    NN."""
    import jax
    import jax.numpy as jnp

    from avatar_tpu.io.calibration import CameraIntrin as JIntrin
    from avatar_tpu.optim import correspond as jcorr
    from avatar_tpu.optim import nn_pallas
    from avatar_tpu.optim.gauss_newton import Theta as JTheta
    from avatar_tpu.testing import synthetic_model as j_synthetic_model
    from avatar_tpu.tracking import TrackerConfig as JConfig
    from avatar_tpu.tracking_fused import FusedTracker as JTracker
    from avatar_tpu.tracking_fused import _fused_frame_impl as j_frame

    kernel = nn_pallas.nn_argmin_ranges

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return kernel(*args, **kw)

    model = j_synthetic_model(detail=1)
    tr = JTracker(model, JIntrin(**INTRIN), (H, W),
                  config=JConfig(**TRACK_CFG))
    s = 3
    with pytest.MonkeyPatch.context() as mp:
        jax.clear_caches()
        mp.setattr(jcorr, "_pallas_enabled", lambda: True)
        mp.setattr(nn_pallas, "nn_argmin_ranges", interpreted)
        one = j_frame(tr._ctx, tr._ctx_fit, None, model.parents,
                      jnp.asarray(inputs["depth_b"][s]),
                      jnp.asarray(inputs["labels_b"][s]), tr._bg,
                      tr._intrin4,
                      JTheta(*(jnp.asarray(inputs[k][s]) for k in
                               ("theta_p", "theta_rots", "theta_w"))),
                      jnp.asarray(inputs["com_b"][s]), **_frame_kwargs(tr))
        jax.clear_caches()
    return s, one


def test_track_step_stream_matches_reference(world, reference_stream):
    """Stream 3 of the sharded step against the JAX frame on it."""
    s, one = reference_stream
    p, rots, w, com, labels, diag = (a[s] for a in world["track"])
    np.testing.assert_array_equal(labels, np.asarray(one.labels_strided))
    dj = np.asarray(one.host_diag)
    assert diag[0] == dj[0] > 50                      # n_points
    np.testing.assert_allclose(com, np.asarray(one.com_pre), atol=1e-3)
    np.testing.assert_allclose(p, np.asarray(one.theta.p), atol=1e-4)
    np.testing.assert_allclose(rots, np.asarray(one.theta.rots), atol=1e-4)
    np.testing.assert_allclose(w, np.asarray(one.theta.w), atol=1e-3)


# ---------------------------------------------------------------------------
# the mesh in one process, the launcher, the tool
# ---------------------------------------------------------------------------


def _raise_on_rank_1():
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    flag = torch.ones(1)
    dist.all_reduce(flag)
    return float(flag)


def test_a_rank_that_raises_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 gives up") as e:
        ptrain.run_world(_raise_on_rank_1, 2, "cpu", timeout_s=120)
    assert time.monotonic() - t0 < 120
    assert any("raised on rank 1 of a world of 2" in n
               for n in e.value.__notes__)


def test_world_of_one_and_refusals():
    """Outside a launched world, ``make_mesh`` sets up a world of one and
    refuses more; a mesh trainer refuses the flat passes; without CUDA the
    card's mesh raises."""
    with pytest.raises(RuntimeError, match="run_world"):
        ptrain.make_mesh(2, device="cpu")
    assert not dist.is_initialized()
    with ptrain.make_mesh(1, device="cpu") as mesh:
        assert (mesh.rank, mesh.size, mesh.shape) == (0, 1, {"data": 1})
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="pass_mode='batch'"):
            forest.ForestTrainer(
                None, None, (H, W), device="cpu", pass_mode="flat",
                frame_source=MemorySource(np.zeros((16, H, W)), None),
                mesh=mesh, **TRAIN_KW)
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ptrain.make_mesh(1)


TOOL = ["--synthetic-model", "1", "--images", "16", "--pixels", "200",
        "--features", "16", "--depth", "5", "--min-samples", "20",
        "--probe", "60", "--width", "96", "--height", "96", "--fx", "110",
        "--fy", "110", "--cx", "48", "--cy", "48", "-q", "--device", "cpu"]


def test_rtree_train_devices_writes_the_one_device_forest(tmp_path):
    """``--devices 2`` (a spawned gloo world) and ``--devices 1`` (a world
    of one in this process) write the bytes of ``--devices 0``."""
    from avatar_tpu_torch.tools import rtree_train

    data = {}
    for n in (0, 1, 2):
        path = str(tmp_path / f"d{n}.srtr")
        rtree_train.main([path, *TOOL, "--devices", str(n)])
        with open(path, "rb") as f:
            data[n] = f.read()
    assert data[1] == data[0] and data[2] == data[0]
    assert not dist.is_initialized()


def test_rtree_train_refuses_more_devices_than_cards(tmp_path, monkeypatch):
    """On the card, ``--devices 2`` with one visible card exits naming the
    count, before any rank starts."""
    from avatar_tpu_torch.tools import rtree_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = str(tmp_path / "x.srtr")
    with pytest.raises(SystemExit) as e:
        rtree_train.main([out, *TOOL[:-2], "--devices", "2"])
    assert "1 CUDA device(s) visible" in str(e.value.code)
    assert not os.path.exists(out)
