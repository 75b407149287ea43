"""Multi-device forest training and multi-stream tracking (counterpart of
``avatar_tpu/parallel/training.py``).

The reference shards over a ``jax.sharding.Mesh`` from one controller.  The
port runs one process per device in a ``torch.distributed`` process group
(NCCL on the card, gloo on the CPU); ``Mesh`` names that group.  Every rank
calls a ``sharded_*`` function with the same global inputs and takes its
contiguous block of the leading axis, the split ``P(axis)`` makes; the
axis must divide by the mesh size.  Each rank runs the local pass on its
block.  Replicated outputs (``P()``) are combined by ``all_reduce`` (MIN,
MAX, SUM) and sharded outputs (``P(axis)``) by ``all_gather``, so every
rank holds the global result.

Min and max do not depend on order, and the histogram counts are whole
numbers in float32, whose sum is exact in any order: the passes, the count
step and the assign equal one device's to the bit, and a tree trained over
a mesh is the one-device tree (the reduction TrainerV2 does with a mutex,
RTree.cpp:1700-1704).  Render, LBS and the tracking step compute each
image, pose or stream on its own, so they give the one-process results.

``run_world`` launches a world of ranks; inside it, ``make_mesh`` returns
the rank's mesh.  Outside one, ``make_mesh`` sets up a world of one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import signal
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from avatar_tpu_torch.core.lbs import lbs_batched
from avatar_tpu_torch.device import get_device
from avatar_tpu_torch.tracking_fused import _fused_frame_impl
from avatar_tpu_torch.train import forest as forest_mod
from avatar_tpu_torch.train import synth

GROUP_TIMEOUT_S = 60    # how long a collective waits for a rank that died
GRACE_S = 5             # the other ranks' time to report after one failed
LAUNCHER = "avatar_tpu_torch.parallel.training.run_world"


@dataclass
class Mesh:
    """A one-dimensional mesh: the ranks of a process group, one device
    each.  ``shape`` is ``{axis: size}``, as a ``jax.sharding.Mesh``'s."""
    group: Any              # the process group (None: the default group)
    rank: int
    size: int
    axis: str
    device: torch.device
    owns_group: bool = False

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    def close(self) -> None:
        """End the world of one that ``make_mesh`` set up; a launched
        world's group belongs to its launcher."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _check_cards(n: int) -> None:
    have = torch.cuda.device_count()
    if n > have:
        raise RuntimeError(f"a world of {n} ranks on the card needs {n} "
                           f"CUDA devices, one per rank; {have} visible")


def make_mesh(n_devices: int = 0, axis: str = "data",
              device: str | torch.device | None = None) -> Mesh:
    """The mesh of this rank's process group, on ``device`` (the card
    unless the caller asks for the CPU; rank r takes ``cuda:r``).

    Inside an initialized group ``n_devices`` must be 0 or the world size.
    With no group and ``n_devices`` 0 or 1 it sets up a world of one (the
    mesh owns it: ``close()`` ends it).  A larger world is started by
    ``run_world``, one process per device; there is no fallback to fewer
    devices or to the CPU."""
    if not dist.is_initialized() and n_devices not in (0, 1):
        raise RuntimeError(
            f"make_mesh({n_devices}): no process group is initialized; a "
            f"world of {n_devices} ranks, one process per device, is "
            f"started by {LAUNCHER}")
    dev = get_device("cuda" if device is None else device)
    backend = _backend(dev)
    owns = False
    if not dist.is_initialized():
        if dev.type == "cuda":
            _check_cards(1)
        dist.init_process_group(
            backend, store=dist.HashStore(), world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        owns = True
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (0, size):
        raise ValueError(f"make_mesh({n_devices}) in a world of {size} "
                         f"ranks: n_devices must be 0 or {size}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}; a "
                         f"mesh on {dev.type} needs {backend}")
    if dev.type == "cuda":
        index = rank if dev.index is None else dev.index
        _check_cards(index + 1)
        dev = torch.device("cuda", index)
    return Mesh(None, rank, size, axis, dev, owns)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _pickled_error(e: BaseException, tb: str, when: float):
    """(when, exception, traceback): the time the rank failed tells the
    first failure from the failed collectives it caused on the others."""
    try:
        return when, pickle.dumps(e), tb
    except Exception:       # an exception that does not pickle: its text
        return when, None, tb


def _rank_main(fn, rank, n, device_type, init, threads, args, results):
    """One rank of ``run_world``: join the group, run ``fn(*args)``, report
    its return value or its exception (pickled here, so that no tensor is
    shared with a process about to exit)."""
    failed_at = None
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device_type)
        if dev.type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            _backend(dev), init_method=init, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = fn(*args)
        except BaseException:
            failed_at = time.time()     # before the group goes down
            raise
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException as e:     # reported; the launcher raises it
        results.put((rank, False, _pickled_error(
            e, traceback.format_exc(), failed_at or time.time())))
        if not isinstance(e, Exception):
            raise


@contextlib.contextmanager
def _sigint_left_to_ranks():
    """While the ranks run, SIGINT is theirs to handle (a trainer's rank 0
    saves a checkpoint and the world stops after the level)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    old = signal.signal(signal.SIGINT, signal.SIG_IGN)
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, old)


def run_world(fn: Callable, n: int, device: str | torch.device, *args,
              timeout_s: Optional[float] = 600.0) -> list:
    """Run ``fn(*args)`` on ``n`` ranks, one spawned process each, in a
    process group: NCCL with rank r on ``cuda:r``, or gloo on the CPU.
    ``fn`` must be a module-level function (it is pickled by name); inside
    it ``make_mesh(device=...)`` returns the rank's mesh.  Returns the
    ranks' return values in rank order (pickled: return host values).

    The ranks meet through a file in a fresh temporary directory, so
    concurrent worlds never race for a port, and each takes its share of
    the caller's intra-op threads.  A collective waits at most
    ``GROUP_TIMEOUT_S`` for a rank that died.  When a rank fails (raises,
    or ends with no result), the others get ``GRACE_S`` to report, the
    world is killed and the first failure's exception raised here, with
    its rank and traceback in a note; when ``timeout_s`` passes first
    (None: no deadline), every rank is killed and ``TimeoutError``
    raised."""
    dev = get_device(device)
    if n < 1:
        raise ValueError(f"a world needs at least one rank, not {n}")
    if dev.type == "cuda":
        _check_cards(n)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="avatar_world_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    threads = max(1, torch.get_num_threads() // n)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, dev.type, init, threads, args,
                               results)) for r in range(n)]
    done, failed, gone = {}, {}, {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        with _sigint_left_to_ranks():
            while len(done) + len(failed) < n:
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    break
                try:
                    rank, ok, payload = results.get(
                        timeout=1.0 if left is None else min(1.0, left))
                except queue_mod.Empty:
                    # a rank that ended without a word (killed, crashed or
                    # exited before it could report), once its last
                    # message has had time to arrive
                    now = time.time()
                    for r, p in enumerate(procs):
                        if r in done or r in failed or p.exitcode is None:
                            continue
                        if now - gone.setdefault(r, now) > 2.0:
                            failed[r] = (gone[r], None,
                                         f"rank {r} ended with exit code "
                                         f"{p.exitcode} and no result")
                else:
                    if ok:
                        done[rank] = pickle.loads(payload)
                    else:
                        failed.setdefault(rank, payload)
                if failed:
                    end = time.monotonic() + GRACE_S
                    deadline = end if deadline is None else \
                        min(deadline, end)
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        rank = min(failed, key=lambda r: failed[r][0])
        _, blob, tb = failed[rank]
        exc = pickle.loads(blob) if blob is not None else RuntimeError(
            f"rank {rank} of a world of {n} failed")
        exc.add_note(f"raised on rank {rank} of a world of {n}:\n{tb}")
        raise exc
    if len(done) < n:
        missing = sorted(set(range(n)) - set(done))
        raise TimeoutError(f"a world of {n} ranks did not finish within "
                           f"{timeout_s} s (ranks {missing} still running); "
                           "killed")
    return [done[r] for r in range(n)]


# ---------------------------------------------------------------------------
# collectives over the mesh's leading axis
# ---------------------------------------------------------------------------


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's ({mesh.axis!r})")


def _shard(mesh: Mesh, a):
    """The rank's contiguous block of ``a``'s leading axis."""
    n = a.shape[0]
    if n % mesh.size:
        raise ValueError(f"the leading axis ({n}) does not divide by the "
                         f"mesh size ({mesh.size})")
    k = n // mesh.size
    return a[mesh.rank * k:(mesh.rank + 1) * k]


def _gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's block along the leading axis, in rank order (bool
    travels as uint8: gloo does not gather every dtype)."""
    send = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def _reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    """``t`` reduced over the ranks by ``op``, in place when contiguous."""
    t = t.contiguous()
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite the contiguous ``t`` in place with rank ``src``'s.  A
    tensor off the mesh's device type (a host frame cache under NCCL) goes
    through the device in slabs of its leading axis."""
    if t.device.type != mesh.device.type:
        step = max(1, (1 << 28) // max(1, t[0].numel() * t.element_size()))
        for s in range(0, t.shape[0], step):
            buf = t[s:s + step].to(mesh.device)
            broadcast_(mesh, buf, src)
            t[s:s + step].copy_(buf)
        return t
    # bool and int16 travel as their bytes
    flat = t.view(torch.uint8) if t.dtype in (torch.bool, torch.int16) else t
    dist.broadcast(flat, src, group=mesh.group)
    return t


def _tree(fn, *xs):
    """``fn`` over the leaves (tensors) of equally built NamedTuples."""
    if isinstance(xs[0], tuple):
        return type(xs[0])(*(_tree(fn, *parts) for parts in zip(*xs)))
    return fn(*xs)


# ---------------------------------------------------------------------------
# the sharded functions
# ---------------------------------------------------------------------------


def sharded_render_batch(mesh: Mesh, src: synth.SynthSource, parents,
                         image_ids, seed: int, height: int, width: int,
                         n_keys: int, axis: str = "data"):
    """Render a batch of synthetic frames with the image axis sharded over
    the mesh: (depth, part_mask, joints), each gathered.  ``image_ids``'
    length must divide by the mesh size."""
    _check_axis(mesh, axis)
    out = synth.render_batch(src, parents, _shard(mesh, image_ids), seed,
                             height, width, n_keys)
    return tuple(_gather(mesh, t) for t in out)


def sharded_count_step(mesh: Mesh, parents, src: synth.SynthSource,
                       image_ids, sx, sy, part, valid, node_local, fu, fv,
                       n_chunk: int, n_buckets: int, n_parts: int,
                       seed: int, height: int, width: int, n_keys: int,
                       axis: str = "data"):
    """One whole distributed count step: each rank renders its block of
    the image batch and scores its samples; score min/max are reduced
    (MIN, MAX) before the histogram, whose counts are summed.  Returns the
    replicated (counts, smin, smax), which the host bookkeeping consumes as
    it does the one-device pass's."""
    _check_axis(mesh, axis)
    depth, _, _ = synth.render_batch(src, parents, _shard(mesh, image_ids),
                                     seed, height, width, n_keys)
    sx, sy, part, valid, node_local = (
        _shard(mesh, a) for a in (sx, sy, part, valid, node_local))
    smin, smax = forest_mod.pass_minmax(depth, sx, sy, valid, node_local, fu,
                                        fv, n_chunk)
    smin = _reduce(mesh, smin, dist.ReduceOp.MIN)
    smax = _reduce(mesh, smax, dist.ReduceOp.MAX)
    counts = forest_mod.pass_counts(depth, sx, sy, part, valid, node_local,
                                    fu, fv, smin, smax, n_chunk, n_buckets,
                                    n_parts)
    return _reduce(mesh, counts, dist.ReduceOp.SUM), smin, smax


def sharded_pass_minmax(mesh: Mesh, depth, sx, sy, valid, node_local, fu,
                        fv, n_chunk: int, axis: str = "data"):
    """Per-(node, feature) score min/max over one image batch, the batch
    sharded over the mesh and the result reduced: equal to the one-device
    pass to the bit."""
    _check_axis(mesh, axis)
    mn, mx = forest_mod.pass_minmax(
        *(_shard(mesh, a) for a in (depth, sx, sy, valid, node_local)), fu,
        fv, n_chunk)
    return (_reduce(mesh, mn, dist.ReduceOp.MIN),
            _reduce(mesh, mx, dist.ReduceOp.MAX))


def sharded_pass_counts(mesh: Mesh, depth, sx, sy, part, valid, node_local,
                        fu, fv, smin, smax, n_chunk: int, n_buckets: int,
                        n_parts: int, axis: str = "data"):
    """Histogram counts over one image batch, the batch sharded over the
    mesh and the per-rank counts summed: whole numbers in float32, so the
    sum is exact and the trained tree is the one-device tree."""
    _check_axis(mesh, axis)
    c = forest_mod.pass_counts(
        *(_shard(mesh, a) for a in (depth, sx, sy, part, valid, node_local)),
        fu, fv, smin, smax, n_chunk, n_buckets, n_parts)
    return _reduce(mesh, c, dist.ReduceOp.SUM)


def sharded_pass_assign(mesh: Mesh, depth, sx, sy, valid, node, best_u,
                        best_v, best_thresh, lchild, rchild, is_split,
                        axis: str = "data"):
    """Split routing, each rank its block of images; the new node ids are
    gathered."""
    _check_axis(mesh, axis)
    out = forest_mod.pass_assign(
        *(_shard(mesh, a) for a in (depth, sx, sy, valid, node)), best_u,
        best_v, best_thresh, lchild, rchild, is_split)
    return _gather(mesh, out)


def sharded_multistream_lbs(mesh: Mesh, lbs_params, parents, w, p, rots,
                            axis: str = "data"):
    """LBS over a batch of streams' poses sharded over the mesh: (cloud,
    joints, Rg, j_init), each gathered."""
    _check_axis(mesh, axis)
    out = lbs_batched(lbs_params, parents, _shard(mesh, w), _shard(mesh, p),
                      _shard(mesh, rots))
    return tuple(_gather(mesh, t) for t in out)


def sharded_track_step(mesh: Mesh, ctx, ctx_fit, tree, parents, depth_b,
                       labels_b, bg_depth, intrin4, thetas_b, com_b,
                       frame_kwargs: dict, axis: str = "data",
                       thetas_prev_b=None):
    """One fused tracking step for S independent camera streams, sharded
    over the mesh (multi-camera serving; no cross-stream collectives).

    depth_b [S, Hs, Ws], labels_b [S, Hs, Ws] uint8, thetas_b a Theta with
    a leading stream axis, com_b [S, 2, G]; frame_kwargs the keyword
    arguments of ``tracking_fused._fused_frame_impl`` after ``com_pre``.
    S must divide by the mesh size.  Each rank runs its streams one by one
    through the eager frame (it reads flags from the device, so there is no
    vmap); every field of the ``FrameOut`` is gathered, with the stream
    axis.  ``thetas_prev_b``: each stream's velocity anchor, the
    ``theta_prev`` that ``FusedTracker`` passes for its warm start; None,
    as in the reference's step, extrapolates nothing."""
    _check_axis(mesh, axis)
    depth, labels, com = (_shard(mesh, a) for a in (depth_b, labels_b,
                                                     com_b))
    thetas = _tree(lambda a: _shard(mesh, a), thetas_b)
    prev = (None if thetas_prev_b is None
            else _tree(lambda a: _shard(mesh, a), thetas_prev_b))
    outs = []
    for s in range(depth.shape[0]):
        kw = dict(frame_kwargs)
        if prev is not None:
            kw["theta_prev"] = _tree(lambda a: a[s], prev)
        outs.append(_fused_frame_impl(
            ctx, ctx_fit, tree, parents, depth[s], labels[s], bg_depth,
            intrin4, _tree(lambda a: a[s], thetas), com[s], **kw))
    local = _tree(lambda *a: torch.stack(a), *outs)
    return _tree(lambda t: _gather(mesh, t), local)
