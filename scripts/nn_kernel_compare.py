#!/usr/bin/env python3
"""Time an earlier source of the NN argmin kernel against the current one,
in one process on one card, in turns (old, new, new, old).

    git show <commit>:avatar_tpu_torch/csrc/nn_argmin.cu > /tmp/old.cu
    python3 scripts/nn_kernel_compare.py --old /tmp/old.cu

The earlier source is the single-kernel design (one C entry point,
``avatar_nn_argmin_ranges`` with 9 pointers, 5 ints and the stream); it is
driven here through a copy of the wrapper and of the
``find_nn_stats_planned`` body it shipped with, so their host cost is
measured too.  Needs one CUDA device and nvcc; imports nothing of JAX.

For each of ``chip_smoke.py``'s five phase-3 shapes, and for one search as
each path issues it (the fused tracker's steady frame, the refine probe,
the host tracker; recorded from a short run of each), it prints per
version:

* ``device_ms``: CUDA events around 50 launches queued behind a busy
  device, over 50, median of 7 (the host's enqueue cost is outside);
* ``host_us``: the host clock around 50 wrapper calls, no synchronise;
* ``call_ms``: events around one call on an idle device, median of 20;

then the same for one whole planned search (the earlier torch body around
the earlier kernel against the fused entry), with the device launches per
search counted by ``torch.profiler``.  Both versions must give the same
indices and distances to the bit.  ``--json PATH`` also writes a record of
all numbers there.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def build_old(src: str):
    from avatar_tpu_torch import build_cache
    from avatar_tpu_torch.optim import nn_kernel

    out = nn_kernel._BUILD / "libnn_argmin_old.so"
    nn_kernel._BUILD.mkdir(exist_ok=True)
    proc = subprocess.run([build_cache.nvcc(), *build_cache.NVCC_FLAGS, "-o",
                           str(out), src], capture_output=True, text=True)
    if proc.returncode != 0:
        cs.fail(f"nvcc failed on {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).avatar_nn_argmin_ranges
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def old_wrapper(fn):
    """The wrapper the single-kernel source shipped with: every argument
    checked on every call, the device context, the full range as tensors."""
    import torch

    def check(data_pts, data_part, model_pts, model_part, model_valid,
              cstart, cend, tile_n, chunk):
        dev = data_pts.device
        N, Pp = data_pts.shape[0], model_pts.shape[0]
        want = [("data_pts", data_pts, torch.float32, (N, 3)),
                ("data_part", data_part, torch.int32, (N,)),
                ("model_pts", model_pts, torch.float32, (Pp, 3)),
                ("model_part", model_part, torch.int32, (Pp,)),
                ("model_valid", model_valid, torch.bool, (Pp,)),
                ("cstart", cstart, torch.int32, (N // tile_n,)),
                ("cend", cend, torch.int32, (N // tile_n,))]
        for name, t, dtype, shape in want:
            if t.device != dev or t.dtype != dtype or \
                    tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(name)
        if N == 0 or N % tile_n or tile_n % 64 or Pp % chunk:
            raise ValueError("shape")

    def ranges(data_pts, data_part, model_pts, model_part, model_valid,
               cstart, cend, tile_n=256, chunk=512, wild=-1000):
        if cstart is None:
            T = data_pts.shape[0] // tile_n
            cstart = torch.zeros(T, dtype=torch.int32,
                                 device=data_pts.device)
            cend = torch.full((T,), model_pts.shape[0] // chunk,
                              dtype=torch.int32, device=data_pts.device)
        check(data_pts, data_part, model_pts, model_part, model_valid,
              cstart, cend, tile_n, chunk)
        N, Pp = data_pts.shape[0], model_pts.shape[0]
        best_d = torch.empty(N, dtype=torch.float32, device=data_pts.device)
        best_i = torch.empty(N, dtype=torch.int32, device=data_pts.device)
        with torch.cuda.device(data_pts.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(data_pts.data_ptr(), data_part.data_ptr(),
                    model_pts.data_ptr(), model_part.data_ptr(),
                    model_valid.data_ptr(), cstart.data_ptr(),
                    cend.data_ptr(), best_d.data_ptr(), best_i.data_ptr(),
                    N, Pp, tile_n, chunk, wild, stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return best_d, best_i

    return ranges


def old_planned(ranges):
    """The body of ``find_nn_stats_planned`` around the single kernel."""
    import torch

    def search(m, model_cloud, visible, wild, wild_gate2):
        P, dtype, dev = model_cloud.shape[0], model_cloud.dtype, \
            model_cloud.device
        center = torch.mean(model_cloud, dim=0)
        if m.mperm is None:
            pad = m.mpart.shape[0] - P
            xs = model_cloud - center
            vis_s = visible
            if pad:
                xs = torch.cat([xs, torch.zeros((pad, 3), dtype=dtype,
                                                device=dev)])
                vis_s = torch.cat([vis_s, torch.zeros(
                    pad, dtype=torch.bool, device=dev)])
        else:
            perm = m.mperm.long()
            xs = (model_cloud - center)[perm]
            vis_s = visible[perm]
        dpts_c = m.dpts - center
        best_d, best_i = ranges(
            dpts_c.contiguous(), m.dpart.contiguous(), xs.contiguous(),
            m.mpart.contiguous(), vis_s.contiguous(), m.cstart, m.cend,
            tile_n=m.tile_n, chunk=m.chunk, wild=wild)
        matched = (best_i >= 0) & (m.dpart >= 0)
        if wild_gate2 is not None:
            matched = matched & ((m.dpart != wild) | (best_d <= wild_gate2))
        if m.mperm is None:
            corr = torch.where(matched, best_i, -1)
        else:
            corr = torch.where(matched,
                               m.mperm[best_i.clamp(min=0).long()], -1)
        corr = corr.to(torch.int32)
        wgt = matched.to(dtype)
        return corr, torch.sum(wgt)

    return search


def times(fn, dev):
    return dict(device_ms=cs._device_ms(fn, dev), host_us=cs._host_us(fn),
                call_ms=cs._time_ms(fn))


def in_turns(old, new, dev):
    """old, new, new, old; each reading the mean of its two turns."""
    runs = [times(f, dev) for f in (old, new, new, old)]
    mean = lambda a, b: {k: (a[k] + b[k]) / 2 for k in a}
    return mean(runs[0], runs[3]), mean(runs[1], runs[2])


def path_searches(dev):
    """One recorded search per path: (tag, recorded arguments)."""
    import torch

    scene = cs.Scene(dev)
    out = []
    calls = []
    tracker = scene.tracker()
    with cs._recording(calls):
        for frame in scene.frames[:2]:
            tracker.track(frame)
    out.append(("slice steady", calls[-1]))
    calls = []
    with cs._recording(calls):
        cs.phase_probe(scene)
    out.append(("probe", calls[0]))
    calls = []
    host = cs._host_tracker(scene)
    with cs._recording(calls):
        for frame in scene.frames[:2]:
            host.track(scene.intrin.depth_to_xyz_np(
                frame.astype(np.float32) * 1e-3))
    out.append(("host steady", calls[-1]))
    torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="the earlier nn_argmin.cu to compare against")
    ap.add_argument("--json", help="write the numbers to this file")
    opt = ap.parse_args()
    dev = cs.phase_device()
    import torch

    from avatar_tpu_torch.optim import correspond, nn_kernel
    from avatar_tpu_torch.perception.partgroups import SMPL24_NUM_GROUPS
    from avatar_tpu_torch.testing import (synthetic_nn_inputs,
                                          synthetic_nn_stats_inputs)

    torch.use_deterministic_algorithms(True)
    cs.phase_build()
    old_ranges = old_wrapper(build_old(opt.old))
    old_search = old_planned(old_ranges)
    wild = SMPL24_NUM_GROUPS

    cases = []
    for n_rows in (8192, 32768):
        a = synthetic_nn_inputs(n_rows, seed=n_rows, device=dev)
        cases += [(f"B1 N={n_rows} Pp=6656 chunk=512", a, dict(chunk=512)),
                  (f"B2 N={n_rows} Pp=6656 chunk=512", a[:5] + (None, None),
                   dict(chunk=512))]
    data, dpart, verts, part, visible = synthetic_nn_stats_inputs(
        8192, device=dev)
    center = verts.mean(0)
    unplanned = correspond.unplanned_match(data, dpart, part)
    cases.append(("B2 N=8192 Pp=7168 chunk=1024 (find_nn_stats)",
                  nn_kernel.match_inputs(unplanned, verts, center, visible),
                  dict(chunk=1024)))
    searches = path_searches(dev)
    for tag, (m, cloud, c, vis, w, gate) in searches:
        cases.append((f"{tag}: N={m.n} Pp={m.pp} chunk={m.chunk}",
                      nn_kernel.match_inputs(m, cloud, c, vis),
                      dict(chunk=m.chunk, tile_n=m.tile_n, wild=w)))

    record = {"raw": [], "planned": []}
    for tag, a, kw in cases:
        kw = dict(dict(wild=wild), **kw)
        got_old, got_new = old_ranges(*a, **kw), \
            nn_kernel.nn_argmin_ranges(*a, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got_old[0], got_new[0]) and
                torch.equal(got_old[1], got_new[1])):
            cs.fail(f"{tag}: the two versions disagree")
        t_old, t_new = in_turns(lambda: old_ranges(*a, **kw),
                                lambda: nn_kernel.nn_argmin_ranges(*a, **kw),
                                dev)
        bound_ms, _ = cs._bound(list(a), kw)
        pairs = cs._pairs(list(a), kw)
        print(f"[compare] {tag}: {pairs} pairs, bound {bound_ms * 1e3:.3f} "
              "us; equal to the bit", flush=True)
        for name, t in (("old", t_old), ("new", t_new)):
            print(f"[compare]   {name}: device_ms {t['device_ms']:.5f}, "
                  f"host_us {t['host_us']:.2f}, call_ms {t['call_ms']:.4f}",
                  flush=True)
        record["raw"].append(dict(case=tag, pairs=pairs, bound_ms=bound_ms,
                                  old=t_old, new=t_new))

    plan = correspond.make_nn_plan(data, dpart, part, num_parts=wild)
    gate2 = torch.tensor(0.04, device=dev)
    planned = [("synthetic N=8192, unsorted model",
                (plan.match, verts, center, visible, wild, gate2))] + searches
    todo = []
    for tag, (m, cloud, c, vis, w, gate) in planned:
        def old(m=m, cloud=cloud, vis=vis, w=w, gate=gate):
            return old_search(m, cloud, vis, w, gate)

        def new(m=m, cloud=cloud, vis=vis, w=w, gate=gate):
            return nn_kernel.nn_match(m, cloud, torch.mean(cloud, dim=0),
                                      vis, w, gate)
        corr_old, n_old = old()
        _, corr_new, _, n_new = new()
        torch.cuda.synchronize()
        if not torch.equal(corr_old, corr_new) or float(n_old) != \
                float(n_new):
            cs.fail(f"planned search {tag}: the two versions disagree")
        t_old, t_new = in_turns(old, new, dev)
        print(f"[compare] one planned search, {tag} (N={m.n}): corr and "
              "n_matched equal", flush=True)
        for name, t in (("old", t_old), ("new", t_new)):
            print(f"[compare]   {name}: device_ms {t['device_ms']:.5f}, "
                  f"host_us {t['host_us']:.2f}, call_ms {t['call_ms']:.4f}",
                  flush=True)
        record["planned"].append(dict(case=tag, n=m.n, old=t_old, new=t_new))
        todo.append((old, new))
    # the profiler last: once it has run, every launch costs the host more
    for entry, (old, new) in zip(record["planned"], todo):
        counts = []
        for f in (old, new):
            prof = cs._profiled(f)
            counts.append(sum(c for c, _ in prof.values()) if prof else None)
        entry["launches_old"], entry["launches_new"] = counts
        print(f"[compare] device launches per planned search, "
              f"{entry['case']}: old {counts[0]}, new {counts[1]}",
              flush=True)
    if opt.json:
        with open(opt.json, "w") as f:
            json.dump(record, f, indent=1)
    print("[compare] done", flush=True)


if __name__ == "__main__":
    main()
