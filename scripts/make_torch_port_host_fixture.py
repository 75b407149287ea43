"""Write the host-tracker reference that chip_smoke.py holds the PyTorch
port's ``Tracker`` to.

Runs the JAX package's host ``Tracker`` (``avatar_tpu/tracking.py``:
background subtraction, ``RTree.predict_best`` / ``post_process``, the
reinit state machine and ``AvatarOptimizer``) on the CPU over the frames
of ``tests/fixtures/torch_port_720p.npz``: XYZ from
``CameraIntrin.depth_to_xyz_np`` of the uint16 depth, the flat wall at
``bg_depth_m`` as the background, bench.py's tracker config and the r5
forest (``data/bench_forest_r5.srtr``, part-map type 0).  The fit runs the
planned part-sorted NN path (the Pallas kernel in interpret mode), as the
port's bucketed fit does.

Output (``np.savez_compressed``; the frames are not copied): per frame,
``ref_joints`` [F, 24, 3] after it, ``ref_ok``, ``ref_reinit``,
``ref_n_points``, ``ref_n_matched``, and the tracker's state before it:
``state_p`` [F, 3], ``state_r`` [F, 24, 3, 3], ``state_w`` [F, K],
``state_com_pre`` [F, 2, parts], ``state_reinit``, ``state_first_init``.
Also ``reinit8_joints`` [24, 3]: frame 0's reinit fit cut to its first
``REINIT8_ICP`` x ``iters_per_icp`` = 8 LM steps (the same samples and
start pose).  Past those steps that cold-start fit is ill-conditioned
enough for two float32 implementations to land centimetres apart, so a
port is held to this part of it.  ``--witness`` shows that without the
port: it writes nothing, and runs the reference's frame 0 reinit fit
against itself from inputs one float32 ulp apart, cut to the 8 steps and
in full, printing how far apart the joints land.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_host_fixture.py
    JAX_PLATFORMS=cpu python scripts/make_torch_port_host_fixture.py --witness
"""

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from make_torch_port_fixture import planned_nn  # noqa: E402

# bench.py's tracker config (chip_smoke.py's BENCH_CFG); the host tracker
# reads the fields it has and ignores the fused tracker's
BENCH_CFG = dict(data_interval=6, min_points=1000, frame_icp_iters=2,
                 reinit_icp_iters=6, initial_icp_iters=7, iters_per_icp=4,
                 label_conf_thresh=0.55, rtree_interval=3)
REINIT8_ICP = 2


def _ulp(a: np.ndarray) -> np.ndarray:
    """``a`` moved one float32 ulp up, in its own dtype."""
    return np.nextafter(a.astype(np.float32), np.float32(np.inf)).astype(
        a.dtype)


def witness(optimizer, model, inputs, icp_iters: int) -> None:
    """The reference's frame 0 reinit fit against itself: the recorded
    samples and start pose, and the same with the root position or every
    sample moved one float32 ulp."""
    from avatar_tpu.core.model import Avatar

    optimize = type(optimizer).optimize
    pts, labels, p, r, w = inputs[0]

    def run(pts, p, icp):
        ava = Avatar(model)
        ava.p, ava.r, ava.w = p.copy(), r.copy(), w.copy()
        optimizer.ava = ava
        optimize(optimizer, pts, labels, icp_iters=icp)
        return ava.joint_pos.copy()

    steps = optimizer.max_iters_per_icp
    for icp in (REINIT8_ICP, icp_iters):
        base = run(pts, p, icp)
        for name, args in (("root position + 1 ulp", (pts, _ulp(p))),
                           ("samples + 1 ulp", (_ulp(pts), p))):
            d = np.linalg.norm(run(*args, icp) - base, axis=1) * 1e3
            print(f"witness: {icp * steps} LM steps, {name}: joints "
                  f"{d.mean():.4f} mm apart (mean), {d.max():.4f} mm (max)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", default="tests/fixtures/torch_port_720p.npz")
    ap.add_argument("--out",
                    default="tests/fixtures/torch_port_720p_host.npz")
    ap.add_argument("--witness", action="store_true",
                    help="print the reinit fit's sensitivity; write nothing")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from avatar_tpu.core.model import Avatar
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.perception.rtree import RTree
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.tracking import Tracker, TrackerConfig

    fx = np.load(args.frames)
    frames, gt = fx["depth"], fx["gt_joints"]
    H, W = frames.shape[1:]
    intrin = CameraIntrin(*map(float, fx["intrin"]))
    bg_m = float(fx["bg_depth_m"])
    model = synthetic_model(detail=6)
    rtree = RTree("data/bench_forest_r5.srtr")
    rtree.partmap_type = 0

    out = {k: [] for k in ("ref_joints", "ref_ok", "ref_reinit",
                           "ref_n_points", "ref_n_matched", "state_p",
                           "state_r", "state_w", "state_com_pre",
                           "state_reinit", "state_first_init")}
    with planned_nn():
        tracker = Tracker(model, intrin, (H, W), rtree=rtree,
                          config=TrackerConfig(**BENCH_CFG))
        tracker.set_background(intrin.depth_to_xyz_np(
            np.full((H, W), bg_m, np.float32)))
        inputs, optimize = [], tracker.optimizer.optimize

        def record(pts, labels, **kw):
            a = tracker.ava
            inputs.append((pts, labels, a.p.copy(), a.r.copy(), a.w.copy()))
            return optimize(pts, labels, **kw)

        tracker.optimizer.optimize = record
        for i, frame in enumerate(frames[:1] if args.witness else frames):
            t0 = time.perf_counter()
            ava = tracker.ava
            for key, v in (("state_p", ava.p), ("state_r", ava.r),
                           ("state_w", ava.w),
                           ("state_com_pre", tracker.com_pre),
                           ("state_reinit", tracker.reinit),
                           ("state_first_init", tracker.first_init)):
                out[key].append(np.array(v))
            xyz = intrin.depth_to_xyz_np(frame.astype(np.float32) * 1e-3)
            res = tracker.track(xyz)
            out["ref_ok"].append(res.ok)
            out["ref_reinit"].append(res.reinitialized)
            out["ref_n_points"].append(res.n_points)
            out["ref_n_matched"].append(
                res.fit_info["n_matched"] if res.ok else 0)
            out["ref_joints"].append(tracker.ava.joint_pos.copy())
            err = np.linalg.norm(out["ref_joints"][-1] - gt[i], axis=1).mean()
            print(f"frame {i}: ok={res.ok} reinit={res.reinitialized} "
                  f"n_points={res.n_points} joint err {err * 1e3:.2f} mm "
                  f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)
        if args.witness:
            witness(tracker.optimizer, model, inputs,
                    BENCH_CFG["initial_icp_iters"])
            return
        # frame 0's reinit fit, cut short
        pts, labels, p, r, w = inputs[0]
        ava = Avatar(model)
        ava.p, ava.r, ava.w = p, r, w
        tracker.optimizer.ava = ava
        optimize(pts, labels, icp_iters=REINIT8_ICP)
        out["reinit8_joints"] = ava.joint_pos.copy()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out,
                        **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
