"""Write the reference fixture that chip_smoke.py holds the PyTorch port to.

Runs the JAX package on the CPU with the recipe of ``bench.py`` (1280x720,
K4A intrinsics, ``synthetic_model(detail=6)``, ``randomize(seed=77)``,
motion rng 8, a wall at 4 m) and tracks the frames with the JAX
``FusedTracker`` under the bench's tracker config and the committed 3-tree
r5 forest.  By default the fit runs the planned part-sorted NN path (the
Pallas kernel in interpret mode), which is the path the port reproduces;
``--default-nn`` keeps the CPU's unplanned norm-expansion NN instead.

Output (``np.savez_compressed``): ``depth`` [F, 720, 1280] uint16 mm,
``gt_joints`` [F, 24, 3], ``ref_joints`` [F, 24, 3] (the JAX tracker's pose
after each frame), ``ref_ok`` [F], ``bg_depth_m``, ``intrin`` [fx, fy, cx,
cy], ``planned_nn``, and the tracker's state before each frame under
``state_*`` (see ``STATE``), so a port can be put in the reference's state
and compared one frame at a time.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py
"""

import argparse
import contextlib
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# FusedTracker state carried from frame to frame: (npz key, attribute
# path).  None is stored as nan (a depth) or -1 (a countdown).
STATE = (("state_p", "_theta.p"), ("state_rots", "_theta.rots"),
         ("state_w", "_theta.w"), ("state_prev_p", "_theta_prev.p"),
         ("state_prev_rots", "_theta_prev.rots"),
         ("state_prev_w", "_theta_prev.w"), ("state_com_pre", "com_pre"),
         ("state_reinit", "reinit"), ("state_first_init", "first_init"),
         ("state_lost_count", "_lost_count"),
         ("state_lost_frames", "_lost_frames"),
         ("state_last_root_z", "_last_root_z"),
         ("state_frame_no", "_frame_no"),
         ("state_shape_refit_in", "_shape_refit_in"),
         ("state_starve", "_starve"))


def capture_state(tracker, num_parts: int) -> dict:
    """The tracker's per-frame state as numpy (None -> nan / -1)."""
    out = {}
    for key, attr in STATE:
        obj = tracker
        for a in attr.split("."):
            obj = getattr(obj, a, None)
        if attr == "_starve" and obj is None:
            obj = np.zeros(num_parts, np.int32)
        elif attr == "_last_root_z" and obj is None:
            obj = np.nan
        elif attr == "_shape_refit_in" and obj is None:
            obj = -1
        out[key] = np.array(obj)
    return out


@contextlib.contextmanager
def planned_nn():
    """Route ``gauss_newton.fit`` through the part-sorted NN kernel (in
    interpret mode) instead of the CPU's unplanned path."""
    import jax

    from avatar_tpu.optim import correspond, nn_pallas

    enabled, kernel = correspond._pallas_enabled, nn_pallas.nn_argmin_ranges

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return kernel(*args, **kw)

    jax.clear_caches()
    correspond._pallas_enabled = lambda: True
    nn_pallas.nn_argmin_ranges = interpreted
    try:
        yield
    finally:
        correspond._pallas_enabled = enabled
        nn_pallas.nn_argmin_ranges = kernel
        jax.clear_caches()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tests/fixtures/torch_port_720p.npz")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--default-nn", action="store_true",
                    help="keep the CPU's unplanned NN path in the fit")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from avatar_tpu.core import rotation
    from avatar_tpu.core.model import Avatar
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.perception.partgroups import SMPL24_GROUP_LUT
    from avatar_tpu.perception.rtree import RTree
    from avatar_tpu.render.renderer import AvatarRenderer
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker

    H, W = 720, 1280
    intrin = CameraIntrin(fx=606.438, fy=606.351, cx=637.294, cy=366.992)
    model = synthetic_model(detail=6)

    # ground-truth sequence: bench.py's recipe, frame for frame
    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 2.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(8)
    amp = rng.normal(0, 0.10, (24, 3))
    freq = rng.uniform(0.15, 0.5, (24, 3))
    phase = rng.uniform(0, 2 * np.pi, (24, 3))
    base_r = gt.r.copy()
    base_p = gt.p.copy()
    bg_depth = np.full((H, W), 4.0, np.float32)

    frames, gts = [], []
    for t in range(args.frames):
        gt.update()
        depth = AvatarRenderer(gt, intrin).render_depth((H, W))
        scene_d = np.where(depth > 0, depth, bg_depth)
        frames.append((scene_d * 1000).astype(np.uint16))
        gts.append(gt.joint_pos.copy())
        wig = amp * np.sin(freq * (t + 1) + phase)
        step = np.asarray(rotation.so3_exp(jnp.asarray(wig, jnp.float32)))
        gt.r = np.einsum("jab,jbc->jac", step, base_r)
        gt.p = base_p + np.array([0.25 * np.sin(0.2 * (t + 1)), 0.0,
                                  0.15 * np.sin(0.13 * (t + 1))])
    print(f"rendered {len(frames)} frames", file=sys.stderr)

    trees = [RTree(f"data/bench_forest_r5{s}.srtr") for s in ("", "_1", "_2")]
    for t in trees:
        t.partmap_type = 0
    cfg = TrackerConfig(data_interval=6, min_points=1000, frame_icp_iters=2,
                        reinit_icp_iters=6, initial_icp_iters=7,
                        iters_per_icp=4, label_conf_thresh=0.55,
                        rtree_interval=3,
                        part_groups=tuple(SMPL24_GROUP_LUT))
    nn_ctx = contextlib.nullcontext() if args.default_nn else planned_nn()
    ref_joints, ref_ok, states = [], [], []
    with nn_ctx:
        tracker = FusedTracker(model, intrin, (H, W), rtree=trees,
                               config=cfg)
        tracker.set_background(bg_depth)
        for i, frame in enumerate(frames):
            t0 = time.perf_counter()
            states.append(capture_state(tracker, tracker.num_parts))
            res = tracker.track(frame)
            ref_ok.append(res.ok)
            ref_joints.append(tracker.sync_avatar().joint_pos.copy())
            err = np.linalg.norm(ref_joints[-1] - gts[i], axis=1).mean()
            print(f"frame {i}: ok={res.ok} joint err {err * 1e3:.2f} mm "
                  f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(
        args.out, depth=np.stack(frames), gt_joints=np.stack(gts),
        ref_joints=np.stack(ref_joints), ref_ok=np.asarray(ref_ok),
        bg_depth_m=np.float32(4.0),
        intrin=np.asarray([intrin.fx, intrin.fy, intrin.cx, intrin.cy]),
        planned_nn=np.bool_(not args.default_nn),
        **{k: np.stack([st[k] for st in states]) for k in states[0]})
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
