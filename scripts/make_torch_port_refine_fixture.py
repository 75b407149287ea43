"""Write the accuracy-mode fixture that chip_smoke.py holds the port to.

Runs the JAX package on the CPU with the recipe of ``bench.py`` and
``scripts/make_torch_port_fixture.py`` (1280x720, K4A intrinsics,
``synthetic_model(detail=6)``, ``randomize(seed=77)``, motion rng 8, a
wall at 4 m, the 3-tree r5 forest, the fit on its planned part-sorted NN
in interpret mode), checks that its rendered frames equal that fixture's
``depth``, and stores:

* ``gt_p`` [F, 3], ``gt_rots`` [F, 24, 3, 3], ``gt_w`` [F, K]: the ground
  truth pose of every frame, so a port can render the frames itself;
* ``part_mask0`` [720, 1280] uint8: frame 0's rendered part mask;
* ``probe_p``, ``probe_rots``, ``probe_w`` and ``probe_fit_rmse_mm``:
  bench.py's converged-fit probe (``fit_refine``, 20 steps from the ground
  truth, priors 1e-4, frame 0's oracle-labelled stride-6 samples);
* ``state_*`` before every frame (as in the other fixture), ``ref_joints``
  and ``ref_ok`` after it, tracked with ``refine_every=1,
  refine_steps=2`` (accuracy mode).

    JAX_PLATFORMS=cpu python scripts/make_torch_port_refine_fixture.py
"""

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_torch_port_fixture import capture_state, planned_nn  # noqa: E402

H, W = 720, 1280
DATA_INTERVAL = 6
CFG = dict(data_interval=DATA_INTERVAL, min_points=1000, frame_icp_iters=2,
           reinit_icp_iters=6, initial_icp_iters=7, iters_per_icp=4,
           label_conf_thresh=0.55, rtree_interval=3, refine_every=1,
           refine_steps=2)


def probe_samples(depth_mm, mask, intrin, stride, glut=None):
    """bench.py's fit_rmse_mm probe samples: frame 0's oracle-labelled
    stride samples (labels folded into group space), padded to a power of
    two >= 1024 with label -1."""
    d0 = depth_mm[::stride, ::stride].astype(np.float32) * 1e-3
    m0 = np.asarray(mask)[::stride, ::stride]
    ys = np.arange(d0.shape[0]) * stride
    xs = np.arange(d0.shape[1]) * stride
    sub = np.stack([(xs[None, :] - intrin.cx) * d0 / intrin.fx,
                    -(ys[:, None] - intrin.cy) * d0 / intrin.fy, d0], -1)
    fgm = (m0 != 255) & (d0 > 0)
    n0 = int(fgm.sum())
    b0 = 1024
    while b0 < n0:
        b0 *= 2
    pts = np.zeros((b0, 3), np.float32)
    pts[:n0] = sub[fgm]
    parts = np.full(b0, -1, np.int32)
    parts[:n0] = m0[fgm]
    if glut is not None:
        parts[:n0] = np.asarray(glut)[parts[:n0]]
    return pts, parts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out",
                    default="tests/fixtures/torch_port_720p_refine.npz")
    ap.add_argument("--frames", type=int, default=6)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from avatar_tpu.core import rotation
    from avatar_tpu.core.lbs import lbs
    from avatar_tpu.core.model import Avatar
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.optim.gauss_newton import Theta, fit_refine
    from avatar_tpu.optim.surface import vertex_face_rings
    from avatar_tpu.perception.partgroups import SMPL24_GROUP_LUT
    from avatar_tpu.perception.rtree import RTree
    from avatar_tpu.render.renderer import AvatarRenderer
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker

    intrin = CameraIntrin(fx=606.438, fy=606.351, cx=637.294, cy=366.992)
    model = synthetic_model(detail=6)

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

    frames, gts, poses, mask0, verts0 = [], [], [], None, None
    for t in range(args.frames):
        gt.update()
        rend = AvatarRenderer(gt, intrin)
        depth = rend.render_depth((H, W))
        if t == 0:
            mask0 = np.asarray(rend.render_part_mask((H, W)), np.uint8)
            verts0 = gt.cloud.copy()
        frames.append((np.where(depth > 0, depth, bg_depth) * 1000).astype(
            np.uint16))
        gts.append(gt.joint_pos.copy())
        poses.append((gt.p.copy(), gt.r.copy(), gt.w.copy()))
        wig = amp * np.sin(freq * (t + 1) + phase)
        step = np.asarray(rotation.so3_exp(jnp.asarray(wig, jnp.float32)))
        gt.r = np.einsum("jab,jbc->jac", step, base_r)
        gt.p = base_p + np.array([0.25 * np.sin(0.2 * (t + 1)), 0.0,
                                  0.15 * np.sin(0.13 * (t + 1))])
    other = np.load(os.path.join(ROOT, "tests", "fixtures",
                                 "torch_port_720p.npz"))
    if not np.array_equal(np.stack(frames), other["depth"][:args.frames]):
        sys.exit("rendered frames differ from torch_port_720p.npz's depth")
    print(f"rendered {len(frames)} frames (equal to the tracking fixture's)",
          file=sys.stderr)

    trees = [RTree(os.path.join(ROOT, "data", f"bench_forest_r5{s}.srtr"))
             for s in ("", "_1", "_2")]
    for t in trees:
        t.partmap_type = 0
    cfg = TrackerConfig(**CFG, part_groups=tuple(SMPL24_GROUP_LUT))
    ref_joints, ref_ok, states = [], [], []
    with planned_nn():
        tracker = FusedTracker(model, intrin, (H, W), rtree=trees,
                               config=cfg)
        tracker.set_background(bg_depth)

        # bench.py's converged-fit probe on frame 0
        t0 = time.perf_counter()
        pts, parts = probe_samples(frames[0], mask0, intrin, DATA_INTERVAL,
                                   tracker._glut)
        p0, r0, w0 = poses[0]
        theta_gt = Theta(p=jnp.asarray(p0, jnp.float32),
                         rots=jnp.asarray(r0, jnp.float32),
                         w=jnp.asarray(w0, jnp.float32))
        ring = jnp.asarray(vertex_face_rings(np.asarray(model.faces),
                                             model.num_points()))
        probe, _ = fit_refine(tracker._ctx, model.parents, ring,
                              jnp.asarray(pts), jnp.asarray(parts), theta_gt,
                              jnp.asarray(1e-4, jnp.float32),
                              jnp.asarray(1e-4, jnp.float32), n_steps=20,
                              num_parts=tracker.num_parts)
        v = np.asarray(lbs(model.params, model.parents, probe.w, probe.p,
                           probe.rots)[0])
        rmse = float(np.sqrt(np.mean(np.sum((v - verts0) ** 2, 1))) * 1e3)
        print(f"probe: {int((parts >= 0).sum())} samples, fit_rmse_mm "
              f"{rmse:.4f} ({time.perf_counter() - t0:.1f} s)",
              file=sys.stderr)

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
        args.out,
        gt_p=np.stack([p for p, _, _ in poses]),
        gt_rots=np.stack([r for _, r, _ in poses]),
        gt_w=np.stack([w for _, _, w in poses]),
        part_mask0=mask0,
        probe_p=np.asarray(probe.p), probe_rots=np.asarray(probe.rots),
        probe_w=np.asarray(probe.w), probe_fit_rmse_mm=np.float64(rmse),
        ref_joints=np.stack(ref_joints), ref_ok=np.asarray(ref_ok),
        **{k: np.stack([st[k] for st in states]) for k in states[0]})
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
