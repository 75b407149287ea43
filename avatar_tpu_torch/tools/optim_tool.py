"""Synthetic ground-truth optimizer validator (counterpart of
``avatar_tpu/tools/optim_tool.py``), on ``--device`` (the card by default).

Rebuild of reference optim.cpp:18-156 (disabled there after API drift):
render a randomized ground-truth avatar to depth, back-project the
foreground to a labeled point cloud, perturb a copy of the avatar, fit it
back with ``AvatarOptimizer`` and report pose/vertex recovery errors.  The
data cloud is padded to at least 1024 rows, so the fit takes the planned
part-sorted NN (the hand-written kernel on the card).

    python -m avatar_tpu_torch.tools.optim_tool --synthetic-model 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.core.model import Avatar
from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.optim.optimizer import AvatarOptimizer
from avatar_tpu_torch.render.renderer import AvatarRenderer
from avatar_tpu_torch.tools.common import add_model_args, load_model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--interval", type=int, default=4,
                    help="data sampling stride")
    ap.add_argument("--icp-iters", type=int, default=10)
    ap.add_argument("--perturb-rot", type=float, default=0.06,
                    help="per-joint axis-angle perturbation stddev (rad)")
    ap.add_argument("--perturb-pos", type=float, default=0.03)
    ap.add_argument("--betapose", type=float, default=0.05)
    ap.add_argument("--betashape", type=float, default=0.12)
    add_model_args(ap)
    args = ap.parse_args(argv)

    model = load_model(args)
    H, W = (int(x) for x in args.size.split("x"))
    intrin = CameraIntrin(fx=0.8 * W, fy=0.8 * W, cx=W / 2, cy=H / 2)

    gt = Avatar(model)
    gt.randomize(seed=args.seed)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.0, 2.5])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    gt.update()
    rend = AvatarRenderer(gt, intrin)
    depth = rend.render_depth((H, W))
    mask = rend.render_part_mask((H, W))

    iv = args.interval
    ys, xs = np.nonzero((depth > 0) & (mask != 255))
    sel = (ys % iv == 0) & (xs % iv == 0)
    ys, xs = ys[sel], xs[sel]
    z = depth[ys, xs]
    data = np.stack([(xs - intrin.cx) * z / intrin.fx,
                     -((ys - intrin.cy) * z / intrin.fy), z], 1)
    labels = mask[ys, xs].astype(np.int32)

    rng = np.random.default_rng(args.seed + 1)
    ava = Avatar(model)
    ava.p = gt.p + rng.normal(0, args.perturb_pos, 3)
    pert = rng.normal(0, args.perturb_rot, (model.num_joints(), 3))
    # the host draw through Rodrigues in float32, as the reference does
    ava.r = np.einsum("jab,jbc->jac", rotation.so3_exp(torch.as_tensor(
        pert, dtype=torch.float32)).numpy(), gt.r)
    ava.update()

    pre = np.sqrt(((ava.cloud - gt.cloud) ** 2).sum(1).mean())
    opt = AvatarOptimizer(ava, intrin, (H, W))
    opt.beta_pose = args.betapose
    opt.beta_shape = args.betashape
    opt.max_iters_per_icp = 1
    info = opt.optimize(data, labels, icp_iters=args.icp_iters * 10)
    post = np.sqrt(((ava.cloud - gt.cloud) ** 2).sum(1).mean())
    jerr = np.linalg.norm(ava.joint_pos - gt.joint_pos, axis=1).mean()
    print(f"data points: {len(data)}")
    print(f"vertex RMSE: {pre * 1e3:.2f} mm -> {post * 1e3:.2f} mm")
    print(f"mean joint error: {jerr * 1e3:.2f} mm")
    print(f"fit: {info}")
    return post


if __name__ == "__main__":
    main()
