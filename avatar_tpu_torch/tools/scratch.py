"""Visual scratchpad: posed avatar as a 3D point cloud with its skeleton
(counterpart of ``avatar_tpu/tools/scratch.py``); the avatar is posed on
``--device``, the card by default, and plotted on the host.

Rebuild of reference scratch.cpp (a PCL-visualizer playground whose active
code displays a randomized avatar; scratch.cpp:40-120).  PCL's viewer role
is played by a matplotlib 3D scatter: avatar surface points colored by
body part, joints and kinematic-tree bones overlaid.  Headless use saves a
PNG; with a display it opens an interactive rotatable view.

The reference's AvatarPCL conversion helpers (Avatar -> pcl::PointCloud)
have no equivalent here by design: point clouds are plain numpy/torch
``[N, 3]`` arrays throughout this framework, so there is nothing to
convert (see README parity table).

    python -m avatar_tpu_torch.tools.scratch --synthetic-model 2 --random 5
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from avatar_tpu_torch.core.model import Avatar
from avatar_tpu_torch.tools.common import add_model_args, load_model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--out", default="scratch.png")
    ap.add_argument("--random", type=int, default=0, metavar="SEED")
    ap.add_argument("--pos", default="0,0,2.5")
    add_model_args(ap)
    args = ap.parse_args(argv)

    model = load_model(args)
    ava = Avatar(model)
    if args.random:
        ava.randomize(seed=args.random)
    ava.p = np.asarray([float(x) for x in args.pos.split(",")])
    ava.update()

    import matplotlib

    headless = not os.environ.get("DISPLAY")
    if headless:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    from avatar_tpu_torch.utils import palette_color_table

    table = palette_color_table(max(model.num_joints(), 17))
    colors = table[np.asarray(model.main_joint) % len(table)]
    ax.scatter(ava.cloud[:, 0], ava.cloud[:, 2], ava.cloud[:, 1], s=1,
               c=colors)
    J = ava.joint_pos
    ax.scatter(J[:, 0], J[:, 2], J[:, 1], s=30, c="k", marker="o")
    for j, p in enumerate(model.parents):
        if p >= 0:
            ax.plot([J[j, 0], J[p, 0]], [J[j, 2], J[p, 2]],
                    [J[j, 1], J[p, 1]], "k-", lw=1)
    ax.set_box_aspect((1, 1, 1))
    ax.set_title("avatar_tpu_torch scratch")
    if headless:
        fig.savefig(args.out, dpi=110)
        print(f"wrote {args.out}")
    else:  # pragma: no cover - needs a display
        plt.show()


if __name__ == "__main__":
    main()
