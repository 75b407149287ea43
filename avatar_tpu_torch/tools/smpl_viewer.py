"""Avatar model inspector (headless renders or matplotlib interactive);
counterpart of ``avatar_tpu/tools/smpl_viewer.py``, posing and rendering on
``--device`` (the card by default).

Rebuild of reference smpl-viewer.cpp (meshview/ImGui pose-slider
inspector, smpl-viewer.cpp:7-214): pose/shape set from the CLI, renders
depth / Lambert / part-mask views to image files; ``--interactive`` opens
a matplotlib window with live pose/shape sliders (joint selector + 3
axis-angle sliders + shape-key sliders) and an LBS-weight visualization
toggle, re-rendering on every change — the ImGui panel's functionality on
the matplotlib widget stack.

    python -m avatar_tpu_torch.tools.smpl_viewer --synthetic-model 2 \\
        --pose 18:0.5,0,0 --shape 0:1.5 -o view.png
    python -m avatar_tpu_torch.tools.smpl_viewer --synthetic-model 2 --interactive
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.core.model import Avatar
from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.render.renderer import AvatarRenderer
from avatar_tpu_torch.tools.common import add_model_args, load_model


def _so3_exp(aa) -> np.ndarray:
    """Rodrigues on the host in float32, as the reference evaluates it."""
    return rotation.so3_exp(torch.as_tensor(np.asarray(aa),
                                            dtype=torch.float32)).numpy()


class InteractiveViewer:
    """Pose/shape slider inspector on matplotlib widgets.

    Mirrors smpl-viewer.cpp's ImGui panel: a joint selector with 3
    axis-angle sliders, shape-key sliders, and an LBS-weight color view
    (smpl-viewer.cpp:60-170).  Works with any interactive matplotlib
    backend; in headless use call ``render()``/``set_pose()`` directly (the
    test path) or ``show(out)`` on the Agg backend to save a snapshot.
    """

    N_SHAPE_SLIDERS = 4

    def __init__(self, model, ava, intrin, size, lbs_joint: int = -1):
        self.model = model
        self.ava = ava
        self.intrin = intrin
        self.size = size
        self.joint = 1
        self.lbs_joint = lbs_joint
        self._sliders = []

    # -- model state ------------------------------------------------------

    def set_pose(self, joint: int, axis_angle) -> None:
        self.ava.r[joint] = _so3_exp(axis_angle)
        self.ava.update()

    def set_shape(self, key: int, value: float) -> None:
        self.ava.w[key] = value
        self.ava.update()

    def render(self) -> np.ndarray:
        rend = AvatarRenderer(self.ava, self.intrin)
        if self.lbs_joint >= 0:
            # LBS-weight visualization: per-vertex weight of the selected
            # joint as intensity over the Lambert render
            img = rend.render_lambert(self.size).astype(np.float32)
            w = self.model.weights_np[:, self.lbs_joint]
            # nearest-vertex part-style paint through the part-mask path
            seg = rend.render_part_mask(self.size)
            img = np.stack([img * 0.3] * 3, -1)
            # per-pixel joint weight via main-joint lookup is coarse but
            # fast; highlight pixels whose nearest vertex weights > 0.3
            strong = np.isin(seg, np.nonzero(w > 0.3)[0]) & (seg != 255)
            img[strong, 2] = 255.0
            return img.astype(np.uint8)
        return rend.render_lambert(self.size)

    # -- UI ----------------------------------------------------------------

    def show(self, out: str = "") -> None:
        import matplotlib

        headless = not os.environ.get("DISPLAY")
        if headless:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        fig = plt.figure(figsize=(9, 7))
        ax_img = fig.add_axes([0.02, 0.25, 0.6, 0.72])
        ax_img.set_axis_off()
        self._im = ax_img.imshow(self.render(), cmap="gray")

        J = self.model.num_joints()
        rows = [fig.add_axes([0.68, 0.9 - 0.06 * i, 0.28, 0.03])
                for i in range(4 + self.N_SHAPE_SLIDERS)]
        s_joint = Slider(rows[0], "joint", 0, J - 1, valinit=self.joint,
                         valstep=1)
        s_axes = [Slider(rows[1 + a], f"w{'xyz'[a]}", -np.pi, np.pi,
                         valinit=0.0) for a in range(3)]
        s_shape = [Slider(rows[4 + k], f"shape{k}", -3.0, 3.0,
                          valinit=float(self.ava.w[k]))
                   for k in range(min(self.N_SHAPE_SLIDERS,
                                      self.model.num_shape_keys()))]

        def on_joint(_):
            self.joint = int(s_joint.val)
            aa = rotation.so3_log(torch.as_tensor(
                self.ava.r[self.joint][None], dtype=torch.float32)).numpy()[0]
            for a in range(3):
                s_axes[a].eventson = False
                s_axes[a].set_val(float(aa[a]))
                s_axes[a].eventson = True

        def on_pose(_):
            self.set_pose(self.joint,
                          [s_axes[a].val for a in range(3)])
            self._im.set_data(self.render())
            fig.canvas.draw_idle()

        def on_shape(_):
            for k, s in enumerate(s_shape):
                self.ava.w[k] = s.val
            self.ava.update()
            self._im.set_data(self.render())
            fig.canvas.draw_idle()

        s_joint.on_changed(on_joint)
        for s in s_axes:
            s.on_changed(on_pose)
        for s in s_shape:
            s.on_changed(on_shape)

        if headless:
            fig.savefig(out or "smpl_view.png", dpi=110)
            print(f"wrote {out or 'smpl_view.png'} (no display; "
                  "interactive sliders need a GUI backend)")
        else:  # pragma: no cover - needs a display
            plt.show()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--out", default="smpl_view.png")
    ap.add_argument("--pose", action="append", default=[],
                    help="JOINT:wx,wy,wz axis-angle (repeatable)")
    ap.add_argument("--shape", action="append", default=[],
                    help="KEY:value shape weight (repeatable)")
    ap.add_argument("--pos", default="0,0,2.5", help="root position x,y,z")
    ap.add_argument("--random", type=int, default=0, metavar="SEED",
                    help="randomize pose/shape with this seed")
    ap.add_argument("--mode", default="lambert",
                    choices=["lambert", "depth", "parts"])
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--interactive", action="store_true",
                    help="matplotlib 3D point view instead of a render")
    ap.add_argument("--lbs-weights-of", type=int, default=-1,
                    help="visualize LBS weights of this joint as intensity")
    add_model_args(ap)
    args = ap.parse_args(argv)

    model = load_model(args)
    ava = Avatar(model)
    if args.random:
        ava.randomize(seed=args.random)
    ava.p = np.asarray([float(x) for x in args.pos.split(",")])
    for spec in args.pose:
        j, vals = spec.split(":")
        ava.r[int(j)] = _so3_exp([float(x) for x in vals.split(",")])
    for spec in args.shape:
        k, v = spec.split(":")
        ava.w[int(k)] = float(v)
    ava.update()

    H, W = (int(x) for x in args.size.split("x"))
    intrin = CameraIntrin(fx=0.9 * W, fy=0.9 * W, cx=W / 2, cy=H / 2)

    if args.interactive:
        viewer = InteractiveViewer(model, ava, intrin, (H, W),
                                   lbs_joint=args.lbs_weights_of)
        viewer.show(args.out)
        return

    rend = AvatarRenderer(ava, intrin)
    if args.mode == "depth":
        depth = rend.render_depth((H, W))
        img = (np.clip(depth / max(depth.max(), 1e-6), 0, 1) * 255).astype(
            np.uint8)
    elif args.mode == "parts":
        from avatar_tpu_torch.utils import palette_color_table

        seg = rend.render_part_mask((H, W))
        table = (palette_color_table(24) * 255).astype(np.uint8)
        img = table[np.minimum(seg, 23)]
        img[seg == 255] = 0
    else:
        img = rend.render_lambert((H, W))
    try:
        import cv2

        cv2.imwrite(args.out, img)
        print(f"wrote {args.out}")
    except ImportError:
        np.save(args.out + ".npy", img)
        print(f"wrote {args.out}.npy")


if __name__ == "__main__":
    main()
