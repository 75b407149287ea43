"""The system under test and its plain reference, built from a
configuration file, and the one way the window feeds either of them a
frame.

``tracker`` in a configuration names the class: ``fused`` is the port's
``tracking_fused.FusedTracker`` fed uint16 depth as ``bench.py`` feeds it;
``host`` is ``tracking.Tracker`` fed the XYZ map of each depth frame, as
the ``demo`` tool feeds it from a recording.  A frame's work runs from
handing over the uint16 frame to the tracked joints on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from reference.formats import read_partmap

# a configuration's forest and part map paths are relative to the root of
# the checkout
ROOT = Path(__file__).resolve().parent.parent.parent

# the per-frame tracking state of each class, which the reference takes
# over from the program before a compared frame
FUSED_STATE = ("_theta", "_theta_prev", "com_pre", "reinit", "first_init",
               "_frame_no", "_lost_count", "_lost_frames", "_shape_refit_in",
               "_last_root_z", "_starve", "limb_recoveries")
HOST_STATE = ("com_pre", "reinit", "first_init")
HOST_AVATAR = ("p", "r", "w")


class Output(NamedTuple):
    ok: bool
    reinitialized: bool
    n_points: int
    cost: Optional[float]               # the fit's final cost
    verts: Optional[np.ndarray]         # [P, 3] m, model space
    joints: Optional[np.ndarray]        # [J, 3] m
    theta: Optional[tuple]              # (p [3], rots [J,3,3], w [K])


def _tracker_config(cls, config: dict):
    kw = dict(config["tracker_config"])
    if kw.get("part_groups") is not None:
        kw["part_groups"] = tuple(kw["part_groups"])
    return cls(**kw)


def _build(mods, config: dict, scene, device):
    """A tracker of ``config`` from the classes in ``mods`` (the port's or
    the reference's), with its background set.  ``forest_partmap`` (a
    ``.partmap`` relative to the root of the checkout) maps the model's
    joints onto the forest's parts for every forest of the configuration,
    in place of each forest's own ``<forest>.partmap``;
    ``forest_partmap_type`` then sets the type alone."""
    dev = torch.device(device)
    model = mods["AvatarModel"](
        arrays=scene.arrays, dtype=torch.float32, device=dev,
        pose_prior=mods["GaussianMixture"](*scene.prior, dtype=torch.float32,
                                           device=dev))
    trees = [mods["RTree"](str(ROOT / path), device=dev)
             for path in config["forest"]]
    if "forest_partmap" in config:
        part_map, n_parts, partmap_type = read_partmap(
            str(ROOT / config["forest_partmap"]))
        if len(part_map) != len(scene.arrays["parent"]):
            raise ValueError(f"{config['forest_partmap']} maps "
                             f"{len(part_map)} joints; the model has "
                             f"{len(scene.arrays['parent'])}")
        for t in trees:
            if n_parts != t.num_parts:
                raise ValueError(f"{config['forest_partmap']} maps onto "
                                 f"{n_parts} parts; a forest has "
                                 f"{t.num_parts}")
            t.part_map, t.partmap_type = list(part_map), partmap_type
    for t in trees:
        if "forest_partmap_type" in config:
            t.partmap_type = config["forest_partmap_type"]
    cam = config["camera"]
    intrin = mods["CameraIntrin"](fx=cam["fx"], fy=cam["fy"], cx=cam["cx"],
                                  cy=cam["cy"])
    size = (config["image"]["height"], config["image"]["width"])
    cfg = _tracker_config(mods["TrackerConfig"], config)
    if config["tracker"] == "fused":
        tracker = mods["FusedTracker"](
            model, intrin, size, rtree=trees if len(trees) > 1 else trees[0],
            config=cfg)
        tracker.set_background(scene.bg_depth)
    elif config["tracker"] == "host":
        tracker = mods["Tracker"](model, intrin, size, rtree=trees[0],
                                  config=cfg)
        tracker.set_background(intrin.depth_to_xyz_np(scene.bg_depth))
    else:
        raise ValueError(f"unknown tracker {config['tracker']!r}")
    return tracker, intrin


def build_program(config: dict, scene, device):
    from avatar_tpu_torch.core.model import AvatarModel
    from avatar_tpu_torch.core.pose_prior import GaussianMixture
    from avatar_tpu_torch.io.calibration import CameraIntrin
    from avatar_tpu_torch.perception.rtree import RTree
    from avatar_tpu_torch.tracking import Tracker, TrackerConfig
    from avatar_tpu_torch.tracking_fused import FusedTracker
    return Runner(config, *_build(locals(), config, scene, device))


def build_reference(config: dict, scene, device):
    from reference.calibration import CameraIntrin
    from reference.model import AvatarModel
    from reference.pose_prior import GaussianMixture
    from reference.rtree import RTree
    from reference.tracking import Tracker, TrackerConfig
    from reference.tracking_fused import FusedTracker
    return Runner(config, *_build(locals(), config, scene, device))


class Runner:
    """One tracker and how a frame goes through it."""

    def __init__(self, config: dict, tracker, intrin):
        self.kind = config["tracker"]
        self.tracker = tracker
        self.intrin = intrin

    def feed(self, frame: np.ndarray) -> Output:
        """Track one uint16 depth frame; the tracked pose on the host."""
        t = self.tracker
        theta = None
        if self.kind == "fused":
            res = t.track(frame)
            verts, joints = t.pose() if res.ok else (None, None)
            if res.ok:
                theta = tuple(x.cpu().numpy() for x in t._theta)
        else:
            xyz = self.intrin.depth_to_xyz_np(frame.astype(np.float32) *
                                              np.float32(1e-3))
            res = t.track(xyz)
            verts, joints = ((t.ava.cloud, t.ava.joint_pos) if res.ok
                             else (None, None))
            if res.ok:
                theta = (t.ava.p.copy(), t.ava.r.copy(), t.ava.w.copy())
        cost = (float(res.fit_info["cost"]) if res.ok and res.fit_info
                else None)
        return Output(bool(res.ok), bool(res.reinitialized),
                      int(res.n_points), cost, verts, joints, theta)

    # -- the reference as a judge ------------------------------------------

    def _theta(self, theta):
        from reference.gauss_newton import Theta
        m = self.tracker.model
        return Theta(*(torch.as_tensor(np.asarray(x), dtype=m.dtype,
                                       device=m.device) for x in theta))

    def lbs(self, theta) -> np.ndarray:
        """The reference's vertices [P, 3] of the pose ``theta``."""
        from reference.lbs import lbs
        m = self.tracker.model
        th = self._theta(theta)
        verts, _, _, _ = lbs(m.params, m.parents, th.w, th.p, th.rots,
                             use_jsr=m.use_joint_shape_regressor)
        return verts.cpu().numpy().astype(np.float64)

    def warmup(self, frame: np.ndarray) -> None:
        """The tracker's own warm-up, where it has one."""
        if self.kind == "fused":
            self.tracker.warmup(frame)

    def state(self) -> dict:
        """A copy of the per-frame tracking state."""
        t = self.tracker
        out = {}
        if self.kind == "fused":
            for k in FUSED_STATE:
                v = getattr(t, k)
                if isinstance(v, torch.Tensor):
                    v = v.clone()
                elif hasattr(v, "_fields"):         # Theta
                    v = tuple(x.clone() for x in v)
                elif isinstance(v, (np.ndarray, dict)):
                    v = v.copy()
                out[k] = v
        else:
            for k in HOST_STATE:
                v = getattr(t, k)
                out[k] = v.copy() if isinstance(v, np.ndarray) else v
            for k in HOST_AVATAR:
                out["ava." + k] = np.array(getattr(t.ava, k), copy=True)
        return out

    def set_state(self, state: dict) -> None:
        """Take over ``state`` (of another runner of this class)."""
        t = self.tracker
        if self.kind == "fused":
            from reference.gauss_newton import Theta
            dev, dt = t.device, t.model.dtype
            for k, v in state.items():
                if k in ("_theta", "_theta_prev"):
                    v = Theta(*(x.to(device=dev, dtype=dt) for x in v))
                elif isinstance(v, torch.Tensor):
                    v = v.to(device=dev, dtype=dt)
                elif isinstance(v, (np.ndarray, dict)):
                    v = v.copy()
                setattr(t, k, v)
        else:
            for k, v in state.items():
                if k.startswith("ava."):
                    setattr(t.ava, k[4:], np.array(v, copy=True))
                else:
                    setattr(t, k, v.copy() if isinstance(v, np.ndarray)
                            else v)
