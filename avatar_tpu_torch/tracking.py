"""The host tracker, its configuration and per-frame result
(counterparts of ``Tracker``, ``TrackerConfig`` and ``TrackResult`` in
``avatar_tpu/tracking.py``).

``Tracker`` is the reference's demo / live-demo frame loop (demo.cpp:
153-334, live-demo.cpp:264-530): XYZ frame -> ``BGSubtractor`` ->
``RTree.predict_best`` at stride 2 -> ``RTree.post_process`` (blob
filtering with centre-of-mass tracking) -> stride-sampled labelled cloud
-> the reinit state machine -> ``AvatarOptimizer.optimize`` -> optional
Lambert overlay.  Each stage runs on the model's device and hands numpy
to the next, as the reference's host path does, through counted reads
(``profiling.host_read``, ``to_device``); the XYZ map goes to the card in
``bgsub/upload``.  The per-frame fused tracker is
``tracking_fused.FusedTracker``.

``TrackerConfig`` is field for field the reference's, with the same
defaults; the rationale and measurements behind each default live there,
and ``tests/test_torch_perception.py`` checks that the two stay equal.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from avatar_tpu_torch.core.model import Avatar, AvatarModel
from avatar_tpu_torch.optim.optimizer import AvatarOptimizer
from avatar_tpu_torch.perception.bgsub import BGSubtractor
from avatar_tpu_torch.profiling import FRAME_SCOPE, scope
from avatar_tpu_torch.utils import StageTimer


@dataclasses.dataclass
class TrackerConfig:
    # priors and sampling strides (reference demo.cpp:44-73,
    # live-demo.cpp:60-120)
    beta_pose: float = 0.03
    beta_shape: float = 0.12
    data_interval: int = 12       # stride of the optimization samples
    rtree_interval: int = 2       # stride of forest inference
    # LM budgets: steps = icp_iters * iters_per_icp
    frame_icp_iters: int = 2
    reinit_icp_iters: int = 6
    initial_icp_iters: int = 7
    iters_per_icp: int = 10
    min_points: int = 1000
    dist_to_pre_weight: float = 0.001
    # occlusion resilience and the tracking-loss state machine
    body_gate: float = 0.6
    max_root_jump: float = 0.45
    lost_reinit_frames: int = 5
    absent_fg_frac: float = 0.25
    lost_gated_frames: int = 45
    # periodic surface refine (fit_refine) every refine_every frames
    refine_every: int = 0
    refine_steps: int = 4
    refine_beta: float = 0.1
    shape_refit_after: int = 12
    # background subtraction thresholds
    nn_dist_thresh_rel: float = 0.005
    neighb_thresh_rel: float = 0.005
    bgsub_stride: int = 2
    # forest label gates, wildcard channel, selective walk, rebalancing
    label_conf_thresh: float = 0.5
    label_conf_low: float = 0.3
    label_conf_low_groups: tuple = ()
    wild_n: int = 992
    wild_gate: float = 0.2
    wild_weight: float = 0.7
    selective_walk: float = 0.75
    label_class_balance: float = 0.5
    seg_window: Optional[tuple] = (576, 448)
    # fit terms
    enable_occlusion: bool = True
    point_weight: float = 1.0
    plane_weight: float = 2.0
    robust: bool = True
    huber_k: float = 3.0
    robust_per_part: bool = True
    part_groups: Optional[tuple] = None
    render_labels: bool = True
    render_label_tau: float = 0.03
    beta_temp: float = 0.3
    extremity_boost_n: int = 0
    extremity_boost_groups: tuple = (4, 5, 6, 7, 10, 11, 12, 13)
    # limb recovery, motion clamp, reinit seeds
    limb_recovery: bool = True
    limb_recovery_frames: int = 3
    limb_recovery_m: float = 0.12
    pose_clamp_angle: float = 0.25
    reinit_seeds: int = 3
    pipeline_depth: int = 2
    fit_vertex_stride: int = 1
    extrapolate_pose: float = 0.8


@dataclasses.dataclass
class TrackResult:
    ok: bool
    reinitialized: bool = False
    n_points: int = 0
    part_mask: Optional[np.ndarray] = None
    fit_info: Optional[dict] = None


class Tracker:
    def __init__(self, model: AvatarModel, intrin, image_size,
                 rtree=None, config: Optional[TrackerConfig] = None):
        self.model = model
        self.intrin = intrin
        self.image_size = tuple(image_size)  # (H, W)
        self.rtree = rtree
        self.config = config or TrackerConfig()
        self.ava = Avatar(model)

        num_parts = (rtree.num_parts if rtree is not None
                     else model.num_joints())
        part_map = rtree.part_map if rtree is not None else None
        self.optimizer = AvatarOptimizer(
            self.ava, intrin, image_size, num_parts, part_map)
        c, opt = self.config, self.optimizer
        opt.beta_pose = c.beta_pose
        opt.beta_shape = c.beta_shape
        opt.max_iters_per_icp = c.iters_per_icp
        opt.enable_occlusion = c.enable_occlusion
        opt.point_weight = c.point_weight
        opt.plane_weight = c.plane_weight
        opt.robust = c.robust
        opt.huber_k = c.huber_k
        opt.robust_per_part = c.robust_per_part

        self.bgsub: Optional[BGSubtractor] = None
        self.com_pre = np.full((2, num_parts), -1.0)
        self.com_pre[1, :] = 0.0
        self.reinit = True
        self.first_init = True
        self.timer = StageTimer()
        self._metrics_file = None

    def set_background(self, background_xyz: np.ndarray) -> None:
        self.bgsub = BGSubtractor(np.asarray(background_xyz, np.float32),
                                  stride=self.config.bgsub_stride,
                                  device=self.model.device)
        self.bgsub.nn_dist_thresh_rel = self.config.nn_dist_thresh_rel
        self.bgsub.neighb_thresh_rel = self.config.neighb_thresh_rel

    def track(self, xyz_map: np.ndarray,
              labels_override: Optional[np.ndarray] = None) -> TrackResult:
        """Process one frame.

        xyz_map: [H, W, 3] camera-space XYZ (z == 0 invalid).
        labels_override: optional [H, W] uint8 part labels (255 =
          background) in place of forest inference.
        """
        with scope(FRAME_SCOPE):
            return self._track(xyz_map, labels_override)

    def _track(self, xyz_map, labels_override) -> TrackResult:
        """The frame, its stages under the fused tracker's scope names."""
        c = self.config
        H, W = xyz_map.shape[:2]
        with scope("glue/depth"):
            depth = np.ascontiguousarray(xyz_map[..., 2]).copy()

        # background subtraction (demo.cpp:179-193)
        with self.timer.stage("bg_subtraction"), scope("bgsub"):
            if self.bgsub is not None:
                sub = self.bgsub.run(xyz_map)
                depth[sub >= 254] = 0.0
                tl, br = self.bgsub.top_left, self.bgsub.bot_right
            else:
                tl, br = (0, 0), (W - 1, H - 1)

        # part segmentation (demo.cpp:195-204)
        with self.timer.stage("segmentation"):
            if labels_override is not None:
                part_mask = np.where(depth > 0, labels_override,
                                     np.uint8(255))
            elif self.rtree is not None:
                with scope("forest_walk"):
                    part_mask = self.rtree.predict_best(
                        depth, interval=c.rtree_interval, top_left=tl,
                        bot_right=br)
                with scope("blob_suppress"):
                    part_mask = self.rtree.post_process(
                        part_mask, self.com_pre, interval=c.rtree_interval,
                        top_left=tl, bot_right=br,
                        dist_to_pre_weight=c.dist_to_pre_weight)
            else:
                raise ValueError("need an rtree or labels_override")

        # labelled cloud at the data stride (demo.cpp:215-250)
        with self.timer.stage("gather"), scope("glue/sample"):
            iv = c.data_interval
            ys = np.arange(tl[1], br[1] + 1, iv)
            xs = np.arange(tl[0], br[0] + 1, iv)
            if len(ys) == 0 or len(xs) == 0:
                self.reinit = True
                return TrackResult(ok=False)
            sub_mask = part_mask[np.ix_(ys, xs)]
            sub_xyz = xyz_map[np.ix_(ys, xs)]
            fg = (sub_mask != 255) & (sub_xyz[..., 2] > 0)
            n_points = int(fg.sum())
            if n_points < c.min_points / (iv * iv):
                self.reinit = True
                return TrackResult(ok=False, n_points=n_points,
                                   part_mask=part_mask)
            pts = sub_xyz[fg]
            pts = np.stack([pts[:, 0], -pts[:, 1], pts[:, 2]], 1)
            labels = sub_mask[fg].astype(np.int32)

        # reinit state machine (demo.cpp:251-266): recentre at the cloud's
        # centroid, zero shape, face the camera, more ICP iterations
        reinitialized = False
        icp_iters = c.frame_icp_iters
        if self.reinit:
            self.ava.p = pts.mean(axis=0)
            self.ava.w[:] = 0.0
            self.ava.r = np.tile(np.eye(3), (self.model.num_joints(), 1, 1))
            self.ava.r[0] = np.diag([-1.0, 1.0, -1.0])
            self.ava.update()
            icp_iters = (c.initial_icp_iters if self.first_init
                         else c.reinit_icp_iters)
            self.reinit = False
            self.first_init = False
            reinitialized = True

        # fit (demo.cpp:267-268)
        with self.timer.stage("optimize"), scope("fit"):
            info = self.optimizer.optimize(pts, labels, icp_iters=icp_iters)

        res = TrackResult(ok=True, reinitialized=reinitialized,
                          n_points=n_points, part_mask=part_mask,
                          fit_info=info)
        self._log_metrics(res)
        return res

    # -- one JSON line of metrics per tracked frame --------------------------

    def open_metrics(self, path: str) -> None:
        """Write one JSON line per tracked frame to ``path``: frame index,
        ok / reinit, point and match counts (also per part), fit cost and
        the stages' latest ms."""
        self._metrics_file = open(path, "w")
        self._metrics_frame = 0

    def close_metrics(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None

    def _log_metrics(self, res: TrackResult) -> None:
        if self._metrics_file is None:
            return
        rec = dict(frame=self._metrics_frame, ok=res.ok,
                   reinit=res.reinitialized, n_points=res.n_points)
        if res.fit_info:
            rec.update(res.fit_info)
        for k, v in self.timer.stats.items():
            if v:
                rec[f"{k}_ms"] = round(v[-1], 3)
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_frame += 1

    def render_overlay(self, rgb: Optional[np.ndarray] = None) -> np.ndarray:
        """Lambert-shaded avatar blended over RGB (demo.cpp:275-307)."""
        from avatar_tpu_torch.render.renderer import AvatarRenderer

        lam = AvatarRenderer(self.ava, self.intrin).render_lambert(
            self.image_size)
        if rgb is None:
            return lam
        out = rgb.copy()
        m = lam > 0
        blend = (rgb[m].astype(np.int32) // 5 * 2 +
                 np.stack([lam[m]] * 3, -1).astype(np.int32) // 5 * 3)
        out[m] = blend.astype(np.uint8)
        return out
