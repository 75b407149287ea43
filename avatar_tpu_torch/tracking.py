"""Tracker configuration and per-frame result (counterparts of
``TrackerConfig`` and ``TrackResult`` in ``avatar_tpu/tracking.py``,
field for field with the same defaults; the host-orchestrated ``Tracker``
is not ported yet).

The rationale and the measurements behind each default live with the
reference's ``TrackerConfig``; ``tests/test_torch_perception.py`` checks
that the fields and defaults here stay equal to it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


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
