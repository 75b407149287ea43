"""The benchmark's inputs, made from ``--seed`` by its own frozen code: the
model (the synthetic 24-joint body, or the body a configuration's
generator makes), the mix's ground-truth person and its seeded motion,
the depth frames a camera would deliver, and the order in which a traffic
mix hands them to the tracker.

One generator reads every traffic file.  A mix is a list of ``segments``
of ``body_frames`` frames of one person, each followed by
``empty_frames`` frames of the bare wall; ``order`` is ``ping_pong``
(forward, then backward: the motion stays continuous) or ``cycle``.  The
frames are the mix's own: its person (``person_seed``), its motion's
amplitudes, frequencies and phases and each segment's start time in
``t0`` (``motion_seed``), and, with ``reposition``, where each segment
re-enters.  ``--seed`` chooses the order: the order of the segments, and
the slot of the period where the tracker starts.  So every seed hands the
tracker the same frames, as the same amount of work, in another order.
Frames are rendered on the device, then kept on the host as uint16
millimetres over a wall at ``background_depth_m``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

from harness import model_arrays, spec
from reference import rotation
from reference.lbs import LBSParams, lbs
from reference.raster import rasterize_batch


class Slot(NamedTuple):
    frame: int            # index into Scene.frames
    body: bool            # a person is in view
    segment_start: bool   # the first body frame of a segment


class Scene:
    """Frames, ground truth and the order of one mix at one seed."""

    def __init__(self, frames, gt_joints, schedule, bg_depth, arrays,
                 prior):
        self.frames: List[np.ndarray] = frames        # [H, W] uint16 mm
        self.gt_joints: List[np.ndarray] = gt_joints  # [J, 3] m, or None
        self.schedule: List[Slot] = schedule          # one period
        self.bg_depth: np.ndarray = bg_depth          # [H, W] f32 m
        self.arrays = arrays                          # the model's arrays
        self.prior = prior                            # (weights, means, covs)

    def slot(self, k: int) -> Slot:
        return self.schedule[k % len(self.schedule)]


def model_inputs(config: dict, bench_dir: Path = spec.BENCH_DIR):
    """The model's arrays and its pose prior's arrays, as the config
    names them: from the generator ``model.generator`` names
    (``harness/models/<name>.py`` under ``bench_dir``), or, without one,
    the synthetic 24-joint body of ``model_arrays``."""
    m = config["model"]
    if "generator" in m:
        gen = spec.model_generator(m["generator"], bench_dir)
        arrays = gen.arrays(m)
        return arrays, gen.prior_arrays(len(arrays["parent"]), m)
    arrays = model_arrays.synthetic_arrays(m["detail"], m["shape_keys"],
                                           m["seed"])
    prior = model_arrays.synthetic_pose_prior_arrays(
        len(arrays["parent"]), seed=m["prior_seed"])
    return arrays, prior


def _lbs_params(arrays, device) -> LBSParams:
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    jreg = np.asarray(arrays["joint_reg"], np.float64)
    return LBSParams(
        v_template=t(arrays["v_template"]), shapedirs=t(arrays["shapedirs"]),
        weights=t(arrays["weights"]), joint_reg=t(jreg),
        joint_shape_reg_base=t(jreg @ arrays["v_template"]),
        joint_shape_reg=t(np.einsum("jp,pck->jck", jreg,
                                    arrays["shapedirs"])))


def _so3_exp(aa: np.ndarray) -> np.ndarray:
    return rotation.so3_exp(torch.as_tensor(
        aa, dtype=torch.float32)).numpy().astype(np.float64)


def person(seed: int, arrays, prior, shape_scale: float):
    """(w [K], rots [J, 3, 3]) of the seeded person: a shape from N(0, 1)
    scaled by ``shape_scale`` and a pose drawn from the pose prior, facing
    the camera (the draws of the port's ``Avatar.randomize``)."""
    weights, means, covs = prior
    rng = np.random.default_rng(seed)
    K = arrays["shapedirs"].shape[2]
    J = len(arrays["parent"])
    w = rng.standard_normal(K) * shape_scale
    comp = rng.choice(weights.shape[0], p=weights / weights.sum())
    z = rng.standard_normal(means.shape[1])
    sample = means[comp] + np.linalg.cholesky(covs[comp]) @ z
    rots = np.tile(np.eye(3), (J, 1, 1))
    rots[1:] = _so3_exp(sample.reshape(-1, 3))
    rots[0] = np.diag([-1.0, 1.0, -1.0])
    return w, rots


def make_scene(config: dict, traffic: dict, seed: int, device,
               bench_dir: Path = spec.BENCH_DIR) -> Scene:
    """Render the distinct frames of ``traffic`` at ``seed`` for the camera
    and model of ``config`` on ``device``; the frames end on the host."""
    arrays, prior = model_inputs(config, bench_dir)
    J = len(arrays["parent"])
    H, W = config["image"]["height"], config["image"]["width"]
    cam = config["camera"]
    bg = float(config["background_depth_m"])
    w, base_rots = person(traffic["person_seed"], arrays, prior,
                          traffic["shape_scale"])

    mo = traffic["motion"]
    mrng = np.random.default_rng(traffic["motion_seed"])
    amp = mrng.normal(0.0, mo["amp_sd"], (J, 3))
    freq = mrng.uniform(mo["freq"][0], mo["freq"][1], (J, 3))
    phase = mrng.uniform(0.0, 2 * np.pi, (J, 3))
    sway, sway_f = np.asarray(mo["sway"]), np.asarray(mo["sway_freq"])

    srng = np.random.default_rng([traffic["motion_seed"], 2])
    rep = traffic.get("reposition")
    poses = []          # (p, rots) per distinct body frame
    for _ in range(traffic["segments"]):
        root = np.asarray(traffic["root"], np.float64)
        t0 = srng.uniform(*traffic["t0"])
        if rep is not None:
            root = np.array([srng.uniform(*rep["x"]), root[1],
                             srng.uniform(*rep["z"])])
        for i in range(traffic["body_frames"]):
            t = t0 + i
            rots = np.einsum("jab,jbc->jac",
                             _so3_exp(amp * np.sin(freq * t + phase)),
                             base_rots)
            p = root + np.array([sway[0] * np.sin(sway_f[0] * t), 0.0,
                                 sway[1] * np.sin(sway_f[1] * t)])
            poses.append((p, rots))

    params = _lbs_params(arrays, device)
    parents = tuple(int(x) for x in arrays["parent"])
    faces = torch.as_tensor(np.asarray(arrays["faces"]), device=device)
    tw = torch.as_tensor(w, dtype=torch.float32, device=device)
    budget = max(H * W, 8 * faces.shape[0])
    frames, gt_joints = [], []
    chunk = 8
    for c0 in range(0, len(poses), chunk):
        clouds = []
        for p, rots in poses[c0:c0 + chunk]:
            cloud, joints, _, _ = lbs(
                params, parents, tw,
                torch.as_tensor(p, dtype=torch.float32, device=device),
                torch.as_tensor(rots, dtype=torch.float32, device=device))
            clouds.append(cloud)
            gt_joints.append(joints.cpu().numpy().astype(np.float64))
        cl = torch.stack(clouds)                      # model space [B,P,3]
        z = cl[..., 2]
        proj = torch.stack([cl[..., 0] * cam["fx"] / z + cam["cx"],
                            -cl[..., 1] * cam["fy"] / z + cam["cy"]], -1)
        r = rasterize_batch(proj, z, faces, H, W, budget)
        if int(r.n_dropped.max()) != 0:
            raise RuntimeError("the renderer's sample budget overflowed")
        d = torch.where(r.fid >= 0, r.depth, torch.full_like(r.depth, bg))
        mm = (d * 1000.0).to(torch.int32).cpu().numpy().astype(np.uint16)
        frames.extend(list(mm))
    bg_depth = np.full((H, W), bg, np.float32)
    empty = None
    if traffic["empty_frames"] > 0:
        empty = len(frames)
        frames.append(np.full((H, W), int(bg * 1000.0), np.uint16))
        gt_joints.append(None)

    B = traffic["body_frames"]
    order = np.random.default_rng([seed, 1]).permutation(traffic["segments"])
    schedule: List[Slot] = []
    for s in order.tolist():
        for i in range(B):
            schedule.append(Slot(s * B + i, True, i == 0))
        schedule.extend([Slot(empty, False, False)] *
                        traffic["empty_frames"])
    if traffic["order"] == "ping_pong" and len(schedule) > 1:
        schedule = schedule + schedule[-2:0:-1]
    elif traffic["order"] != "cycle":
        raise ValueError(f"unknown order {traffic['order']!r}")
    start = int(np.random.default_rng([seed, 2]).integers(len(schedule)))
    schedule = schedule[start:] + schedule[:start]
    return Scene(frames, gt_joints, schedule, bg_depth, arrays, prior)
