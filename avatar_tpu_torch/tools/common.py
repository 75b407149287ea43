"""Shared CLI plumbing for the tool entry points."""

from __future__ import annotations

import argparse

from avatar_tpu_torch.core.model import AvatarModel
from avatar_tpu_torch.core.sequence import AvatarPoseSequence


def add_model_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model-dir", default="",
                    help="avatar model directory (model.npz or legacy "
                         "format); default: data/avatar-model via "
                         "OPENARK_DIR-style discovery")
    ap.add_argument("--synthetic-model", type=int, default=0, metavar="DETAIL",
                    help="use the built-in synthetic SMPL-like model at the "
                         "given detail level instead of files (no licensed "
                         "SMPL data required)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; there "
                         "is no silent CPU fallback)")


def load_model(args) -> AvatarModel:
    if args.synthetic_model:
        from avatar_tpu_torch.testing import synthetic_model

        return synthetic_model(detail=args.synthetic_model,
                               device=args.device)
    return AvatarModel(args.model_dir, device=args.device)


def load_pose_seq(path: str = "") -> AvatarPoseSequence:
    return AvatarPoseSequence(path)
