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


def add_partmap_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--partmap", default="",
                    help="a .partmap of the model's joints onto the "
                         "forest's parts, in place of the forest's own "
                         "<forest>.partmap (an SMPL-X model on the 24-part "
                         "forests: data/smplx55_smpl24.partmap)")


def set_partmap(tree, path: str) -> None:
    """Set the joint-to-part map and its type of the ``.partmap`` at
    ``path`` on the forest ``tree``; a map onto another number of parts
    than the forest has raises a ``ValueError``."""
    from avatar_tpu_torch.io.formats import read_partmap

    part_map, n_parts, partmap_type = read_partmap(path)
    if n_parts != tree.num_parts:
        raise ValueError(f"{path} maps onto {n_parts} parts; the forest "
                         f"has {tree.num_parts}")
    tree.part_map, tree.partmap_type = list(part_map), partmap_type


def load_model(args) -> AvatarModel:
    if args.synthetic_model:
        from avatar_tpu_torch.testing import synthetic_model

        return synthetic_model(detail=args.synthetic_model,
                               device=args.device)
    return AvatarModel(args.model_dir, device=args.device)


def load_pose_seq(path: str = "") -> AvatarPoseSequence:
    return AvatarPoseSequence(path)
