"""Train (and evaluate) the bench forest with the PyTorch port.

The recipe of ``scripts/train_bench_forest.py`` on ``avatar_tpu_torch``:
the detail-6 synthetic model seen by a 1280x720 camera, rendered and
trained at a pixel stride (the tracker reads the forest at
``rtree_interval=3``, so stride 3 trains on the deployment grid), 2000
points per image, a pool of 512 features filtered to 64 per node, 16
buckets, optionally in the 14-group label space.  Probe offsets are
exported in full-resolution pixel units whatever the stride (``.srtr``
semantics).  Held-out accuracy is per pixel at stride 3 on 16 fresh
full-resolution frames from another seed.

    python scripts/train_bench_forest_torch.py --out /tmp/forest.srtr \\
        --groups --train-stride 3 --images 1024 --depth 10

Runs on ``--device`` (default ``cuda``).  ``train_bench_tree`` and
``held_out_accuracy`` are what ``chip_smoke.py`` calls as well.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W = 720, 1280
INTRIN = dict(fx=606.438, fy=606.351, cx=637.294, cy=366.992)
EVAL_SEED = 4242


def label_space(groups: bool):
    """(part_map or None, num_parts) of the 24-part or 14-group space."""
    from avatar_tpu_torch.perception.partgroups import (SMPL24_GROUP_LUT,
                                                        SMPL24_NUM_GROUPS)

    if groups:
        return np.asarray(SMPL24_GROUP_LUT, np.int32), SMPL24_NUM_GROUPS
    return None, 24


def make_trainer(model, images: int, depth: int, groups: bool = True,
                 train_stride: int = 3, points: int = 2000,
                 features: int = 512, filtered: int = 64, probe: float = 220.0,
                 min_samples: int = 48, balance: float = 0.5,
                 image_batch: int = 0, seed: int = 11, verbose: bool = False,
                 checkpoint_path: str = "", pass_mode: str = "auto",
                 mesh=None):
    """The bench recipe's ``ForestTrainer`` on the model's device (over
    ``mesh``, if given): frames of (H, W) / train_stride with the
    intrinsics and the probe range divided by the stride."""
    from avatar_tpu_torch.io.calibration import CameraIntrin
    from avatar_tpu_torch.train.forest import ForestTrainer

    ts = train_stride
    size = ((H + ts - 1) // ts, (W + ts - 1) // ts)
    tintrin = CameraIntrin(**{k: v / ts for k, v in INTRIN.items()})
    part_map, num_parts = label_space(groups)
    return ForestTrainer(
        model, tintrin, size, num_parts=num_parts, part_map=part_map,
        num_images=images, num_points_per_image=points,
        num_features=features, num_features_filtered=filtered,
        max_probe_offset=probe / ts, min_samples=min_samples,
        max_tree_depth=depth, image_batch=image_batch or 8 * ts * ts,
        seed=seed, verbose=verbose, sample_balance=balance,
        checkpoint_path=checkpoint_path, pass_mode=pass_mode, mesh=mesh)


def train_bench_tree(model, images: int, depth: int, train_stride: int = 3,
                     **kw):
    """Train one tree by the bench recipe.  Returns (forest, trainer); the
    forest's probe offsets are in full-resolution pixel units (the trainer
    works at the stride's; the tracker divides by its own stride at
    load)."""
    trainer = make_trainer(model, images, depth, train_stride=train_stride,
                           **kw)
    fd = trainer.train(resume_from=trainer.checkpoint_path)
    if train_stride != 1:
        fd.u = np.asarray(fd.u) * float(train_stride)
        fd.v = np.asarray(fd.v) * float(train_stride)
    return fd, trainer


def write_forest(path: str, fd, groups: bool, device) -> None:
    """Export ``fd`` as ``path`` (.srtr), with the group LUT as its
    ``.partmap`` sidecar when trained in group space."""
    from avatar_tpu_torch.io import formats
    from avatar_tpu_torch.perception.partgroups import SMPL24_GROUP_NAMES
    from avatar_tpu_torch.perception.rtree import RTree

    tree = RTree(fd.num_parts, device=device)
    tree.set_forest(fd)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree.export_file(path)
    if groups:
        part_map, _ = label_space(True)
        src_names = [f"joint{j}" for j in range(24)]
        formats.write_partmap(
            path + ".partmap", formats.PARTMAP_CONTIGUOUS, src_names,
            list(SMPL24_GROUP_NAMES),
            {src_names[j]: SMPL24_GROUP_NAMES[part_map[j]]
             for j in range(24)})


def held_out_frames(model, groups: bool, n_eval: int = 16,
                    seed: int = EVAL_SEED):
    """``n_eval`` fresh full-resolution frames from another seed: (depth
    [n,H,W] f32, part mask [n,H,W] uint8) as numpy arrays."""
    from avatar_tpu_torch.io.calibration import CameraIntrin
    from avatar_tpu_torch.train import synth

    part_map, _ = label_space(groups)
    src = synth.make_source(model, CameraIntrin(**INTRIN), part_map,
                            n_images=n_eval, seed=seed)
    depth, mask = [], []
    for start in range(0, n_eval, 4):
        d, m, _ = synth.render_batch(
            src, model.parents, np.arange(start, min(start + 4, n_eval)),
            seed, H, W, model.num_shape_keys())
        depth.append(d.cpu().numpy())
        mask.append(m.cpu().numpy())
    return np.concatenate(depth), np.concatenate(mask)


def held_out_accuracy(trees, depth, mask, num_parts: int):
    """Per-pixel accuracy of ``trees`` (one RTree, or several whose leaf
    distributions are summed) at stride 3 on the frames: (overall, per
    part [num_parts], pixels per part)."""
    total = np.zeros(num_parts, np.int64)
    correct = np.zeros(num_parts, np.int64)
    for d, m in zip(depth, mask):
        if len(trees) == 1:
            pred = trees[0].predict_best(d, interval=3)
        else:
            dist = sum(tr.predict(d, interval=3) for tr in trees)
            pred = np.where(dist.sum(-1) > 0, np.argmax(dist, -1),
                            255).astype(np.uint8)
        fg = (m != 255) & (pred != 255)
        for p in range(num_parts):
            sel = fg & (m == p)
            total[p] += sel.sum()
            correct[p] += (pred[sel] == p).sum()
    return (correct.sum() / max(total.sum(), 1),
            correct / np.maximum(total, 1), total)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="data/bench_forest_torch.srtr")
    ap.add_argument("--images", type=int, default=384)
    ap.add_argument("--points", type=int, default=2000)
    ap.add_argument("--features", type=int, default=512)
    ap.add_argument("--filtered", type=int, default=64)
    ap.add_argument("--depth", type=int, default=14)
    ap.add_argument("--probe", type=float, default=220.0)
    ap.add_argument("--min-samples", type=int, default=48)
    ap.add_argument("--trees", type=int, default=1)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--groups", action="store_true",
                    help="train in 14-group label space (partgroups.py); "
                    "writes the group LUT as the .partmap sidecar")
    ap.add_argument("--balance", type=float, default=0.5,
                    help="per-class pixel-sampling balance exponent")
    ap.add_argument("--image-batch", type=int, default=0,
                    help="images per render dispatch (0 = 8*stride^2)")
    ap.add_argument("--train-stride", type=int, default=1,
                    help="render/train at this pixel stride; probe offsets "
                    "export in full-resolution pixel units regardless")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from avatar_tpu_torch.perception.rtree import RTree
    from avatar_tpu_torch.testing import synthetic_model

    model = synthetic_model(detail=6, device=args.device)
    _, num_parts = label_space(args.groups)
    paths = []
    for t in range(args.trees):
        path = args.out if t == 0 else args.out.replace(
            ".srtr", f"_{t}.srtr")
        paths.append(path)
        if args.eval_only or os.path.exists(path):
            continue
        print(f"[train] tree {t}: {args.images} imgs, "
              f"{args.features}->{args.filtered} feats, depth {args.depth}",
              file=sys.stderr)
        t0 = time.time()
        fd, _ = train_bench_tree(
            model, args.images, args.depth, train_stride=args.train_stride,
            groups=args.groups, points=args.points, features=args.features,
            filtered=args.filtered, probe=args.probe,
            min_samples=args.min_samples, balance=args.balance,
            image_batch=args.image_batch, seed=args.seed + 71 * t,
            verbose=True, checkpoint_path=path + ".ckpt")
        write_forest(path, fd, args.groups, args.device)
        print(f"[train] tree {t} done in {time.time() - t0:.0f}s, "
              f"{fd.num_nodes} nodes -> {path}", file=sys.stderr)

    trees = [RTree(p, device=args.device) for p in paths if os.path.exists(p)]
    depth, mask = held_out_frames(model, args.groups)
    acc, per_part, total = held_out_accuracy(trees, depth, mask, num_parts)
    print(f"[eval] overall pixel accuracy (stride 3): {acc:.3f}")
    worst = np.argsort(per_part)[:8]
    print("[eval] worst parts:",
          " ".join(f"p{p}={per_part[p]:.2f}({total[p]})" for p in worst))


if __name__ == "__main__":
    main()
