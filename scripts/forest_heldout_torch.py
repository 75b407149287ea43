"""Score one committed forest on held-out frames of both packages.

Renders ``--frames`` held-out 1280x720 frames with the JAX package's
synthetic generator (the evaluation of ``scripts/train_bench_forest.py``)
and as many with the port's (``train_bench_forest_torch.held_out_frames``),
then walks ``--forest`` over both sets at stride 3 with both packages'
``RTree.predict_best`` and prints, per set: how many pixels the two walks
label differently (they must agree to the pixel), the per-pixel accuracy
in the forest's label space, and what kind of frames the set holds (body
pixels, depth range, pixels per group).  Runs on the CPU and imports both
packages.

    JAX_PLATFORMS=cpu python scripts/forest_heldout_torch.py --frames 8
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def reference_frames(n: int, seed: int):
    """``n`` frames as ``train_bench_forest.py`` renders them for its
    evaluation: (depth [n,H,W] f32, group mask [n,H,W] uint8)."""
    import jax.numpy as jnp

    import train_bench_forest_torch as bench
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.perception.partgroups import SMPL24_GROUP_LUT
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.train import synth

    model = synthetic_model(detail=6)
    part_map = np.asarray(SMPL24_GROUP_LUT, np.int32)
    src = synth.make_source(model, CameraIntrin(**bench.INTRIN), part_map,
                            n_images=n, seed=seed)
    depth, mask = [], []
    for start in range(0, n, 4):
        ids = jnp.arange(start, min(start + 4, n), dtype=jnp.int32)
        d, m, _ = synth.render_batch(src, model.parents, ids, seed, bench.H,
                                     bench.W, model.num_shape_keys())
        depth.append(np.asarray(d))
        mask.append(np.asarray(m))
    return np.concatenate(depth), np.concatenate(mask)


def port_frames(n: int, seed: int):
    import train_bench_forest_torch as bench
    from avatar_tpu_torch.testing import synthetic_model

    model = synthetic_model(detail=6, device="cpu")
    return bench.held_out_frames(model, True, n, seed)


def describe(depth, mask, num_parts: int) -> dict:
    """What kind of frames these are: body size, depth range, groups."""
    body = mask != 255
    per_frame = body.reshape(len(body), -1).sum(1)
    z = depth[body & (depth > 0)]
    hist = np.bincount(mask[body].astype(np.int64), minlength=num_parts)
    return dict(body_pixels_per_frame=[int(v) for v in per_frame],
                depth_m=[round(float(z.min()), 3), round(float(np.median(z)),
                                                         3),
                         round(float(z.max()), 3)],
                group_share=[round(float(h) / max(int(hist.sum()), 1), 4)
                             for h in hist[:num_parts]])


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--forest", default=os.path.join(
        ROOT, "data", "bench_forest_g14c.srtr"))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=4242)
    args = ap.parse_args()

    import train_bench_forest_torch as bench
    from avatar_tpu.perception.rtree import RTree as JRTree
    from avatar_tpu_torch.perception.rtree import RTree as TRTree

    jt, tt = JRTree(args.forest), TRTree(args.forest, device="cpu")
    num_parts = tt.num_parts
    out = {"forest": os.path.relpath(args.forest, ROOT), "stride": 3,
           "frames": args.frames, "seed": args.seed}
    for name, make in (("reference_frames", reference_frames),
                       ("port_frames", port_frames)):
        depth, mask = make(args.frames, args.seed)
        differ = 0
        labelled = 0
        for d in depth:
            pj = np.asarray(jt.predict_best(d, interval=3))
            pt = np.asarray(tt.predict_best(d, interval=3))
            differ += int((pj != pt).sum())
            labelled += int((pt != 255).sum())
        acc_j, per_j, total = bench.held_out_accuracy([jt], depth, mask,
                                                      num_parts)
        acc_t, _, _ = bench.held_out_accuracy([tt], depth, mask, num_parts)
        out[name] = dict(
            walks_differ_pixels=differ, labelled_pixels=labelled,
            scored_pixels=int(total.sum()),
            accuracy_reference_walk=round(float(acc_j), 4),
            accuracy_port_walk=round(float(acc_t), 4),
            per_group_accuracy=[round(float(v), 3) for v in per_j],
            **describe(depth, mask, num_parts))
        print(f"[{name}] {json.dumps(out[name])}", flush=True)
    print(json.dumps(out))
    if out["reference_frames"]["walks_differ_pixels"] or \
            out["port_frames"]["walks_differ_pixels"]:
        sys.exit("the two packages' walks differ on shared frames")


if __name__ == "__main__":
    main()
