"""Model surgery: create partial avatar models (re-root, delete limbs);
counterpart of ``avatar_tpu/tools/smpltrim.py``.

Rebuild of reference smpltrim.cpp: delete joint subtrees, optionally re-root
the skeleton, keep vertices whose remaining LBS weight exceeds a threshold,
renormalize weights, and write the trimmed model.  Unlike the reference
(legacy text format only), output is the npz model format.  The surgery is
host numpy; ``--device`` places the model it loads (the card by default).

    python -m avatar_tpu_torch.tools.smpltrim OUT_DIR -d L_HIP -d R_HIP -r SPINE1
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from avatar_tpu_torch.core.model import SmplJoint
from avatar_tpu_torch.tools.common import add_model_args, load_model


def trim_model(model, delete_joints, new_root: int = 0, thresh: float = 0.6):
    """Return trimmed arrays dict (same keys as model npz loading)."""
    J = model.num_joints()
    parent = model.parent.copy()

    # collect subtree of each deleted joint
    deleted = np.zeros(J, bool)
    for d in delete_joints:
        stack = [d]
        while stack:
            j = stack.pop()
            deleted[j] = True
            stack.extend(int(k) for k in range(J) if parent[k] == j)

    # re-root: joints outside the new root's subtree are dropped
    if new_root != 0:
        in_subtree = np.zeros(J, bool)
        stack = [new_root]
        while stack:
            j = stack.pop()
            in_subtree[j] = True
            stack.extend(int(k) for k in range(J) if parent[k] == j)
        deleted |= ~in_subtree

    keep_j = ~deleted
    if not keep_j.any():
        raise ValueError("all joints deleted")
    new_idx = np.cumsum(keep_j) - 1  # old joint id -> new id

    # vertices: keep those whose surviving weight mass exceeds thresh
    W = model.weights_np
    surviving = W[:, keep_j].sum(1)
    keep_v = surviving >= thresh
    Wk = W[np.ix_(keep_v, keep_j)]
    Wk = Wk / Wk.sum(1, keepdims=True).clip(1e-12)

    # faces whose three vertices all survive
    vmap = np.full(model.num_points(), -1, np.int64)
    vmap[keep_v] = np.arange(keep_v.sum())
    f = model.faces
    fk = f[(vmap[f] >= 0).all(1)]
    fk = vmap[fk]

    new_parent = np.full(keep_j.sum(), -1, np.int32)
    for old_j in np.nonzero(keep_j)[0]:
        p = parent[old_j]
        while p >= 0 and not keep_j[p]:
            p = parent[p]
        new_parent[new_idx[old_j]] = new_idx[p] if p >= 0 else -1
    new_parent[new_idx[new_root]] = -1

    return dict(
        v_template=model.v_template[keep_v],
        parent=new_parent,
        faces=fk.astype(np.int32),
        joint_reg=model.joint_reg_np[np.ix_(keep_j, keep_v)],
        weights=Wk,
        shapedirs=model.shapedirs[keep_v],
        use_jsr=False,
    ), keep_j, keep_v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output_path")
    ap.add_argument("-n", "--names", action="store_true",
                    help="print joint names and exit")
    ap.add_argument("-t", "--thresh", type=float, default=0.6,
                    help="min remaining joint weight to keep a vertex")
    ap.add_argument("-r", "--root", default="PELVIS",
                    help="new root joint name")
    ap.add_argument("-d", "--delete", action="append", default=[],
                    help="joint name to delete (repeatable)")
    add_model_args(ap)
    args = ap.parse_args(argv)

    if args.names:
        print(" ".join(SmplJoint.NAMES))
        return

    model = load_model(args)
    name_to_id = {n: i for i, n in enumerate(SmplJoint.NAMES)}
    delete = [name_to_id[n] for n in args.delete]
    root = name_to_id[args.root]

    arrays, keep_j, keep_v = trim_model(model, delete, root, args.thresh)
    os.makedirs(args.output_path, exist_ok=True)
    Jn = arrays["parent"].shape[0]
    kintree = np.stack([
        np.where(arrays["parent"] < 0, np.uint32(0xFFFFFFFF),
                 arrays["parent"].astype(np.uint32)),
        np.arange(Jn, dtype=np.uint32)])
    np.savez(os.path.join(args.output_path, "model.npz"),
             v_template=arrays["v_template"], kintree_table=kintree,
             f=arrays["faces"].astype(np.uint32),
             J_regressor=arrays["joint_reg"], weights=arrays["weights"],
             shapedirs=arrays["shapedirs"])
    print(f"wrote {args.output_path}: {keep_j.sum()} joints, "
          f"{keep_v.sum()} vertices")


if __name__ == "__main__":
    main()
