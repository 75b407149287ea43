"""The port's posed SMPL-X-topology body against SMPL-X's plain forward pass.

    python3 scripts/smplx_lbs_check.py [--device cuda] [--poses 20]

Builds the benchmark's SMPL-X stand-in (``benchmark/harness/models/
smplx_tube.py`` at ``benchmark/configs/fused_smplx_720p.json``'s sizes:
10,475 vertices, 55 joints, 20 shape keys), poses it at ``--poses`` seeded
poses, shapes and expressions through the port's ``core.lbs.lbs``
(``AvatarModel(arrays=...)``) and through ``benchmark/reference/
smplx_lbs.py``, and prints one JSON line: the largest vertex and joint
gaps (mm) with TF32 off on both sides, and with TF32 allowed in the plain
forward pass (the control, which has to miss ``--limit-mm``).  Exits 1
where the comparison exceeds the limit or the control does not.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]

from avatar_tpu_torch.core import rotation  # noqa: E402
from avatar_tpu_torch.core.lbs import lbs  # noqa: E402
from avatar_tpu_torch.core.model import AvatarModel  # noqa: E402
from harness import spec  # noqa: E402
from reference import smplx_lbs  # noqa: E402


def npz_arrays(arrays: dict) -> dict:
    """A generator's arrays under an SMPL-X ``model.npz``'s names."""
    parent = np.asarray(arrays["parent"])
    return dict(v_template=arrays["v_template"], shapedirs=arrays["shapedirs"],
                J_regressor=arrays["joint_reg"], weights=arrays["weights"],
                kintree_table=np.stack([parent, np.arange(len(parent))]))


def gaps(model, ref, poses, allow_tf32: bool):
    """The largest vertex and joint distance (m) over ``poses``."""
    dv = dj = 0.0
    for betas, expr, aa, p in poses:
        w = torch.cat([betas, expr])
        rots = rotation.so3_exp(aa)
        verts, joints, _, _ = lbs(model.params, model.parents, w, p, rots)
        transl = p - smplx_lbs.rest_joints(ref, betas, expr)[0]
        rv, rj = smplx_lbs.forward(ref, betas, expr, aa, transl, allow_tf32)
        dv = max(dv, float(torch.linalg.norm(verts - rv, dim=1).max()))
        dj = max(dj, float(torch.linalg.norm(joints - rj, dim=1).max()))
    return dv, dj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--poses", type=int, default=20)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--limit-mm", type=float, default=0.1)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    config = json.loads((ROOT / "benchmark" / "configs" /
                         "fused_smplx_720p.json").read_text())
    arrays = spec.model_generator("smplx_tube").arrays(config["model"])
    model = AvatarModel(arrays=arrays, device=dev)
    ref = smplx_lbs.load(npz_arrays(arrays), device=dev)
    rng = np.random.default_rng(args.seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    poses = [(t(rng.standard_normal(10)), t(rng.standard_normal(10)),
              t(rng.normal(0.0, 0.3, (55, 3))),
              t([rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3),
                 rng.uniform(2.0, 3.5)]))
             for _ in range(args.poses)]
    off = gaps(model, ref, poses, False)
    on = gaps(model, ref, poses, True)
    line = dict(device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
                vertices=model.num_points(), joints=model.num_joints(),
                poses=args.poses, limit_mm=args.limit_mm,
                tf32_off=dict(vertex_mm=off[0] * 1e3, joint_mm=off[1] * 1e3),
                tf32_allowed=dict(vertex_mm=on[0] * 1e3, joint_mm=on[1] * 1e3))
    print(json.dumps(line), flush=True)
    ok = off[0] * 1e3 <= args.limit_mm < on[0] * 1e3
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
