"""On the card: the hand-written CUDA kernel against its plain PyTorch
version (B1 at the fit's planned shapes, B2 at the unplanned
``find_nn_stats``'s), and the renderer and ``find_nn_stats`` against the
same functions on the CPU.  Imports
no JAX (the card's machine has none); on a machine without a CUDA device
every test skips.  On the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from avatar_tpu_torch.optim import correspond, nn_kernel
from avatar_tpu_torch.perception.partgroups import SMPL24_NUM_GROUPS
from avatar_tpu_torch.testing import (synthetic_nn_inputs,
                                      synthetic_nn_stats_inputs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [8192, 32768])
def test_kernel_matches_plain_at_fit_shapes(cuda, n_rows):
    """B1 (ranged) and B2 (full range): indices equal, d2 within rtol 1e-6
    (both round every product and sum on its own)."""
    args = synthetic_nn_inputs(n_rows, seed=n_rows, device=cuda)
    assert args[2].shape[0] == 6656
    before = dict(nn_kernel.LAUNCHES)
    d, i = nn_kernel.nn_argmin_ranges(*args, wild=SMPL24_NUM_GROUPS)
    torch.cuda.synchronize()
    assert nn_kernel.LAUNCHES == {**before, "nn_argmin_ranges":
                                  before["nn_argmin_ranges"] + 1}
    rd, ri = nn_kernel.nn_argmin_ranges_ref(*args, wild=SMPL24_NUM_GROUPS)
    assert torch.equal(i, ri)
    torch.testing.assert_close(d, rd, rtol=1e-6, atol=0.0)
    assert (i[args[1] == SMPL24_NUM_GROUPS] >= 0).all()
    assert (i[args[1] < 0] == -1).all()

    # full range at chunk 512 (6656 slots are not a multiple of 1024)
    d2, i2 = nn_kernel.nn_argmin(*args[:5], chunk=512,
                                 wild=SMPL24_NUM_GROUPS)
    assert nn_kernel.LAUNCHES["nn_argmin"] == before["nn_argmin"] + 1
    rd2, ri2 = nn_kernel.nn_argmin_ref(*args[:5], chunk=512,
                                       wild=SMPL24_NUM_GROUPS)
    assert torch.equal(i2, ri2)
    torch.testing.assert_close(d2, rd2, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    args = list(synthetic_nn_inputs(1024, seed=1, device=cuda))
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin_ranges(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin_ranges(*args[:2], args[2].cpu(), *args[3:])
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin_ranges(*args, chunk=500)


@pytest.mark.cuda
def test_rasterize_on_card_matches_cpu(cuda):
    """The z-buffer raster of a posed detail-6 avatar at 1280x720 on the
    card against the same function on the CPU: face ids equal on >= 99.9%
    of pixels, depth within 1e-5 m where they are."""
    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.render import raster
    from avatar_tpu_torch.testing import synthetic_model

    model = synthetic_model(detail=6, device="cpu")
    ava = Avatar(model)
    ava.randomize(seed=77)
    ava.p = np.array([0.0, 0.1, 2.6])
    ava.r[0] = np.diag([-1.0, 1.0, -1.0])
    ava.update()
    cloud = torch.as_tensor(ava.cloud)
    proj = raster.project_points(cloud, 606.438, 606.351, 637.294, 366.992)
    faces = torch.as_tensor(model.faces, dtype=torch.int32)
    budget = raster.default_budget(720, 1280, model.num_faces())
    ref = raster.rasterize(proj, cloud[:, 2], faces, 720, 1280, budget)
    got = raster.rasterize(proj.to(cuda), cloud[:, 2].to(cuda),
                           faces.to(cuda), 720, 1280, budget)
    same = (got.fid.cpu() == ref.fid)
    assert int((ref.fid >= 0).sum()) > 10000
    assert float(same.float().mean()) >= 0.999
    assert int(got.n_dropped) == int(ref.n_dropped)
    torch.testing.assert_close(got.depth.cpu()[same], ref.depth[same],
                               rtol=0.0, atol=1e-5)


@pytest.mark.cuda
def test_render_frame_on_card_matches_cpu(cuda):
    """``render_frame`` (depth, part mask) on the card against the CPU."""
    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.render import raster, renderer
    from avatar_tpu_torch.testing import synthetic_model

    model = synthetic_model(detail=6, device="cpu")
    ava = Avatar(model)
    ava.randomize(seed=20)
    ava.p = np.array([0.1, 0.0, 2.4])
    ava.update()
    args = (torch.as_tensor(ava.cloud),
            torch.as_tensor(model.faces, dtype=torch.int32),
            torch.as_tensor(model.main_joint, dtype=torch.int32))
    intr = (606.438, 606.351, 637.294, 366.992, 720, 1280,
            raster.default_budget(720, 1280, model.num_faces()))
    ref = renderer.render_frame(*args, *intr)
    got = renderer.render_frame(*(a.to(cuda) for a in args), *intr)
    same = got.fid.cpu() == ref.fid
    assert float(same.float().mean()) >= 0.999
    torch.testing.assert_close(got.depth.cpu()[same], ref.depth[same],
                               rtol=0.0, atol=1e-5)
    assert torch.equal(got.part_mask.cpu()[same], ref.part_mask[same])


@pytest.mark.cuda
def test_b2_at_find_nn_stats_shapes(cuda):
    """B2 as ``find_nn_stats`` launches it: 8192 unsorted rows, the model
    axis padded to 7168 slots with invisible slots of part -2, chunk 1024.
    Indices equal to the plain version's, d2 equal to the last bit."""
    data, dpart, verts, part, visible = synthetic_nn_stats_inputs(
        8192, device=cuda)
    c = verts.mean(0)
    args = correspond.unplanned_nn_inputs(data - c, dpart, verts - c, part,
                                          visible)
    assert args[2].shape[0] == 7168 and (args[3][6624:] == -2).all()
    before = nn_kernel.LAUNCHES["nn_argmin"]
    d, i = nn_kernel.nn_argmin(*args, wild=SMPL24_NUM_GROUPS)
    torch.cuda.synchronize()
    assert nn_kernel.LAUNCHES["nn_argmin"] == before + 1
    rd, ri = nn_kernel.nn_argmin_ref(*args, wild=SMPL24_NUM_GROUPS)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    assert (i[args[1] == SMPL24_NUM_GROUPS] >= 0).all()
    assert (i[args[1] < 0] == -1).all() and (i < 6624).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [8192, 5000])
def test_find_nn_stats_on_card_matches_cpu(cuda, n_rows):
    """``find_nn_stats`` on the card (B2) against its CPU result (the plain
    version): corr and n_matched equal, cnt equal, s and q within 1e-6
    relative (scatter-adds in another order)."""
    args = synthetic_nn_stats_inputs(n_rows, seed=n_rows, device="cpu")
    kw = dict(wild=SMPL24_NUM_GROUPS, wild_gate2=torch.tensor(0.04))
    ref = correspond.find_nn_stats(*args, **kw)
    got = correspond.find_nn_stats(*(a.to(cuda) for a in args),
                                   wild=SMPL24_NUM_GROUPS,
                                   wild_gate2=torch.tensor(0.04,
                                                           device=cuda))
    assert torch.equal(got.corr.cpu(), ref.corr)
    assert float(got.n_matched) == float(ref.n_matched) > n_rows // 2
    assert torch.equal(got.cnt.cpu(), ref.cnt)
    torch.testing.assert_close(got.s.cpu(), ref.s, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.q.cpu(), ref.q, rtol=1e-6, atol=0.0)
