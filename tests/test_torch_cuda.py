"""The hand-written CUDA kernel against its plain PyTorch version, on the
card.  Imports no JAX (the card's machine has none); on a machine without
a CUDA device every test skips.  On the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py
"""

import pytest
import torch

from avatar_tpu_torch.optim import nn_kernel
from avatar_tpu_torch.perception.partgroups import SMPL24_NUM_GROUPS
from avatar_tpu_torch.testing import synthetic_nn_inputs


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
    before = nn_kernel.LAUNCHES
    d, i = nn_kernel.nn_argmin_ranges(*args, wild=SMPL24_NUM_GROUPS)
    torch.cuda.synchronize()
    assert nn_kernel.LAUNCHES == before + 1
    rd, ri = nn_kernel.nn_argmin_ranges_ref(*args, wild=SMPL24_NUM_GROUPS)
    assert torch.equal(i, ri)
    torch.testing.assert_close(d, rd, rtol=1e-6, atol=0.0)
    assert (i[args[1] == SMPL24_NUM_GROUPS] >= 0).all()
    assert (i[args[1] < 0] == -1).all()

    # full range at chunk 512 (6656 slots are not a multiple of 1024)
    d2, i2 = nn_kernel.nn_argmin(*args[:5], chunk=512,
                                 wild=SMPL24_NUM_GROUPS)
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
