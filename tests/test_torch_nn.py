"""Parity of the port's part-sorted NN with the JAX reference.

The plain PyTorch version of the CUDA kernel (``nn_argmin_ranges_ref``) is
held against the Pallas kernel run in interpret mode: indices equal, d2
within rtol 1e-6 (both compute (dx*dx + dy*dy) + dz*dz in float32; the
tolerance covers a contracted multiply-add on either side).  The plan and
the planned correspondence are held against the reference's.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``, which imports no JAX (the card's machine has
none).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avatar_tpu.optim import correspond as jcorr
from avatar_tpu.optim import nn_pallas
from avatar_tpu_torch.optim import correspond as tcorr
from avatar_tpu_torch.optim import nn_kernel

WILD = 6
NUM_PARTS = 6


def _clouds(seed, N=1024, P=700, n_data=900, n_wild=100):
    rng = np.random.default_rng(seed)
    model = rng.normal(size=(P, 3)).astype(np.float32)
    mpart = rng.integers(0, NUM_PARTS, P).astype(np.int32)
    visible = rng.random(P) < 0.7
    data = rng.normal(size=(N, 3)).astype(np.float32)
    dpart = np.full(N, -1, np.int32)
    dpart[:n_data] = rng.integers(0, NUM_PARTS, n_data)
    dpart[n_data - n_wild:n_data] = WILD
    return data, dpart, model, mpart, visible


def _planned_inputs(data, dpart, model, mpart, visible, tile_n, chunk):
    """Sorted, padded kernel inputs from the reference's plan."""
    plan = jcorr.make_nn_plan(jnp.asarray(data), jnp.asarray(dpart),
                              jnp.asarray(mpart), num_parts=NUM_PARTS,
                              tile_n=tile_n, chunk=chunk)
    perm = np.asarray(plan.mperm)
    P = model.shape[0]
    xs = model[perm]
    vis = visible[perm] & (np.arange(perm.shape[0]) < P)
    return (np.array(plan.dpts), np.array(plan.dpart), xs,
            np.array(plan.mpart_s), vis, np.array(plan.cstart),
            np.array(plan.cend))


def _run_both(inputs, tile_n, chunk):
    ref_d, ref_i = nn_pallas.nn_argmin_ranges(
        *[jnp.asarray(a) for a in inputs], tile_n=tile_n, chunk=chunk,
        interpret=True, wild=WILD)
    got_d, got_i = nn_kernel.nn_argmin_ranges_ref(
        *[torch.as_tensor(np.array(a)) for a in inputs], tile_n=tile_n,
        chunk=chunk, wild=WILD)
    return (np.asarray(ref_d), np.asarray(ref_i), got_d.numpy(),
            got_i.numpy())


@pytest.mark.parametrize("seed,tile_n,chunk", [(0, 256, 512), (1, 128, 128)])
def test_ranges_ref_matches_pallas(seed, tile_n, chunk):
    inputs = _planned_inputs(*_clouds(seed), tile_n, chunk)
    ref_d, ref_i, got_d, got_i = _run_both(inputs, tile_n, chunk)
    np.testing.assert_array_equal(got_i, ref_i)
    ok = ref_i >= 0
    np.testing.assert_allclose(got_d[ok], ref_d[ok], rtol=1e-6)
    np.testing.assert_array_equal(got_d[~ok], ref_d[~ok])
    assert (ref_i[inputs[1] == WILD] >= 0).any(), "exercise wildcards"
    assert (ref_i[inputs[1] < 0] == -1).all(), "padding never matches"


def test_full_range_matches_pallas():
    """The B2 port: every tile scans the whole model axis."""
    data, dpart, model, mpart, visible = _clouds(2, P=1024)
    chunk, tile_n = 256, 256
    cs, ce = nn_kernel._full_range(data.shape[0], model.shape[0], tile_n,
                                   chunk, "cpu")
    inputs = (data, dpart, model, mpart, visible, cs.numpy(), ce.numpy())
    ref_d, ref_i, got_d, got_i = _run_both(inputs, tile_n, chunk)
    np.testing.assert_array_equal(got_i, ref_i)
    b2_d, b2_i = nn_kernel.nn_argmin_ref(
        *[torch.as_tensor(a) for a in (data, dpart, model, mpart, visible)],
        tile_n=tile_n, chunk=chunk, wild=WILD)
    np.testing.assert_array_equal(b2_i.numpy(), ref_i)
    np.testing.assert_allclose(b2_d.numpy()[ref_i >= 0],
                               ref_d[ref_i >= 0], rtol=1e-6)


def test_duplicated_vertices_lowest_index_wins():
    """Exact ties inside a chunk and across chunks go to the lowest index,
    in the kernel's plain version as in the Pallas kernel."""
    chunk, tile_n = 128, 128
    rng = np.random.default_rng(5)
    P = 512
    model = rng.normal(size=(P, 3)).astype(np.float32)
    mpart = np.zeros(P, np.int32)
    visible = np.ones(P, bool)
    # vertex 7 duplicated in its own chunk (40) and in two later chunks
    for j in (40, 200, 400):
        model[j] = model[7]
    data = np.zeros((256, 3), np.float32)
    data[:] = model[7] + rng.normal(0, 1e-3, 3).astype(np.float32)
    dpart = np.zeros(256, np.int32)
    dpart[128:] = WILD
    cs = np.zeros(2, np.int32)
    ce = np.full(2, P // chunk, np.int32)
    inputs = (data, dpart, model, mpart, visible, cs, ce)
    ref_d, ref_i, got_d, got_i = _run_both(inputs, tile_n, chunk)
    assert (got_i == 7).all() and (ref_i == 7).all()
    visible[7] = False                      # next duplicate: same chunk
    ref_d, ref_i, got_d, got_i = _run_both(inputs, tile_n, chunk)
    assert (got_i == 40).all() and (ref_i == 40).all()
    visible[40] = False                     # then the earlier chunk
    ref_d, ref_i, got_d, got_i = _run_both(inputs, tile_n, chunk)
    assert (got_i == 200).all() and (ref_i == 200).all()


@pytest.mark.parametrize("model_sorted", [False, True])
def test_plan_and_planned_stats_match_reference(model_sorted):
    data, dpart, model, mpart, visible = _clouds(3)
    if model_sorted:
        order = np.argsort(mpart, kind="stable")
        model, mpart, visible = model[order], mpart[order], visible[order]
    gate2 = np.float32(0.5)
    jplan = jcorr.make_nn_plan(jnp.asarray(data), jnp.asarray(dpart),
                               jnp.asarray(mpart), num_parts=NUM_PARTS,
                               model_sorted=model_sorted)
    tplan = tcorr.make_nn_plan(torch.as_tensor(data), torch.as_tensor(dpart),
                               torch.as_tensor(mpart), num_parts=NUM_PARTS,
                               model_sorted=model_sorted)
    for f in ("dpts", "dpart", "mpart_s", "cstart", "cend"):
        np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                      np.asarray(getattr(jplan, f)), f)
    assert (tplan.mperm is None) == model_sorted
    if not model_sorted:
        np.testing.assert_array_equal(tplan.mperm.numpy(),
                                      np.asarray(jplan.mperm))
    ref = jcorr.find_nn_stats_planned(
        jplan, jnp.asarray(model), jnp.asarray(visible), with_stats=True,
        interpret=True, wild=WILD, wild_gate2=jnp.asarray(gate2))
    got = tcorr.find_nn_stats_planned(
        tplan, torch.as_tensor(model), torch.as_tensor(visible),
        with_stats=True, wild=WILD, wild_gate2=torch.tensor(gate2))
    np.testing.assert_array_equal(got.corr.numpy(), np.asarray(ref.corr))
    assert float(got.n_matched) == float(ref.n_matched)
    np.testing.assert_allclose(got.cnt.numpy(), np.asarray(ref.cnt))
    np.testing.assert_allclose(got.s.numpy(), np.asarray(ref.s), atol=1e-5)
    np.testing.assert_allclose(float(got.q), float(ref.q), rtol=1e-5)


def test_cpu_wrapper_takes_plain_version_without_launching():
    inputs = [torch.as_tensor(a) for a in
              _planned_inputs(*_clouds(4), 256, 512)]
    before = nn_kernel.LAUNCHES
    d, i = nn_kernel.nn_argmin_ranges(*inputs, wild=WILD)
    rd, ri = nn_kernel.nn_argmin_ranges_ref(*inputs, wild=WILD)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    assert nn_kernel.LAUNCHES == before
