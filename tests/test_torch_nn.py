"""Parity of the port's part-sorted NN with the JAX reference.

The plain PyTorch version of the CUDA kernel (``nn_argmin_ranges_ref``) is
held against the Pallas kernels run in interpret mode: indices equal, d2
within rtol 1e-6 (both compute (dx*dx + dy*dy) + dz*dz in float32; the
tolerance covers a contracted multiply-add on either side).  The plan and
the planned correspondence are held against the reference's, and the
unplanned ``find_nn_stats`` (B2) against the reference's Pallas branch,
or its norm-expansion XLA scan where that branch is off.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``, which imports no JAX (the card's machine has
none).
"""

import numpy as np
import pytest
import torch

import jax
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
    before = dict(nn_kernel.LAUNCHES)
    d, i = nn_kernel.nn_argmin_ranges(*inputs, wild=WILD)
    rd, ri = nn_kernel.nn_argmin_ranges_ref(*inputs, wild=WILD)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    assert nn_kernel.LAUNCHES == before



@pytest.fixture
def interpreted_b2(monkeypatch):
    """The reference's ``find_nn_stats`` on its Pallas branch, with B2's
    own body ``_kernel`` in interpret mode: ``nn_pallas.pl`` is swapped for
    a proxy whose ``pallas_call`` passes ``interpret=True``.  Yields the
    list of kernel bodies traced through it."""
    pl = nn_pallas.pl
    traced = []

    class InterpretPallas:
        def __getattr__(self, name):
            return getattr(pl, name)

        @staticmethod
        def pallas_call(kernel, *args, **kw):
            traced.append(kernel.func)
            return pl.pallas_call(kernel, *args, interpret=True, **kw)

    jax.clear_caches()
    monkeypatch.setattr(jcorr, "_pallas_enabled", lambda: True)
    monkeypatch.setattr(nn_pallas, "pl", InterpretPallas())
    yield traced
    jax.clear_caches()


def test_b2_kernel_body_matches_plain(interpreted_b2):
    """B2's Pallas body ``_kernel`` at the reference's chunk 1024, with
    unsorted clouds, wildcards and pad slots of part -2, against the plain
    version of the port's kernel."""
    data, dpart, model, mpart, visible = _clouds(6, P=1800)
    pad = 2048 - model.shape[0]
    model = np.concatenate([model, np.zeros((pad, 3), np.float32)])
    mpart = np.concatenate([mpart, np.full(pad, -2, np.int32)])
    visible = np.concatenate([visible, np.zeros(pad, bool)])
    inputs = (data, dpart, model, mpart, visible)
    ref_d, ref_i = nn_pallas.nn_argmin(*[jnp.asarray(a) for a in inputs],
                                       tile_n=256, chunk=1024, wild=WILD)
    got_d, got_i = nn_kernel.nn_argmin_ref(
        *[torch.as_tensor(a) for a in inputs], tile_n=256, chunk=1024,
        wild=WILD)
    ref_i = np.asarray(ref_i)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    ok = ref_i >= 0
    np.testing.assert_allclose(got_d.numpy()[ok], np.asarray(ref_d)[ok],
                               rtol=1e-6)
    assert (ref_i[dpart == WILD] >= 0).all() and (ref_i < 1800).all()
    assert interpreted_b2 == [nn_pallas._kernel]


def _stats_inputs(seed, N, P=1500, n_data=None):
    rng = np.random.default_rng(seed)
    n_data = N if n_data is None else n_data
    model = rng.normal(size=(P, 3)).astype(np.float32)
    mpart = rng.integers(0, NUM_PARTS, P).astype(np.int32)
    visible = rng.random(P) < 0.7
    data = rng.normal(size=(N, 3)).astype(np.float32)
    dpart = np.full(N, -1, np.int32)
    dpart[:n_data] = rng.integers(0, NUM_PARTS, n_data)
    dpart[:n_data:9] = WILD
    return data, dpart, model, mpart, visible


def _both_stats(inputs, gate2):
    ref = jcorr.find_nn_stats(*[jnp.asarray(a) for a in inputs], wild=WILD,
                              wild_gate2=jnp.float32(gate2))
    got = tcorr.find_nn_stats(*[torch.as_tensor(a) for a in inputs],
                              wild=WILD, wild_gate2=torch.tensor(gate2))
    np.testing.assert_array_equal(got.corr.numpy(), np.asarray(ref.corr))
    assert float(got.n_matched) == float(ref.n_matched)
    return got, ref


@pytest.mark.parametrize("N", [512, 1024])
def test_find_nn_stats_matches_pallas_branch(interpreted_b2, N):
    """The port's unplanned NN (B2's plain version here) against the
    reference's Pallas branch: corr and n_matched equal; cnt, s and q
    within 1e-6 relative (float32 sums in another order)."""
    inputs = _stats_inputs(N, N, n_data=N - 100)
    got, ref = _both_stats(inputs, np.float32(0.02))
    assert interpreted_b2 == [nn_pallas._kernel]
    assert (got.corr.numpy()[inputs[1] == WILD] == -1).any(), "gate bites"
    np.testing.assert_allclose(got.cnt.numpy(), np.asarray(ref.cnt),
                               rtol=1e-6)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(ref.s), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(got.q), float(ref.q), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_find_nn_stats_unaligned_matches_xla_branch(seed):
    """N = 97 rows, where the reference's Pallas branch is off: the
    reference scans by norm expansion, the port pads to 256 rows and takes
    direct differences.  corr equal on these seeds (no near-tie within the
    two roundings), statistics within 1e-5."""
    inputs = _stats_inputs(seed, 97, P=200)
    got, ref = _both_stats(inputs, np.float32(4.0))
    np.testing.assert_allclose(got.cnt.numpy(), np.asarray(ref.cnt),
                               atol=1e-5)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(ref.s), atol=1e-5)
    np.testing.assert_allclose(float(got.q), float(ref.q), rtol=1e-5)


def test_backface_visibility_matches_reference():
    rng = np.random.default_rng(9)
    cloud = rng.normal(size=(400, 3)).astype(np.float32)
    faces = rng.integers(0, 400, (600, 3)).astype(np.int32)
    ref = np.asarray(jcorr.backface_visibility(jnp.asarray(cloud),
                                               jnp.asarray(faces)))
    got = tcorr.backface_visibility(torch.as_tensor(cloud),
                                    torch.as_tensor(faces))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < 400


def test_merge_key_orders_like_the_kernel():
    """The 64-bit key the kernel's work units merge through: the smaller
    d2 first, then the smaller index; d2 = 0 below everything; (3e38, -1),
    no candidate, above every candidate; and the round trip is exact."""
    d2 = torch.tensor([0.0, 0.0, 1e-30, 2.5, 2.5, 2.5000002, 2.9e38, 3.0e38],
                      dtype=torch.float32)
    idx = torch.tensor([0, 7, 3, 2 ** 31 - 1, 5, 0, 6655, -1],
                       dtype=torch.int32)
    key = nn_kernel.pack_key(d2, idx)
    assert int(key[-1]) == nn_kernel.NO_KEY and (key >= 0).all()
    want = sorted(range(8), key=lambda k: (float(d2[k]), int(idx[k]) % 2 ** 32))
    assert torch.argsort(key).tolist() == want == [0, 1, 2, 4, 3, 5, 6, 7]
    rd, ri = nn_kernel.unpack_key(key)
    assert torch.equal(rd, d2) and torch.equal(ri, idx)
    assert rd.dtype == torch.float32 and ri.dtype == torch.int32


@pytest.mark.parametrize("seed,chunk,unit", [(0, 512, 512), (1, 256, 128)])
def test_units_merged_through_the_key_equal_the_whole_scan(seed, chunk, unit):
    """The kernel's decomposition on the plain version: every (tile,
    ``unit`` slots of one chunk) scanned alone, merged per row with a
    minimum of the packed key, gives the whole scan's (d2, index) to the
    bit, in any order of the units."""
    inputs = [torch.as_tensor(np.array(a)) for a in
              _planned_inputs(*_clouds(seed), 256, chunk)]
    dpts, dpart, xs, mpart, vis, cstart, cend = inputs
    want_d, want_i = nn_kernel.nn_argmin_ranges_ref(*inputs, chunk=chunk,
                                                    wild=WILD)
    N, Pp = dpts.shape[0], xs.shape[0]
    key = torch.full((N,), nn_kernel.NO_KEY, dtype=torch.int64)
    n_units = Pp // unit
    for u in np.random.default_rng(seed).permutation(n_units):
        chunk_of = torch.full_like(cstart, int(u * unit // chunk))
        lo = torch.maximum(cstart, chunk_of)
        hi = torch.minimum(cend, chunk_of + 1)
        # only the unit's slots are visible to this scan
        here = torch.zeros_like(vis)
        here[u * unit:(u + 1) * unit] = True
        d, i = nn_kernel.nn_argmin_ranges_ref(
            dpts, dpart, xs, mpart, vis & here, lo, hi, chunk=chunk,
            wild=WILD)
        key = torch.minimum(key, nn_kernel.pack_key(d, i))
    got_d, got_i = nn_kernel.unpack_key(key)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    assert (want_i >= 0).any() and (want_i == -1).any()


@pytest.mark.parametrize("N,model_sorted,gate2", [
    (512, False, 0.5), (1024, False, None), (512, True, None),
    (1024, True, 0.5)])
def test_fused_search_plain_version_matches_reference(N, model_sorted, gate2):
    """``nn_match``'s plain version (what the fused CUDA entry is held to on
    the card) against the reference's ``find_nn_stats_planned`` with its
    Pallas kernel in interpret mode: corr and n_matched equal, with and
    without the model permutation, with wildcards and the wildcard gate;
    best_d within rtol 1e-6 of the Pallas kernel's on the same inputs."""
    data, dpart, model, mpart, visible = _clouds(
        N, N=N, n_data=N - 100, n_wild=60)
    if model_sorted:
        order = np.argsort(mpart, kind="stable")
        model, mpart, visible = model[order], mpart[order], visible[order]
    jplan = jcorr.make_nn_plan(jnp.asarray(data), jnp.asarray(dpart),
                               jnp.asarray(mpart), num_parts=NUM_PARTS,
                               model_sorted=model_sorted)
    tplan = tcorr.make_nn_plan(torch.as_tensor(data), torch.as_tensor(dpart),
                               torch.as_tensor(mpart), num_parts=NUM_PARTS,
                               model_sorted=model_sorted)
    assert (tplan.match.mperm is None) == model_sorted
    ref = jcorr.find_nn_stats_planned(
        jplan, jnp.asarray(model), jnp.asarray(visible), interpret=True,
        wild=WILD, wild_gate2=None if gate2 is None else jnp.float32(gate2))
    tmodel, tvis = torch.as_tensor(model), torch.as_tensor(visible)
    center = torch.mean(tmodel, dim=0)
    gate = None if gate2 is None else torch.tensor(gate2)
    best_d, corr, wgt, n_matched = nn_kernel.nn_match(
        tplan.match, tmodel, center, tvis, WILD, gate)
    np.testing.assert_array_equal(corr.numpy(), np.asarray(ref.corr))
    assert float(n_matched) == float(ref.n_matched) == float(wgt.sum())
    assert corr.dtype == torch.int32 and (corr >= 0).sum() == int(n_matched)
    wild_rows = tplan.dpart.numpy() == WILD
    assert (corr.numpy()[wild_rows] >= 0).any(), "wildcards match"
    if gate2 is not None:
        assert (corr.numpy()[wild_rows] == -1).any(), "the gate bites"
    # the entry point built on it gives the same
    st = tcorr.find_nn_stats_planned(tplan, tmodel, tvis, wild=WILD,
                                     wild_gate2=gate)
    assert torch.equal(st.corr, corr) and float(st.n_matched) == \
        float(n_matched)
    # distances: the Pallas kernel on the inputs the plain version built
    args = nn_kernel.match_inputs(tplan.match, tmodel, center, tvis)
    pd, pi = nn_pallas.nn_argmin_ranges(
        *[jnp.asarray(a.numpy()) for a in args], tile_n=256, chunk=512,
        interpret=True, wild=WILD)
    ok = np.asarray(pi) >= 0
    np.testing.assert_allclose(best_d.numpy()[ok], np.asarray(pd)[ok],
                               rtol=1e-6)
    np.testing.assert_array_equal(best_d.numpy()[~ok], np.asarray(pd)[~ok])
