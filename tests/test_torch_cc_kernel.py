"""Connected components' hand-written CUDA kernel (``perception/cc_kernel.py``,
``csrc/cc_label.cu``) against its plain PyTorch version
(``cc.connected_components_plain``, the eager sweep loop).

On the card, labels and sizes equal to the bit: at the main path's four
shapes (the fused tracker's 60x107 background grid with the distance gate
and its 120x214 part grid, both strided views as the tracker passes them;
the host tracker's 360x640 part and XYZ grids), on an empty and an
all-active mask, on 1 x N and N x 1 grids, on thresholds at exact ties,
and on a serpentine component that needs more than 64 sweeps, where the
kernel stops at the cap as the loop does; one launch per call, no read of
the card.  On the CPU: ``Dist2Gate`` equals the gate it replaced, the
port's components with it equal the JAX package's, and the wrapper's
argument checks raise without a device.  The card tests import no JAX and
skip without a CUDA device.  On the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cc_kernel.py
"""

import numpy as np
import pytest
import torch

from avatar_tpu_torch import profiling
from avatar_tpu_torch.perception import cc, cc_kernel

FRAMES = "tests/fixtures/torch_port_720p.npz"
FX = FY = 606.4
NB_T = np.float32(1200000.0 / (720 * 1280) * 0.005)   # the trackers' scale


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _xyz(depth_m: np.ndarray, stride: int) -> np.ndarray:
    """[H, W, 3] camera-space XYZ of a 720p depth map sampled every
    ``stride`` pixels."""
    d = depth_m[::stride, ::stride]
    yy, xx = np.mgrid[0:d.shape[0], 0:d.shape[1]].astype(np.float32)
    return np.stack([(xx * stride - 640.0) * d / FX,
                     (yy * stride - 360.0) * d / FY, d], -1).astype(
        np.float32)


def _frame(seed: int) -> np.ndarray:
    """Frame 1 of the 720p fixture in meters with sensor noise, patches of
    heavy noise (edges that the gate cuts) and holes."""
    rng = np.random.default_rng(seed)
    d = np.load(FRAMES)["depth"][1].astype(np.float32) * 1e-3
    d = d + rng.normal(0, 0.004, d.shape).astype(np.float32)
    patch = rng.random((d.shape[0] // 40 + 1, d.shape[1] // 40 + 1)) < 0.3
    heavy = np.kron(patch, np.ones((40, 40), bool))[:d.shape[0], :d.shape[1]]
    d = np.where(heavy, d + rng.normal(0, 0.08, d.shape), d)
    d[rng.random(d.shape) < 0.02] = 0.0
    return d.astype(np.float32)


def _parts(shape, seed: int) -> np.ndarray:
    """A uint8 part map: blocks of one part each, 5% of pixels another
    part, a third of the grid background (255)."""
    rng = np.random.default_rng(seed)
    H, W = shape
    blocks = rng.integers(0, 14, (H // 9 + 1, W // 13 + 1))
    p = np.kron(blocks, np.ones((9, 13), np.int64))[:H, :W]
    p = np.where(rng.random((H, W)) < 0.05, rng.integers(0, 14, (H, W)), p)
    bg = np.kron(rng.random((H // 5 + 1, W // 5 + 1)) < 0.33,
                 np.ones((5, 5), bool))[:H, :W]
    return np.where(bg, 255, p).astype(np.uint8)


def _serpentine(H: int, W: int) -> np.ndarray:
    """One path up and down every other column: more sweeps than its
    size in pointer jumps would suggest (74 at 64x64, 110 at 100x40)."""
    a = np.zeros((H, W), bool)
    a[:, ::2] = True
    for i, c in enumerate(range(0, W - 2, 2)):
        a[H - 1 if i % 2 == 0 else 0, c:c + 3] = True
    return a


def _equal(active, values=None, gate=None, max_iters=64):
    """The kernel's labels and sizes equal the plain loop's on the card, to
    the bit; one launch, counted in the open scope.  Returns the labels."""
    before = cc_kernel.LAUNCHES
    with profiling.stage_clock(active.device) as clock:
        with profiling.scope("cc"):
            got = cc.connected_components(active, gate, values, max_iters)
    assert cc_kernel.LAUNCHES == before + 1
    assert clock.stages["cc"]["counts"] == {"cc_launches": 1}
    ref = cc.connected_components_plain(active, gate, values, max_iters)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == active.shape
    assert torch.equal(got, ref), int((got != ref).sum())
    sizes = cc.component_sizes(got)
    assert sizes.dtype == torch.int32
    assert torch.equal(sizes.cpu(), cc.component_sizes(ref.cpu()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_at_the_main_path_shapes(cuda, seed):
    """The fused tracker's background grid (a 1/4 view of the stride-3
    frame, 60x107, distance gate at ``nb_t * 4``) and part grid (a 1/2
    view of a 240x427 map, 120x214); the host tracker's 360x640 part map
    and XYZ map (stride 2, distance gate at ``nb_t``)."""
    depth = _frame(seed)
    xyz_s = torch.as_tensor(_xyz(depth, 3), device=cuda)
    fg = (xyz_s[..., 2] > 0) & (xyz_s[..., 2] < 3.9)
    fg_c, xyz_c = fg[::4, ::4], xyz_s[::4, ::4]
    assert tuple(fg_c.shape) == (60, 107) and not xyz_c.is_contiguous()
    thresh = torch.tensor(NB_T, device=cuda)
    _equal(fg_c, xyz_c, cc.Dist2Gate(thresh * 4))
    labels_s = torch.as_tensor(_parts((240, 427), seed), device=cuda)
    lab_c = labels_s[::2, ::2]
    assert tuple(lab_c.shape) == (120, 214)
    _equal(lab_c != 255, lab_c)
    parts = torch.as_tensor(_parts((360, 640), seed + 7), device=cuda)
    _equal(parts != 255, parts)
    xyz = torch.as_tensor(_xyz(depth, 2), device=cuda)
    labels = _equal(xyz[..., 2] > 0, xyz, cc.Dist2Gate(thresh))
    assert int((labels >= 0).sum()) > 100000
    assert len(torch.unique(labels)) > 50


@pytest.mark.cuda
def test_kernel_matches_plain_on_empty_and_full_masks(cuda):
    H, W = 120, 214
    empty = torch.zeros((H, W), dtype=torch.bool, device=cuda)
    full = torch.ones((H, W), dtype=torch.bool, device=cuda)
    same = torch.full((H, W), 3, dtype=torch.uint8, device=cuda)
    xyz = torch.zeros((H, W, 3), dtype=torch.float32, device=cuda)
    thresh = torch.tensor(0.0, device=cuda)
    assert (_equal(empty) == -1).all()
    assert (_equal(empty, same) == -1).all()
    assert (_equal(empty, xyz, cc.Dist2Gate(thresh)) == -1).all()
    assert (_equal(full) == 0).all()
    assert (_equal(full, same) == 0).all()
    assert (_equal(full, xyz, cc.Dist2Gate(thresh)) == 0).all()
    assert int(cc.component_sizes(_equal(full))[0]) == H * W


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1000), (1000, 1), (1, 1), (3, 1)])
def test_kernel_matches_plain_on_thin_grids(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    active = torch.as_tensor(rng.random(shape) < 0.8, device=cuda)
    values = torch.as_tensor(rng.integers(0, 2, shape).astype(np.uint8),
                             device=cuda)
    _equal(active)
    _equal(active, values)


@pytest.mark.cuda
def test_kernel_matches_plain_at_exact_ties(cuda):
    """XYZ on a lattice of quarter metres: squared distances 0.0625, 0.125
    and 0.3125 exactly.  At a threshold of 0.125 the ties join (``<=``);
    one float below it they do not."""
    rng = np.random.default_rng(3)
    H, W = 96, 128
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    z = rng.integers(0, 2, (H, W)).astype(np.float32) * 0.25
    xyz = torch.as_tensor(np.stack([xx * 0.25, yy * 0.25, z], -1),
                          device=cuda)
    active = torch.as_tensor(rng.random((H, W)) < 0.9, device=cuda)
    tie = np.float32(0.125)
    below = np.nextafter(tie, np.float32(0))
    at = _equal(active, xyz, cc.Dist2Gate(torch.tensor(tie, device=cuda)))
    off = _equal(active, xyz, cc.Dist2Gate(torch.tensor(below,
                                                        device=cuda)))
    assert len(torch.unique(off)) > len(torch.unique(at))


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters", [0, 1, 2, 63, 64, 4096])
def test_kernel_stops_at_the_cap_as_the_loop_does(cuda, max_iters):
    """A serpentine of 110 sweeps (100x40): below that the labels are the
    loop's after ``max_iters`` sweeps, not the components'."""
    active = torch.as_tensor(_serpentine(100, 40), device=cuda)
    got = _equal(active, max_iters=max_iters)
    done = (got[active] == 0).all()
    assert bool(done) == (max_iters == 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True])
def test_kernel_and_sizes_read_nothing_from_the_card(cuda, deterministic):
    """Labelling and sizes raise no synchronisation (every one outside a
    counted read raises here), with deterministic algorithms off and on."""
    parts = torch.as_tensor(_parts((360, 640), 5), device=cuda)
    xyz = torch.as_tensor(_xyz(_frame(5), 2), device=cuda)
    gate = cc.Dist2Gate(torch.tensor(NB_T, device=cuda))
    cc_kernel.build()
    torch.cuda.synchronize()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        with profiling.counted_syncs_only():
            a = cc.connected_components(parts != 255, values=parts)
            b = cc.connected_components(xyz[..., 2] > 0, gate, xyz)
            sizes = [cc.component_sizes(a), cc.component_sizes(b)]
    finally:
        torch.use_deterministic_algorithms(was)
    for lab, s in zip((a, b), sizes):
        assert torch.equal(s.cpu(), cc.component_sizes(lab.cpu()))


# --- on the CPU ---------------------------------------------------------


def _lambda_gate(thresh):
    """The gate ``Dist2Gate`` replaced in both background subtractors."""
    def gate(vals, shifted):
        d = (vals - shifted) ** 2
        return d[..., 0] + d[..., 1] + d[..., 2] <= thresh
    return gate


@pytest.mark.parametrize("as_tensor", [False, True])
def test_dist2_gate_equals_the_gate_it_replaced(as_tensor):
    rng = np.random.default_rng(1)
    vals = torch.as_tensor(rng.integers(-4, 5, (64, 48, 3)).astype(
        np.float32) * 0.25 + rng.normal(0, 1e-3, (64, 48, 3)).astype(
        np.float32) * (rng.random((64, 48, 1)) < 0.5))
    shifted = torch.roll(vals, 1, 0)
    for t in (0.0625, 0.125, 1.0, 2.5):
        thresh = torch.tensor(t, dtype=torch.float32) if as_tensor else t
        got = cc.Dist2Gate(thresh)(vals, shifted)
        assert torch.equal(got, _lambda_gate(thresh)(vals, shifted))
        assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("seed", [2, 4])
def test_dist2_gate_components_match_reference(seed):
    """The port's components with ``Dist2Gate`` on the CPU equal the JAX
    package's with its gate, and the plain loop's with the old gate; the
    CPU launches no kernel."""
    jnp = pytest.importorskip("jax.numpy")
    from avatar_tpu.perception import bgsub as jbgsub

    rng = np.random.default_rng(seed)
    xyz = _xyz(_frame(seed), 12)
    active = (xyz[..., 2] > 0) & (rng.random(xyz.shape[:2]) < 0.9)
    nb = np.float32(0.05)
    ref, _ = jbgsub._components(jnp.asarray(xyz), jnp.asarray(active), nb)
    before = cc_kernel.LAUNCHES
    got = cc.connected_components(torch.as_tensor(active),
                                  cc.Dist2Gate(torch.tensor(nb)),
                                  torch.as_tensor(xyz))
    assert cc_kernel.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    old = cc.connected_components_plain(torch.as_tensor(active),
                                        _lambda_gate(nb),
                                        torch.as_tensor(xyz))
    assert torch.equal(got, old)
    assert 5 < len(np.unique(got.numpy())) < active.sum()


def test_kernel_checks_raise_without_a_device():
    """What the kernel does not take raises before any launch: another
    callable gate, wrong dtypes and shapes, a threshold that is not a
    one-element float32 tensor or comes without XYZ values; well-formed
    CPU tensors find no kernel."""
    H, W = 6, 5
    act = torch.ones((H, W), dtype=torch.bool)
    xyz = torch.zeros((H, W, 3))
    parts = torch.zeros((H, W), dtype=torch.uint8)
    t = torch.tensor(0.1)
    with pytest.raises(ValueError, match="Dist2Gate"):
        cc._kernel_thresh(_lambda_gate(0.1))
    assert cc._kernel_thresh(cc.Dist2Gate(t)) is t
    assert cc._kernel_thresh(None) is None
    bad = [(act.to(torch.uint8), None, None),           # mask not bool
           (act[None], None, None),                     # not 2-D
           (act, parts.to(torch.int32), None),          # values' dtype
           (act, parts[:, :4], None),                   # values' shape
           (act, xyz[..., :2], t),                      # not XYZ
           (act, xyz.double(), t),                      # not float32
           (act, xyz, None),                            # XYZ, no threshold
           (act, parts, t),                             # threshold, uint8
           (act, None, t),                              # threshold alone
           (act, xyz, 0.1),                             # not a tensor
           (act, xyz, t.double()),                      # not float32
           (act, xyz, torch.zeros(2))]                  # two elements
    for args in bad:
        with pytest.raises(ValueError):
            cc_kernel.check(*args)
        with pytest.raises(ValueError):
            cc_kernel.label(*args)
    for args in ((act, None, None), (act, parts, None), (act, xyz, t)):
        cc_kernel.check(*args)
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            cc_kernel.label(*args)
