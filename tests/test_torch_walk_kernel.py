"""On the card: the forest walk's hand-written CUDA kernel
(``perception/walk_kernel.py``, ``csrc/forest_walk.cu``) against its plain
PyTorch version (``rtree.walk_pixels_plain``), leaf ids equal to the bit:
the bench's stacked 3-tree forest at the fused tracker's shapes (the
3,072-pixel bucket of a 192x149 window, trees [1, 3) over 1,024 hard
pixels), the demo forest over the host tracker's 640x360 grid, and edge
cases (probes outside the ROI, zero-depth probes, background pixels, K = 1
and K off the block size).  Imports no JAX; on a machine without a CUDA
device every test skips.  On the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_walk_kernel.py
"""

import numpy as np
import pytest
import torch

from avatar_tpu_torch import profiling
from avatar_tpu_torch.perception import rtree, walk_kernel
from avatar_tpu_torch.perception.rtree import RTree
from avatar_tpu_torch.tracking_fused import _stack_trees

FORESTS = [f"data/bench_forest_r5{s}.srtr" for s in ("", "_1", "_2")]
FRAMES = "tests/fixtures/torch_port_720p.npz"
STRIDE = 3                      # the fused tracker's forest stride
WINDOW = (192, 149)             # its tracked window at that stride


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def forest(cuda):
    trees = [RTree(p, device=cuda) for p in FORESTS]
    stacked = _stack_trees([t._tree for t in trees], STRIDE)
    return trees, stacked, max(t._max_depth for t in trees)


@pytest.fixture(scope="module")
def depth(cuda):
    """A tracked frame of the 720p fixture in meters, the wall at 4 m
    removed as background subtraction leaves it (zero depth)."""
    d = np.load(FRAMES)["depth"][1].astype(np.float32) * 1e-3
    return torch.as_tensor(np.where(d < 3.9, d, 0.0).astype(np.float32),
                           device=cuda)


def _walks(tree, ys, xs, z, fg, probe, shape, max_depth, tl, br,
           trees=None):
    """The kernel's and the plain version's leaf ids of one walk."""
    before = walk_kernel.LAUNCHES
    got = rtree.walk_pixels(tree, ys, xs, z, fg, probe, shape, max_depth,
                            tl, br, trees)
    assert walk_kernel.LAUNCHES == before + 1
    ref = rtree.walk_pixels_plain(tree, ys, xs, z, fg, probe, shape,
                                  max_depth, tl, br, trees)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == ref.shape
    return got, ref


def _window(depth):
    """The fused tracker's probe slab: the strided frame's window around
    the body, flattened, and its shape."""
    d_s = depth[::STRIDE, ::STRIDE]
    wh, ww = WINDOW
    ys, xs = torch.nonzero(d_s > 0, as_tuple=True)
    oy = min(max(int(ys.float().mean()) - wh // 2, 0), d_s.shape[0] - wh)
    ox = min(max(int(xs.float().mean()) - ww // 2, 0), d_s.shape[1] - ww)
    region = d_s[oy:oy + wh, ox:ox + ww]
    return region.reshape(-1).contiguous(), (wh, ww)


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_fused_shapes(cuda, forest, depth):
    """Tree 0 over the 3,072-pixel bucket of the window (foreground first,
    as the fused tracker compacts it), then trees [1, 3) over 1,024 of its
    pixels in one launch: leaf ids equal to the plain walk's."""
    _, stacked, max_depth = forest
    rflat, (wh, ww) = _window(depth)
    rfg = rflat > 0
    g = torch.Generator(device=cuda).manual_seed(5)
    tie = torch.rand(rflat.shape[0], device=cuda, generator=g)
    sel = torch.argsort(-(rfg.float() * 2.0 + tie), stable=True)[:3072]
    ys, xs, z, fg = sel // ww, sel % ww, rflat[sel], rfg[sel]
    assert 500 < int(fg.sum()) < 3072
    roi = ((0, 0), (ww - 1, wh - 1))
    got, ref = _walks(stacked, ys, xs, z, fg, rflat, (wh, ww), max_depth,
                      *roi, trees=(0, 1))
    assert got.shape == (1, 3072)
    assert torch.equal(got, ref)
    assert torch.equal(got[0] >= 0, fg)
    hard = torch.randperm(3072, device=cuda, generator=g)[:1024]
    got, ref = _walks(stacked, ys[hard], xs[hard], z[hard], fg[hard], rflat,
                      (wh, ww), max_depth, *roi, trees=(1, 3))
    assert got.shape == (2, 1024)
    assert torch.equal(got, ref)
    # one launch over a tree range equals a launch per tree
    for t in (1, 2):
        one = rtree.walk_pixels(stacked, ys[hard], xs[hard], z[hard],
                                fg[hard], rflat, (wh, ww), max_depth, *roi,
                                trees=(t, t + 1))
        assert torch.equal(one[0], got[t - 1])


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_host_grid(cuda, forest, depth):
    """The demo forest over the host tracker's grid (1280x720 at stride 2:
    640x360 pixels) inside a body ROI, through ``forest_walk`` as
    ``predict_best`` calls it."""
    trees, _, _ = forest
    tree = trees[0]
    ys, xs = torch.nonzero(depth > 0, as_tuple=True)
    tl = (int(xs.min()) - 40, int(ys.min()) - 40)
    br = (int(xs.max()) + 40, int(ys.max()) + 40)
    before = walk_kernel.LAUNCHES
    got = rtree.forest_walk(tree._tree, depth, tree._max_depth, 2, tl, br)
    assert walk_kernel.LAUNCHES == before + 1
    assert got.shape == (360, 640)
    H, W = depth.shape
    gy = (torch.arange(360, device=cuda) * 2)[:, None].expand(360, 640)
    gx = (torch.arange(640, device=cuda) * 2)[None, :].expand(360, 640)
    z = depth[::2, ::2].contiguous()
    fg = (z > 0) & (gx >= tl[0]) & (gx <= br[0]) & (gy >= tl[1]) & \
        (gy <= br[1])
    ref = rtree.walk_pixels_plain(tree._tree, gy, gx, z, fg,
                                  depth.reshape(-1), (H, W), tree._max_depth,
                                  tl, br)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert int((got >= 0).sum()) == int(fg.sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 129, 1000])
def test_kernel_matches_plain_at_the_edges(cuda, forest, k):
    """A small probe image with holes, an ROI narrower than the image (so
    probes fall outside it), pixels off the foreground and near the border,
    K = 1 and K off the block size; one tree and a tree range."""
    trees, stacked, max_depth = forest
    rng = np.random.default_rng(k)
    Hp, Wp = 48, 64
    img = rng.uniform(1.0, 3.0, (Hp, Wp)).astype(np.float32)
    img[rng.random((Hp, Wp)) < 0.3] = 0.0                # zero-depth probes
    probe = torch.as_tensor(img.reshape(-1), device=cuda)
    ys = torch.as_tensor(rng.integers(0, Hp, k), device=cuda)
    xs = torch.as_tensor(rng.integers(0, Wp, k), device=cuda)
    # near depths make long offsets, so many probes leave the ROI
    z = torch.as_tensor(rng.uniform(0.3, 3.0, k).astype(np.float32),
                        device=cuda)
    fg = torch.as_tensor(rng.random(k) < 0.8, device=cuda)
    if k == 1:
        fg[0] = True
    tl, br = (6, 4), (50, 40)
    got, ref = _walks(trees[1]._tree, ys, xs, z, fg, probe, (Hp, Wp),
                      trees[1]._max_depth, tl, br)
    assert got.shape == (k,) and torch.equal(got, ref)
    assert torch.equal(got >= 0, fg)
    got, ref = _walks(stacked, ys, xs, z, fg, probe, (Hp, Wp), max_depth,
                      tl, br, trees=(0, 3))
    assert got.shape == (3, k) and torch.equal(got, ref)
    assert bool((got[:, ~fg] == -1).all())


@pytest.mark.cuda
def test_each_launch_counts_in_the_open_scope(cuda, forest):
    """``walk_launches`` counts each launch in the stage clock's open
    scope."""
    trees, stacked, max_depth = forest
    probe = torch.full((16 * 16,), 2.0, device=cuda)
    ys = torch.arange(16, device=cuda)
    z = torch.full((16,), 2.0, device=cuda)
    fg = torch.ones(16, dtype=torch.bool, device=cuda)
    with profiling.stage_clock(cuda) as clock:
        with profiling.scope("forest_walk"):
            rtree.walk_pixels(stacked, ys, ys, z, fg, probe, (16, 16),
                              max_depth, (0, 0), (15, 15), trees=(0, 1))
            rtree.walk_pixels(stacked, ys, ys, z, fg, probe, (16, 16),
                              max_depth, (0, 0), (15, 15), trees=(1, 3))
    assert clock.stages["forest_walk"]["counts"]["walk_launches"] == 2


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, forest):
    trees, stacked, max_depth = forest
    tree = trees[0]._tree
    img = torch.full((32, 32), 2.0, device=cuda)
    ys = torch.arange(8, device=cuda)
    z = torch.full((8,), 2.0, device=cuda)
    fg = torch.ones(8, dtype=torch.bool, device=cuda)
    ok = (ys, ys, z, fg, img.reshape(-1), (32, 32), 10, (0, 0), (31, 31))
    rtree.walk_pixels(tree, *ok)
    bad = [
        (ys, ys, z.double(), fg),                 # float64 depths
        (ys, ys, torch.full((8,), 2, device=cuda), fg),   # int64 depths
        (ys.int(), ys, z, fg),                    # int32 coordinates
        (ys, ys, z, fg.float()),                  # a float mask
        (ys, ys[:4], z, fg),                      # shapes that differ
    ]
    for a in bad:
        with pytest.raises(ValueError):
            rtree.walk_pixels(tree, *a, *ok[4:])
    with pytest.raises(ValueError):               # not contiguous
        rtree.walk_pixels(tree, *ok[:4],
                          torch.full((2048,), 2.0, device=cuda)[::2],
                          *ok[5:])
    with pytest.raises(ValueError):               # the wrong size
        rtree.walk_pixels(tree, *ok[:4], img.reshape(-1)[:1000], *ok[5:])
    with pytest.raises(ValueError):               # the tree on the host
        rtree.walk_pixels(rtree.TreeTensors(*(a.cpu() for a in tree)), *ok)
    with pytest.raises(ValueError):               # a range of one tree
        rtree.walk_pixels(tree, *ok, trees=(0, 1))
    with pytest.raises(ValueError):               # a stacked forest whole
        rtree.walk_pixels(stacked, *ok)
    with pytest.raises(ValueError):               # past its last tree
        rtree.walk_pixels(stacked, *ok, trees=(2, 4))
