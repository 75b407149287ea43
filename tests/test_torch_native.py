"""Parity of the port's native host helpers (``avatar_tpu_torch/native``)
with the reference's (``avatar_tpu/native``): the ``.depth`` codec and the
union-find labeler, each through the C++ library the port builds into
``avatar_tpu_torch/_build/`` and through its numpy / Python fallback.

Everything here is integer or byte output, so it is held equal: stream
bytes, decoded floats (copied, never computed), labels.  The reference
runs its own numpy / Python paths (its library switched off)."""

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from avatar_tpu.native import labeling as jlabeling
from avatar_tpu.native import rle as jrle
from avatar_tpu_torch.io import formats as tformats
from avatar_tpu_torch.native import build as tbuild
from avatar_tpu_torch.native import labeling as tlabeling
from avatar_tpu_torch.native import rle as trle
from avatar_tpu_torch.perception import cc as tcc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built here")
    return tbuild.build(verbose=False)


@pytest.fixture(params=["native", "numpy"])
def path(request, built, monkeypatch):
    """Run the port through its library or its fallback; the reference
    through its fallback."""
    monkeypatch.setattr(jrle, "_LIB", False)
    if request.param == "numpy":
        monkeypatch.setattr(trle, "_LIB", False)
    else:
        monkeypatch.setattr(trle, "_LIB", None)
        assert trle._load_native()
    return request.param


def _depth_maps(seed):
    """Depth maps with zero runs: one that crosses a row boundary, a
    trailing run, a leading run, an all-zero and an all-nonzero map."""
    rng = np.random.default_rng(seed)
    d = np.zeros((24, 40), np.float32)
    m = rng.random(d.shape) < 0.45
    d[m] = (rng.random(m.sum()) * 4 + 0.2).astype(np.float32)
    d[3, 30:] = 0.0
    d[4, :12] = 0.0            # a run across the row 3 / row 4 boundary
    d[0, :5] = 0.0             # a leading run
    d[-2:, :] = 0.0            # a trailing run (never written)
    full = (rng.random((7, 9)) + 0.5).astype(np.float32)
    return [d, np.zeros((5, 6), np.float32), full]


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_matches_reference(path, seed):
    for d in _depth_maps(seed):
        data = trle.encode(d)
        assert data == jrle.encode(d)
        np.testing.assert_array_equal(trle.decode(data), d)
        np.testing.assert_array_equal(trle.decode(data), jrle.decode(data))
    assert len(trle.encode(np.zeros((3, 4), np.float32))) == 4
    with pytest.raises(ValueError):
        trle.decode(b"\x01\x00")


def test_formats_dispatch_through_native_rle(path, tmp_path, monkeypatch):
    """``formats.read_depth_rle`` / ``write_depth_rle`` go through
    ``native.rle``, as the reference's do."""
    calls = []
    for name in ("decode", "encode"):
        real = getattr(trle, name)
        monkeypatch.setattr(trle, name, lambda x, real=real, name=name: (
            calls.append(name), real(x))[1])
    d = _depth_maps(3)[0]
    p = str(tmp_path / "f.depth")
    tformats.write_depth_rle(p, d)
    np.testing.assert_array_equal(tformats.read_depth_rle(p), d)
    ref = os.path.join(ROOT, "tests", "fixtures", "ref_frame.depth")
    np.testing.assert_array_equal(tformats.read_depth_rle(ref),
                                  jrle.decode(open(ref, "rb").read()))
    assert calls == ["encode", "decode", "decode"]


@pytest.mark.parametrize("with_values", [False, True])
def test_connected_components_host_matches_reference(path, with_values):
    """Labels equal the reference's host labeler and the port's device
    labeler (``perception.cc``) on the CPU."""
    rng = np.random.default_rng(5)
    H, W = 24, 32
    act = rng.random((H, W)) < 0.55
    vals = (rng.integers(0, 3, (H, W)).astype(np.uint8) if with_values
            else None)
    got = tlabeling.connected_components_host(act, vals)
    np.testing.assert_array_equal(
        got, jlabeling.connected_components_host(act, vals))
    dev = tcc.connected_components(
        torch.as_tensor(act),
        values=None if vals is None else torch.as_tensor(vals),
        max_iters=256)
    np.testing.assert_array_equal(got, dev.numpy())
    with pytest.raises(ValueError):
        tlabeling.connected_components_host(act, np.zeros((2, 2), np.uint8))


def test_library_builds_into_build_dir(built):
    """The library goes to ``avatar_tpu_torch/_build/`` under a name keyed
    on the source and flags, a second build is a no-op, and the
    reference's library is never what the port loads."""
    lib = tbuild.library_path()
    assert built == str(lib) and os.path.exists(built)
    assert lib.parent == tbuild._BUILD
    assert lib.parent.name == "_build" and lib.parent.parent.name == \
        "avatar_tpu_torch"
    mtime = os.path.getmtime(built)
    assert tbuild.build(verbose=False) == built
    assert os.path.getmtime(built) == mtime
    assert trle._load_native()._name == built


def test_batch_decode(built, monkeypatch):
    """The library's threaded batch decoder (``depth_batch_decode``)."""
    monkeypatch.setattr(trle, "_LIB", None)
    lib = trle._load_native()
    rng = np.random.default_rng(2)
    imgs, bufs = [], []
    for _ in range(5):
        d = np.zeros((16, 20), np.float32)
        m = rng.random((16, 20)) < 0.3
        d[m] = (rng.random(m.sum()) + 0.1).astype(np.float32)
        imgs.append(d)
        bufs.append(trle.encode(d))
    offsets = np.zeros(6, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in bufs])
    out = np.zeros((5, 16 * 20), np.float32)
    lib.depth_batch_decode(
        b"".join(bufs),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), 5,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 16 * 20, 4)
    for k in range(5):
        np.testing.assert_array_equal(out[k].reshape(16, 20), imgs[k])
