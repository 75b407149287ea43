"""The one loader of the port's hand-written CUDA kernels
(``build_cache.CudaLibrary``), on the CPU: where each kernel's library is
built and what a failed launch raises.  Building and launching a kernel
needs the card (``tests/test_torch_cuda.py``,
``tests/test_torch_walk_kernel.py``, ``tests/test_torch_cc_kernel.py``)."""

import hashlib
from pathlib import Path

import pytest
import torch

from avatar_tpu_torch import build_cache
from avatar_tpu_torch.optim import nn_kernel
from avatar_tpu_torch.perception import cc_kernel, walk_kernel


@pytest.mark.parametrize("module, source, stem", [
    (nn_kernel, "nn_argmin.cu", "libnn_argmin"),
    (walk_kernel, "forest_walk.cu", "libforest_walk"),
    (cc_kernel, "cc_label.cu", "libcc_label"),
], ids=["nn", "walk", "cc"])
def test_library_goes_under_the_build_directory(module, source, stem,
                                                tmp_path, monkeypatch):
    """One assignment to ``build_cache.BUILD`` moves every kernel's
    library, and its name is the one its source and flags have always
    had: ``<stem>_<first 16 hex of sha256(source + flags)>.so``."""
    monkeypatch.setattr(build_cache, "BUILD", tmp_path)
    src = Path(build_cache.__file__).parent / "csrc" / source
    tag = hashlib.sha256(src.read_bytes() + " ".join(
        build_cache.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert module.LIBRARY.src == src
    assert module.LIBRARY.path() == tmp_path / f"{stem}_{tag}.so"


def test_a_failed_launch_raises_naming_its_entry(monkeypatch):
    """``launch`` passes the arguments and the device's current stream,
    returns on 0 and raises naming the entry and the error otherwise."""
    calls, codes = [], [0, 700]

    class Bound:
        @staticmethod
        def avatar_cc_label(*args):
            calls.append(args)
            return codes.pop(0)

    lib = build_cache.CudaLibrary("cc_label.cu", "libcc_label",
                                  {"avatar_cc_label": []})
    lib._lib = Bound()
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(build_cache, "current_stream", lambda index: 1234)
    dev = torch.device("cuda", 0)
    lib.launch("avatar_cc_label", dev, 1, 2)
    with pytest.raises(RuntimeError, match="avatar_cc_label launch failed: "
                       "CUDA error 700"):
        lib.launch("avatar_cc_label", dev, 3, 4)
    assert calls == [(1, 2, 1234), (3, 4, 1234)]
