"""Shared libraries that the port compiles at run time, cached on disk.

A library goes to ``avatar_tpu_torch/_build/`` (or another directory)
under a name keyed on a hash of its source and its compiler flags, so a
changed source is rebuilt.  Processes that build at the same moment (test
workers) each compile to their own temporary file and move it into place.
``CudaLibrary`` is the one loader of the hand-written CUDA kernels: their
build, their ctypes binding and their launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Mapping, Optional, Sequence

import torch

from avatar_tpu_torch.device import current_stream

BUILD = Path(__file__).resolve().parent / "_build"
# the hand-written CUDA kernels' flags: Hopper's sm_90a, no fused
# multiply-add (each kernel's arithmetic is its plain version's to the bit),
# a shared library with plain C entry points; ptxas reports registers
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the one on ``PATH``, or
    the one under PyTorch's CUDA home."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def cached_path(src: Path, flags: Sequence[str], stem: str,
                build_dir: Path = BUILD) -> Path:
    """Where the library of ``src`` built with ``flags`` goes."""
    tag = hashlib.sha256(Path(src).read_bytes() + " ".join(flags).encode()
                         ).hexdigest()[:16]
    return Path(build_dir) / f"{stem}_{tag}.so"


def build_cached(src: Path, flags: Sequence[str], stem: str,
                 command: Callable[[Path], list],
                 build_dir: Path = BUILD) -> tuple[Path, str]:
    """Compile ``src`` unless its library is there.  ``command(out)`` is
    the compiler command that writes the library to ``out``.  Returns the
    library's path and the compiler's output ('' when it was there)."""
    out = cached_path(src, flags, stem, build_dir)
    if out.exists():
        return out, ""
    out.parent.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


class CudaLibrary:
    """A hand-written CUDA kernel's shared library: ``csrc/<source>``
    built with ``NVCC_FLAGS`` at its first use into ``BUILD`` (read then,
    so one assignment to ``build_cache.BUILD`` redirects every kernel) as
    ``<stem>_<hash>.so``, its C entry points bound through ctypes with the
    argument types of ``entries``.  An entry returns a CUDA error code (an
    int) unless ``returns`` names its type."""

    def __init__(self, source: str, stem: str,
                 entries: Mapping[str, Sequence],
                 returns: Optional[Mapping[str, type]] = None):
        self.src = Path(__file__).resolve().parent / "csrc" / source
        self.stem = stem
        self.entries = dict(entries)
        self.returns = dict(returns or {})
        self._lib = None

    def path(self) -> Path:
        """Where the library of the current source and flags goes."""
        return cached_path(self.src, NVCC_FLAGS, self.stem, BUILD)

    def build(self) -> str:
        """Compile (once per source and flags) and bind the library.
        Returns the compiler's output (ptxas's register and shared-memory
        report), or '' when the library was already built."""
        if self._lib is not None:
            return ""
        out, log = build_cached(
            self.src, NVCC_FLAGS, self.stem,
            lambda tmp: [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.src)],
            BUILD)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in self.entries.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = self.returns.get(name, ctypes.c_int)
        self._lib = lib
        return log

    def entry(self, name: str):
        """The bound C function ``name``, the library built first."""
        if self._lib is None:
            self.build()
        return getattr(self._lib, name)

    def call(self, name: str, index: int, *args) -> None:
        """``name(*args)`` with CUDA device ``index`` current; raises on a
        nonzero return."""
        fn = self.entry(name)
        if index == torch.cuda.current_device():
            rc = fn(*args)
        else:
            with torch.cuda.device(index):
                rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    def launch(self, name: str, device: torch.device, *args) -> None:
        """``name(*args, stream)`` on the current stream of ``device``;
        raises on a nonzero return."""
        index, stream = stream_of(device)
        self.call(name, index, *args, stream)


def stream_of(device: torch.device) -> tuple[int, int]:
    """(index, raw handle of its current stream) of CUDA ``device``."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return index, current_stream(index)
