"""Shared libraries that the port compiles at run time, cached on disk.

A library goes to ``avatar_tpu_torch/_build/`` (or another directory)
under a name keyed on a hash of its source and its compiler flags, so a
changed source is rebuilt.  Processes that build at the same moment (test
workers) each compile to their own temporary file and move it into place.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Sequence

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
