"""Part-constrained masked nearest-neighbour argmin: the hand-written CUDA
kernel (``csrc/nn_argmin.cu``) and its plain PyTorch version.

Counterpart of ``avatar_tpu/optim/nn_pallas.py``: ``nn_argmin_ranges``
replaces ``_kernel_ranges`` (B1, on every LM step of ``fit``) and
``nn_argmin`` replaces ``_kernel`` (B2), as the same kernel over the whole
model axis.  The kernel is built with nvcc at its first launch, into
``avatar_tpu_torch/_build/``, as a shared library with a plain C entry
point bound through ctypes.

The wrappers take the plain version only for tensors on the CPU.  For CUDA
tensors they launch the kernel or raise; there is no fallback.
``LAUNCHES`` counts kernel launches by wrapper, so a run can show that its
path went through each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "nn_argmin.cu"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v")
_ROWS = 64           # data rows per block (csrc/nn_argmin.cu kRows)
_MAX_CHUNK = 3072    # csrc/nn_argmin.cu kMaxChunk

_INF = 3.0e38
_BIG_PART = 2 ** 30
_INVALID = -2 ** 31

# kernel launches since the last reset, by the wrapper that launched them
LAUNCHES = {"nn_argmin_ranges": 0, "nn_argmin": 0}
_fn = None           # the bound C entry point, once built


def _nvcc() -> str:
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


def build() -> str:
    """Compile (once per source and flags) and bind the kernel.  Returns
    the compiler's output (ptxas register and shared-memory report), or ''
    when the library was already built."""
    global _fn
    if _fn is not None:
        return ""
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    lib_path = _BUILD / f"libnn_argmin_{tag}.so"
    log = ""
    if not lib_path.exists():
        _BUILD.mkdir(exist_ok=True)
        tmp = _BUILD / f"libnn_argmin_{tag}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
        log = proc.stdout + proc.stderr
    fn = ctypes.CDLL(str(lib_path)).avatar_nn_argmin_ranges
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
    return log


def _check(data_pts, data_part, model_pts, model_part, model_valid, cstart,
           cend, tile_n: int, chunk: int) -> None:
    dev = data_pts.device
    N, Pp = data_pts.shape[0], model_pts.shape[0]
    want = [("data_pts", data_pts, torch.float32, (N, 3)),
            ("data_part", data_part, torch.int32, (N,)),
            ("model_pts", model_pts, torch.float32, (Pp, 3)),
            ("model_part", model_part, torch.int32, (Pp,)),
            ("model_valid", model_valid, torch.bool, (Pp,)),
            ("cstart", cstart, torch.int32, (N // tile_n,)),
            ("cend", cend, torch.int32, (N // tile_n,))]
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, data_pts on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N == 0 or N % tile_n or tile_n % _ROWS:
        raise ValueError(f"N={N} must be a positive multiple of tile_n="
                         f"{tile_n}, itself a multiple of {_ROWS}")
    if not 0 < chunk <= _MAX_CHUNK or Pp == 0 or Pp % chunk:
        raise ValueError(f"Pp={Pp} must be a positive multiple of chunk="
                         f"{chunk} (at most {_MAX_CHUNK})")


def nn_argmin_ranges(data_pts, data_part, model_pts, model_part, model_valid,
                     cstart, cend, tile_n: int = 256, chunk: int = 512,
                     wild: int = -1000, _name: str = "nn_argmin_ranges"):
    """Part-sorted masked NN: (best_d [N] f32, best_i [N] i32).

    data_pts [N,3] f32 / data_part [N] i32 sorted by part (< 0 = padding),
    model_pts [Pp,3] / model_part [Pp] i32 sorted by part (pad slots
    2^30), model_valid [Pp] bool; cstart/cend [N/tile_n] i32 give the model
    chunk range of each data tile.  Rows labelled ``wild`` match any real
    part.
    """
    if data_pts.device.type == "cpu":
        return nn_argmin_ranges_ref(data_pts, data_part, model_pts,
                                    model_part, model_valid, cstart, cend,
                                    tile_n, chunk, wild)
    if data_pts.device.type != "cuda":
        raise ValueError(f"no kernel for device {data_pts.device}")
    _check(data_pts, data_part, model_pts, model_part, model_valid, cstart,
           cend, tile_n, chunk)
    build()
    N, Pp = data_pts.shape[0], model_pts.shape[0]
    best_d = torch.empty(N, dtype=torch.float32, device=data_pts.device)
    best_i = torch.empty(N, dtype=torch.int32, device=data_pts.device)
    with torch.cuda.device(data_pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn(data_pts.data_ptr(), data_part.data_ptr(),
                 model_pts.data_ptr(), model_part.data_ptr(),
                 model_valid.data_ptr(), cstart.data_ptr(), cend.data_ptr(),
                 best_d.data_ptr(), best_i.data_ptr(), N, Pp, tile_n, chunk,
                 wild, stream)
    if rc != 0:
        raise RuntimeError(f"nn_argmin_ranges launch failed: CUDA error {rc}")
    LAUNCHES[_name] += 1
    return best_d, best_i


def _full_range(N: int, Pp: int, tile_n: int, chunk: int, device):
    T = N // tile_n
    return (torch.zeros(T, dtype=torch.int32, device=device),
            torch.full((T,), Pp // chunk, dtype=torch.int32, device=device))


def nn_argmin(data_pts, data_part, model_pts, model_part, model_valid,
              tile_n: int = 256, chunk: int = 1024, wild: int = -1000):
    """Masked NN over the whole model axis (the reference's B2 kernel):
    ``nn_argmin_ranges`` with every tile scanning every chunk."""
    cstart, cend = _full_range(data_pts.shape[0], model_pts.shape[0],
                               tile_n, chunk, data_pts.device)
    return nn_argmin_ranges(data_pts, data_part, model_pts, model_part,
                            model_valid, cstart, cend, tile_n, chunk, wild,
                            _name="nn_argmin")


def nn_argmin_ranges_ref(data_pts, data_part, model_pts, model_part,
                         model_valid, cstart, cend, tile_n: int = 256,
                         chunk: int = 512, wild: int = -1000,
                         rows: int = 2048):
    """Plain PyTorch version of the kernel: the same candidates, the same
    d2 rounding ((dx*dx + dy*dy) + dz*dz, one rounding per op) and the same
    tie rule (``torch.argmin`` returns the first index of the minimum)."""
    N, Pp = data_pts.shape[0], model_pts.shape[0]
    dev = data_pts.device
    col_chunk = torch.arange(Pp, device=dev) // chunk
    tile = torch.arange(N, device=dev) // tile_n
    lo, hi = cstart.long()[tile], cend.long()[tile]
    key = torch.where(model_valid, model_part.to(torch.int32),
                      torch.full_like(model_part, _INVALID, dtype=torch.int32))
    real = (key != _INVALID)[None]
    mx, my, mz = (model_pts[None, :, k] for k in range(3))
    best_d = torch.empty(N, dtype=torch.float32, device=dev)
    best_i = torch.empty(N, dtype=torch.int32, device=dev)
    for r0 in range(0, N, rows):
        sl = slice(r0, r0 + rows)
        d = data_pts[sl]
        dx = d[:, 0:1] - mx
        dy = d[:, 1:2] - my
        dz = d[:, 2:3] - mz
        d2 = dx * dx + dy * dy + dz * dz
        part = data_part[sl, None]
        ok = real & ((key[None] == part) |
                     ((part == wild) & (key[None] < _BIG_PART)))
        ok &= (col_chunk[None] >= lo[sl, None]) & (col_chunk[None] < hi[sl, None])
        d2 = torch.where(ok, d2, torch.full_like(d2, _INF))
        i = torch.argmin(d2, dim=1)
        md = torch.gather(d2, 1, i[:, None])[:, 0]
        best_d[sl] = md
        best_i[sl] = torch.where(md < _INF, i, -1).to(torch.int32)
    return best_d, best_i


def nn_argmin_ref(data_pts, data_part, model_pts, model_part, model_valid,
                  tile_n: int = 256, chunk: int = 1024, wild: int = -1000):
    """Plain PyTorch version of ``nn_argmin``."""
    cstart, cend = _full_range(data_pts.shape[0], model_pts.shape[0],
                               tile_n, chunk, data_pts.device)
    return nn_argmin_ranges_ref(data_pts, data_part, model_pts, model_part,
                                model_valid, cstart, cend, tile_n, chunk,
                                wild)
