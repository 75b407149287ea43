"""Zero-run-length ``.depth`` codec (counterpart of
``avatar_tpu/native/rle.py``; reference Util.cpp:176-247).

Stream layout: uint16 rows, uint16 cols, then float32 values row-major
where a negative value -n stands for a run of n zeros (runs may span row
boundaries) and non-negative values are literal depths.  A trailing zero
run is never written (the decoder zero-fills).

Dispatches to the C++ library when ``native.build`` has built it; the
numpy implementation below is the reference's and the fallback.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

_LIB = None     # the bound library, False when it is not built


def _load_native():
    """The bound library, or False when it has not been built."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from avatar_tpu_torch.native.build import library_path

    path = library_path()
    if not path.exists():
        _LIB = False
    else:
        lib = ctypes.CDLL(str(path))
        i64, ptr = ctypes.c_longlong, ctypes.c_void_p
        lib.rle_decode.restype = i64
        lib.rle_decode.argtypes = [ctypes.c_char_p, i64,
                                   ctypes.POINTER(ctypes.c_float), i64]
        lib.rle_encode.restype = i64
        lib.rle_encode.argtypes = [ctypes.POINTER(ctypes.c_float), i64, ptr,
                                   i64]
        lib.cc_label.restype = ctypes.c_int
        lib.cc_label.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int32)]
        lib.depth_batch_decode.restype = None
        lib.depth_batch_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), i64, ctypes.c_int]
        _LIB = lib
    return _LIB


def decode(data: bytes) -> np.ndarray:
    """Decode a ``.depth`` byte stream -> float32 [H, W]."""
    if len(data) < 4:
        raise ValueError("truncated .depth stream")
    rows, cols = struct.unpack_from("<HH", data, 0)
    n = rows * cols
    lib = _load_native()
    if lib:
        out = np.zeros(n, dtype=np.float32)
        if lib.rle_decode(data, len(data), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), n) < 0:
            raise ValueError("corrupt .depth stream")
        return out.reshape(rows, cols)
    vals = np.frombuffer(data, dtype="<f4", offset=4)
    neg = vals < 0
    lengths = np.where(neg, (-vals).astype(np.int64), 1)
    pieces = np.where(neg, np.float32(0), vals)
    out_flat = np.repeat(pieces, lengths)
    out = np.zeros(n, dtype=np.float32)
    m = min(n, out_flat.shape[0])
    out[:m] = out_flat[:m]
    return out.reshape(rows, cols)


def encode(depth: np.ndarray) -> bytes:
    """Encode float32 [H, W] -> ``.depth`` byte stream."""
    depth = np.ascontiguousarray(depth, dtype=np.float32)
    rows, cols = depth.shape
    header = struct.pack("<HH", rows, cols)
    flat = depth.reshape(-1)
    lib = _load_native()
    if lib:
        # worst case: every element a literal
        buf = np.zeros(flat.shape[0] + 1, dtype=np.float32)
        wrote = lib.rle_encode(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            flat.shape[0], buf.ctypes.data, buf.nbytes)
        if wrote < 0:
            raise RuntimeError("rle_encode overflowed its buffer")
        return header + buf[:wrote].tobytes()
    # the gap of zeros before each nonzero value becomes a -gap marker
    nz = np.nonzero(flat)[0]
    if nz.shape[0] == 0:
        return header    # all zeros: empty stream (the decoder zero-fills)
    gaps = np.diff(np.concatenate([[-1], nz])) - 1
    has_gap = gaps > 0
    stream = np.empty(nz.shape[0] + int(has_gap.sum()), dtype=np.float32)
    pos = np.cumsum(has_gap.astype(np.int64)) + np.arange(nz.shape[0])
    stream[pos] = flat[nz]
    stream[pos[has_gap] - 1] = -gaps[has_gap].astype(np.float32)
    return header + stream.tobytes()
