"""Host-side connected components through the native union-find, with a
Python fallback (counterpart of ``avatar_tpu/native/labeling.py``).

Labels equal ``perception.cc.connected_components``'s: the root of a
component is its smallest flat index, -1 marks inactive pixels.  The
fallback is a per-pixel Python loop: use it at small sizes only.
"""

from __future__ import annotations

import ctypes

import numpy as np

from avatar_tpu_torch.native import rle as _rle


def connected_components_host(active: np.ndarray,
                              values: np.ndarray | None = None) -> np.ndarray:
    """[H, W] bool (+ optional uint8 equality-gate values) -> int32 labels
    (-1 inactive; root = scan-order first pixel)."""
    H, W = active.shape
    if values is not None and values.shape != active.shape:
        raise ValueError(f"values {values.shape} != active {active.shape}")
    act = np.ascontiguousarray(active.astype(np.uint8))
    vals = (np.ascontiguousarray(values.astype(np.uint8))
            if values is not None else act)
    labels = np.empty((H, W), np.int32)
    lib = _rle._load_native()
    if lib:
        lib.cc_label(act.tobytes(), vals.tobytes(),
                     1 if values is not None else 0, H, W,
                     labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return labels
    parent = np.arange(H * W, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    flat_act = act.reshape(-1)
    flat_val = vals.reshape(-1)
    for y in range(H):
        for x in range(W):
            i = y * W + x
            if not flat_act[i]:
                continue
            for j in (i - 1 if x > 0 else -1, i - W if y > 0 else -1):
                if j >= 0 and flat_act[j] and (
                        values is None or flat_val[i] == flat_val[j]):
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        if ri < rj:
                            parent[rj] = ri
                        else:
                            parent[ri] = rj
    out = np.full(H * W, -1, np.int32)
    for i in range(H * W):
        if flat_act[i]:
            out[i] = find(i)
    return out.reshape(H, W)
