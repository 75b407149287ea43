"""Data-dir discovery, the visualization palette and stage profiling
(counterparts of ``resolve_root_path``, ``palette_color`` /
``palette_color_table`` and ``StageTimer`` in ``avatar_tpu/utils.py``)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve_root_path(rel_path: str) -> str:
    """Locate a data file or directory: under the root that the
    AVATAR_TPU_DIR / OPENARK_DIR / SMPLSYNTH_DIR variables name, where that
    root holds ``data/avatar-model``, else under the repository root that
    holds this package.  Unlike the reference (Util.cpp:64-109), it never
    walks the working directory's parents, so a lookup without a variable
    stays inside the checkout."""
    test_rel = "data/avatar-model"
    for env in ("AVATAR_TPU_DIR", "OPENARK_DIR", "SMPLSYNTH_DIR"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, test_rel)):
            return os.path.join(root, rel_path)
    return os.path.join(_REPO_ROOT, rel_path)


# 17-color visualization palette, RGB (reference Util.cpp:110-123 stores BGR;
# these are the same colors).
_PALETTE = np.array([
    [255, 220, 0], [201, 13, 177], [34, 255, 94], [255, 65, 54],
    [255, 255, 64], [0, 116, 217], [255, 133, 27], [240, 18, 190],
    [210, 31, 20], [133, 20, 75], [127, 219, 255], [57, 204, 204],
    [61, 153, 112], [46, 204, 64], [1, 255, 112], [170, 170, 170],
    [42, 30, 225],
], dtype=np.uint8)


def palette_color(idx: int, bgr: bool = False) -> np.ndarray:
    c = _PALETTE[idx % len(_PALETTE)]
    return c[::-1] if bgr else c


def palette_color_table(num_colors: int, bgr: bool = False) -> np.ndarray:
    """[num_colors, 3] float table in [0, 1] (reference Util.cpp:125-135)."""
    return np.stack([palette_color(i, bgr) for i in range(num_colors)]) / 255.0


class StageTimer:
    """Per-stage wall-clock profiler.  Accumulates times per named stage;
    stages nest freely.  Host clock: a stage that must include device work
    ends in a synchronising read (the tracker's diagnostics copy does)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stats: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            self.stats.setdefault(name, []).append(dt)

    def report(self) -> str:
        lines = []
        for name, times in self.stats.items():
            arr = np.asarray(times)
            lines.append(
                f"{name}: mean {arr.mean():.3f} ms  min {arr.min():.3f} ms  "
                f"({1e3 / max(arr.mean(), 1e-9):.1f} fps)  n={len(arr)}"
            )
        return "\n".join(lines)
