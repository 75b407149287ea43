"""Stage profiling (counterpart of ``avatar_tpu/utils.py::StageTimer``)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np


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
