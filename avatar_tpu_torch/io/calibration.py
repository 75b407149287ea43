"""Camera intrinsics (the fields of ``avatar_tpu/io/calibration.py::
CameraIntrin`` that the tracker reads; file I/O is not ported yet)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CameraIntrin:
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
