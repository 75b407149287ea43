"""Helpers that the per-layer metrics' readers (``metrics/<name>.py``)
share."""

from __future__ import annotations

from typing import Optional


def stage_ms(run, kind: str, path: str) -> Optional[float]:
    """Mean elapsed ms of scope ``path`` (the stage clock's, relative to
    the frame) over the window's frames of ``kind``; None without such a
    frame or scope."""
    vals = [f["stages"][path]["elapsed_ms"] for f in run.frames
            if f["kind"] == kind and path in f.get("stages", {})]
    return sum(vals) / len(vals) if vals else None
