"""Shared libraries that the port compiles at run time, cached on disk.

A library goes to ``avatar_tpu_torch/_build/`` (or another directory)
under a name keyed on a hash of its source and its compiler flags, so a
changed source is rebuilt.  Processes that build at the same moment (test
workers) each compile to their own temporary file and move it into place.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Sequence

BUILD = Path(__file__).resolve().parent / "_build"


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
