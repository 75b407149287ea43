"""The benchmark's tests: the harness on the CPU at a tiny size, and the
control on the card (``-m cuda``).  Run from the root of the checkout:

    python -m pytest benchmark/tests -q
"""

import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture
def bench_copy(tmp_path):
    """A benchmark directory in ``tmp_path``: the metrics' readers and the
    CPU-sized cells of ``tests/data``."""
    shutil.copytree(BENCH / "metrics", tmp_path / "metrics")
    for d in ("configs", "traffic", "limits"):
        shutil.copytree(BENCH / "tests" / "data" / d, tmp_path / d)
    shutil.copy(BENCH / "tests" / "data" / "BENCHMARK.json",
                tmp_path / "BENCHMARK.json")
    return tmp_path


@pytest.fixture
def card():
    """The CUDA device; the card tests skip without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
