"""The repository's ``conftest.py`` caps torch's CPU threads in an xdist
worker at the worker's share of the cores, and leaves a run without xdist
alone."""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib.util, os, sys, torch
spec = importlib.util.spec_from_file_location("root_conftest", sys.argv[1])
conftest = importlib.util.module_from_spec(spec)
spec.loader.exec_module(conftest)
os.environ.pop("PYTEST_XDIST_WORKER_COUNT", None)
before = torch.get_num_threads()
conftest.pytest_configure(None)
alone = torch.get_num_threads()
os.environ["PYTEST_XDIST_WORKER_COUNT"] = sys.argv[2]
conftest.pytest_configure(None)
print(before, alone, torch.get_num_threads())
"""


def test_xdist_workers_share_the_cores():
    cores = len(os.sched_getaffinity(0))
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:                 # this very worker
        assert torch.get_num_threads() <= max(1, cores // int(workers))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(ROOT, "conftest.py"),
         "6"], capture_output=True, text=True, timeout=120, check=True)
    before, alone, capped = map(int, out.stdout.split())
    assert alone == before
    assert capped == max(1, cores // 6)
