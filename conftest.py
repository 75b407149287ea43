"""Test set-up for every test directory: torch's CPU threads under xdist.

torch runs a CPU operation on as many threads as the process may use
cores, and its idle threads spin before they sleep.  Under
``pytest -n N`` each of the N xdist workers would do so on every core, N
times as many busy threads as cores, and the workers slow one another
down far more than their work explains.  In an xdist worker torch's
intra-op threads are capped at the worker's share of the cores.  A run
without xdist is left alone: one process keeps every core.  Nothing of
JAX or XLA is set here.
"""

import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch

        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // int(workers)))
