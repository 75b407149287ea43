"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``), the
readers of its per-layer metrics (``metrics/<name>.py``) and the generator
of a configuration's own body model (``harness/models/<name>.py``).  A
later change adds a cell, a configuration, a mix, a metric or a body model
as new files; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    def __init__(self, name: str, entry: dict, config: dict, traffic: dict,
                 limits: dict, end_to_end: List[dict],
                 per_layer: List[dict], bench_dir: Path):
        self.name = name
        self.bench_dir = bench_dir
        self.entry = entry
        self.config = config
        self.traffic = traffic
        self.limits = limits
        self.end_to_end = end_to_end
        self.per_layer = per_layer


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_json: Path, bench_dir: Path = BENCH_DIR
              ) -> Cell:
    """The cell ``name`` of ``bench_json`` and the files it names under
    ``bench_dir``.  Raises ``KeyError`` for a cell that is not there and
    ``FileNotFoundError`` for a file that is missing."""
    spec = _read_json(bench_json)
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {bench_json}")
    entry = entries[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    config = _read_json(bench_json.parent / cfg_entry["file"])
    traffic = _read_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    limits = _read_json(bench_dir / "limits" / f"{name}.json")
    return Cell(name, entry, config, traffic, limits,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)],
                bench_dir)


def _load(path: Path, prefix: str, name: str):
    """The module in the file ``path``, named ``prefix`` + ``name``."""
    mod_name = prefix + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR
                  ) -> Callable[[object], Optional[float]]:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value from a
    traced run, or None where the run holds nothing to read."""
    return _load(bench_dir / "metrics" / f"{name}.py", "bench_metric_",
                 name).read


def model_generator(name: str, bench_dir: Path = BENCH_DIR):
    """The body model generator ``harness/models/<name>.py``, which a
    configuration names as ``model.generator``: ``arrays(model)`` gives the
    arrays ``AvatarModel(arrays=...)`` takes, ``prior_arrays(n_joints,
    model)`` the pose prior's (weights [C], means [C, D], covs [C, D, D])."""
    return _load(bench_dir / "harness" / "models" / f"{name}.py",
                 "bench_model_", name)


def read_metrics(metrics: List[dict], run, bench_dir: Path = BENCH_DIR
                 ) -> Dict[str, dict]:
    """Each per-layer metric that its reader finds in ``run``, with its
    unit; a metric whose reader returns None is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
