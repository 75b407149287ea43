"""The per-layer metrics that read the program's stage-clock counters
(``host_reads_per_frame``, ``host_busy_ms.steady``,
``lm_steps_per_fit.steady``): numbers from a tiny traced run of each
tracker on the CPU, and None from a run whose program counts nothing, as
an earlier program's runs do."""

import copy
import json
import time

import pytest

from harness import spec
from harness.cell import TraceRun, run_cell

SEED = 2 ** 31 + 77
NEW = (("host_reads_per_frame", "reads", "tracker"),
       ("host_busy_ms.steady", "ms", "tracker"),
       ("lm_steps_per_fit.steady", "steps", "LM fit"))


def _with_new_metrics(bench_copy, workload):
    """The tiny cell with the three metrics listed for it."""
    b = json.loads((bench_copy / "BENCHMARK.json").read_text())
    for name, unit, layer in NEW:
        b["per_layer"].append(dict(
            name=name, unit=unit, better="lower", source="program_span",
            layer=layer, moves="frames_per_s", workloads=[workload]))
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(b))
    return spec.load_cell(workload, bench_copy / "BENCHMARK.json",
                          bench_copy)


def _without_counts(frames):
    out = copy.deepcopy(frames)
    for f in out:
        for s in f.get("stages", {}).values():
            s.pop("counts", None)
    return out


@pytest.mark.parametrize("workload", ["tiny_fused_steady",
                                      "tiny_host_steady"])
def test_counter_metrics_from_a_traced_run(bench_copy, workload,
                                           monkeypatch):
    """A traced run reports the three metrics: reads and steps positive,
    steps per fit within the configured budget, and the host's own ms
    positive and under the frame's wall; a run of the same frames without
    counts reads None for each."""
    from harness import cell as cell_mod

    cell = _with_new_metrics(bench_copy, workload)
    runs = []
    real = cell_mod.TraceRun

    def keep(*args):
        runs.append(real(*args))
        return runs[-1]

    monkeypatch.setattr(cell_mod, "TraceRun", keep)
    result = run_cell(cell, SEED, 1.0, True, "cpu", time.perf_counter(),
                      str(bench_copy))
    got = result["metrics"]
    for name, unit, _ in NEW:
        assert got[name]["unit"] == unit and got[name]["value"] > 0, name
    cfg = cell.config["tracker_config"]
    budget = cfg.get("frame_icp_iters", 2) * cfg.get("iters_per_icp", 10)
    assert 1 <= got["lm_steps_per_fit.steady"]["value"] <= budget
    (run,) = runs
    steady = [f for f in run.frames if f["kind"] == "steady"]
    wall_ms = sum(f["wall_s"] for f in steady) / len(steady) * 1e3
    assert got["host_busy_ms.steady"]["value"] < wall_ms
    bare = TraceRun(_without_counts(run.frames), None, None, run.cell)
    for name, _, _ in NEW:
        assert spec.metric_reader(name, bench_copy)(bare) is None, name
    # a run with no steady frame reads nothing either
    none = TraceRun([f for f in run.frames if f["kind"] != "steady"], None,
                    None, run.cell)
    for name, _, _ in NEW:
        assert spec.metric_reader(name, bench_copy)(none) is None, name
