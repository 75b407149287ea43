"""The control on the card: the plain reference put in the program's place
with TF32 matmuls allowed (the precision below the configurations' float32)
must fail the cell's limits, where the program passes them.  At a cell's
own size, one seed and a short window (about a minute a cell):

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""

from pathlib import Path

import pytest

import control
from harness import check, spec

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["fused_steady", "host_steady"])
def test_control_fails_where_the_program_passes(card, workload):
    cell = spec.load_cell(workload, ROOT / "BENCHMARK.json")
    line = control.readings(cell, 2 ** 31 + 999, 6.0, card)
    program, ctl = line["program_numbers"], line["control_numbers"]
    assert check.judge(program, cell.limits)[0], program
    assert not check.judge(ctl, cell.limits)[0], ctl
