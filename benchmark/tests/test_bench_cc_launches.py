"""``cc_launches_per_frame``: the program's ``cc_launches`` counter summed
over a steady frame's scopes and averaged over the steady frames; None
where the program counts no launch (its CPU path, or a program that
labels components with the eager loop)."""

from harness import spec
from harness.cell import TraceRun
from harness.spec import BENCH_DIR


def _frame(kind, counts):
    return {"kind": kind, "stages": {
        "frame": {"counts": {}},
        "bgsub": {"counts": dict(counts, reads=3)},
        "blob_suppress": {"counts": dict(counts)}}}


def test_reads_the_launches_of_steady_frames():
    read = spec.metric_reader("cc_launches_per_frame", BENCH_DIR)
    frames = [_frame("reinit", {"cc_launches": 1}),
              _frame("steady", {"cc_launches": 1}),
              _frame("steady", {"cc_launches": 1}),
              {"kind": "empty"}]
    assert read(TraceRun(frames, None, None, None)) == 2.0
    plain = [_frame("steady", {}), _frame("steady", {})]
    assert read(TraceRun(plain, None, None, None)) is None
    assert read(TraceRun([], None, None, None)) is None
