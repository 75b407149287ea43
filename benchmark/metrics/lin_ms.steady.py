"""Stage-clock elapsed ms of the fit's ``lin`` span per steady frame: the
LM steps that re-linearize (search, Jacobian, gram, solve and trial), at
``fit/step/lin`` where the steps replay CUDA graphs and ``fit/lin`` where
they run uncaptured.  None where the program has no such span."""

LIN = ("fit/step/lin", "fit/lin")


def read(run):
    vals = []
    for f in run.frames:
        spans = [f["stages"][p] for p in LIN
                 if f["kind"] == "steady" and p in f.get("stages", {})]
        if spans:
            vals.append(sum(s["elapsed_ms"] for s in spans))
    return sum(vals) / len(vals) if vals else None
