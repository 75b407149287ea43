"""FP32 operations of the steady frames' re-linearizing LM steps over the
time of their ``lin`` spans, against the FP32 peak.  Per step, counted
from the fit's shapes (``roofline``): the Jacobian, the gram, the
search's scanned pairs, the solve and the trial's LBS forward; the steps
are the span's entries, shared evenly among the frame's fits.  None where
the program has no ``lin`` span."""

from roofline import (FP32_OPS_PER_S, OPS_PER_PAIR, gram_flops,
                      jacobian_flops, lbs_flops, solve_flops)

LIN = ("fit/step/lin", "fit/lin")


def read(run):
    flops, ms = 0.0, 0.0
    for fr in run.frames:
        if fr["kind"] != "steady" or not fr.get("fits"):
            continue
        spans = [fr["stages"][p] for p in LIN if p in fr["stages"]]
        if not spans:
            continue
        steps = sum(s["entries"] for s in spans)
        for f in fr["fits"]:
            P, J, K, D = f["P"], f["J"], f["K"], f["D"]
            per_step = (jacobian_flops(P, J, K, D > 3 + 3 * J) +
                        gram_flops(P, D) + f["pairs"] * OPS_PER_PAIR +
                        solve_flops(D) + lbs_flops(P, J, K))
            flops += per_step * steps / len(fr["fits"])
        ms += sum(s["elapsed_ms"] for s in spans)
    if ms <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (ms * 1e-3) / FP32_OPS_PER_S
