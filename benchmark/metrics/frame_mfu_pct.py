"""FP32 operations of the steady frames' fits (``roofline.fit_flops``:
counted from their shapes, the LM steps each took and the searches each
ran) over those frames' wall time, against the FP32 peak."""

from roofline import FP32_OPS_PER_S, fit_flops


def read(run):
    flops, wall = 0.0, 0.0
    for fr in run.frames:
        if fr["kind"] != "steady" or not fr.get("fits"):
            continue
        steps = fr["stages"].get("fit/sync", {}).get("entries", 0)
        n = len(fr["fits"])
        for f in fr["fits"]:
            flops += fit_flops(f["P"], f["J"], f["K"], f["D"],
                               fr["searches"] / n, steps / n, f["pairs"])
        wall += fr["wall_s"]
    if wall <= 0 or flops <= 0:
        return None
    return 100.0 * flops / wall / FP32_OPS_PER_S
