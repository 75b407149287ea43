"""Share of the traced frames' wall in which no kernel, copy or set ran on
the device: their device busy time from the profiler's sub-window, over
the wall that the same frames of the mix took in the window, without the
profiler (the median over the window's runs of each frame), since the
profiler lengthens a frame's host side."""

from statistics import median


def read(run):
    t = run.trace
    if not t or t["n_frames"] != len(t.get("frames", ())):
        return None
    walls = {}
    for fr in run.frames:
        walls.setdefault(fr["frame"], []).append(fr["wall_s"])
    if not all(f in walls for f in t["frames"]):
        return None
    wall = sum(median(walls[f]) for f in t["frames"])
    return 100.0 * (1.0 - t["busy_in_frames_s"] / wall)
