"""CUDA runtime and driver launch calls per traced frame (a graph's launch
counts once)."""


def read(run):
    t = run.trace
    if not t or not t["n_frames"]:
        return None
    return t["host_launches"] / t["n_frames"]
