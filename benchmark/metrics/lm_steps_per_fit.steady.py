"""LM steps per fit in the steady frames: the program's stage-clock
counter ``steps`` of the ``fit`` scope (one per step run, so an early stop
shows) over that scope's entries, summed over the window's steady frames.
None where the program counts no steps."""


def read(run):
    steps = fits = 0
    for f in run.frames:
        fit = f.get("stages", {}).get("fit")
        if f["kind"] == "steady" and fit and "steps" in fit.get("counts", {}):
            steps += fit["counts"]["steps"]
            fits += fit["entries"]
    return steps / fits if fits else None
