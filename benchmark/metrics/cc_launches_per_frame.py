"""Connected-components kernel launches per steady frame: the program's
stage-clock counter ``cc_launches`` (one per launch of
``perception/cc_kernel.label``) summed over every scope path of the frame,
averaged over the window's steady frames.  None where the program counts
no such launch (a program that labels components with the eager loop)."""


def read(run):
    vals = [sum(s.get("counts", {}).get("cc_launches", 0)
                for s in f["stages"].values())
            for f in run.frames if f["kind"] == "steady" and "stages" in f]
    if not vals or not any(vals):
        return None
    return sum(vals) / len(vals)
