"""The host's counted reads of the card per steady frame: the program's
stage-clock counter ``reads`` (one per synchronising copy or read, through
``profiling.host_read`` / ``host_sync``) summed over every scope path of
the frame, the top-level entry of counts made outside scopes included,
averaged over the window's steady frames.  None where the program counts
no reads."""


def read(run):
    vals = [sum(s.get("counts", {}).get("reads", 0)
                for s in f["stages"].values())
            for f in run.frames if f["kind"] == "steady" and "stages" in f]
    if not vals or not any(vals):
        return None
    return sum(vals) / len(vals)
