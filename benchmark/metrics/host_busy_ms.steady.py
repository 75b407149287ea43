"""The host's own ms per steady frame, outside its waits on the card: the
program's ``frame`` root scope's ``host_ms`` less the ``read_ms`` (the
host's blocked time in counted reads) of every scope entered in the frame,
averaged over the window's steady frames.  None where the program counts
no read time."""


def read(run):
    vals = []
    for f in run.frames:
        st = f.get("stages", {})
        if f["kind"] != "steady" or "frame" not in st:
            continue
        waits = [s["counts"]["read_ms"] for s in st.values()
                 if s["entries"] and "read_ms" in s.get("counts", {})]
        if waits:
            vals.append(st["frame"]["host_ms"] - sum(waits))
    return sum(vals) / len(vals) if vals else None
