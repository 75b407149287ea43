"""The steady fit's search: its least time (``roofline.search_bound_ms``:
bytes over HBM bandwidth or pairs x 9 over the FP32 peak, whichever binds)
over its device time (CUDA events around 50 calls of
``nn_kernel.nn_match`` at the search's rows, slots and part ranges)."""


def read(run):
    nn = run.nn
    if not nn or nn["device_ms"] <= 0:
        return None
    return 100.0 * nn["bound_ms"] / nn["device_ms"]
