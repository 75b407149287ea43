"""Stand-ins for the port's instrumentation: the reference records no
spans."""

import contextlib

FRAME_SCOPE = "frame"


@contextlib.contextmanager
def scope(name: str):
    yield
