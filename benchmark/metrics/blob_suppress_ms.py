"""Stage-clock elapsed ms of the ``blob_suppress`` scope per steady frame."""

from harness.readers import stage_ms


def read(run):
    return stage_ms(run, "steady", "blob_suppress")
