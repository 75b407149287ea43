"""Stage-clock elapsed ms of the ``forest_walk`` scope per steady frame."""

from harness.readers import stage_ms


def read(run):
    return stage_ms(run, "steady", "forest_walk")
