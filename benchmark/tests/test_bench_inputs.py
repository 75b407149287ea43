"""The benchmark's inputs: the frozen model, the generator, the frames each
side gets, and the yardstick's counts."""

import numpy as np
import pytest
import torch

import roofline
from harness import check, model_arrays, spec
from harness.cell import window
from harness.scene import make_scene


def test_frozen_model_arrays_equal_the_port_s():
    from avatar_tpu_torch import testing
    ours = model_arrays.synthetic_arrays(6, 10, 7)
    port = testing.synthetic_arrays(6, 10, 7)
    assert ours.keys() == port.keys()
    for k in ours:
        assert np.array_equal(np.asarray(ours[k]), np.asarray(port[k])), k
    prior = testing.synthetic_pose_prior(24, seed=8, device="cpu")
    w, means, covs = model_arrays.synthetic_pose_prior_arrays(24, seed=8)
    for a, b in ((w, "weights"), (means, "means"), (covs, "covs")):
        assert np.array_equal(a, prior._np[b])


@pytest.mark.parametrize("workload", ["tiny_fused_steady",
                                      "tiny_fused_reentry"])
def test_generator_is_deterministic_per_seed(bench_copy, workload):
    cell = spec.load_cell(workload, bench_copy / "BENCHMARK.json",
                          bench_copy)
    big = 2 ** 31 + 12345
    a = make_scene(cell.config, cell.traffic, big, "cpu")
    b = make_scene(cell.config, cell.traffic, big, "cpu")
    c = make_scene(cell.config, cell.traffic, big + 1, "cpu")
    # every seed: the same frames, in another order
    assert len(a.frames) == len(c.frames)
    assert all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames))
    assert all(np.array_equal(x, y) for x, y in zip(a.frames, c.frames))
    assert all(f.dtype == np.uint16 for f in a.frames)
    assert a.schedule == b.schedule
    assert sorted(a.schedule) == sorted(c.schedule)
    assert a.schedule != c.schedule
    t = cell.traffic
    period = t["segments"] * (t["body_frames"] + t["empty_frames"])
    if t["order"] == "cycle":
        assert len(a.schedule) == period
        k = next(i for i, s in enumerate(a.schedule) if s.segment_start)
        rolled = a.schedule[k:] + a.schedule[:k]
        starts = [i for i, s in enumerate(rolled) if s.segment_start]
        assert starts == list(range(0, period,
                                    t["body_frames"] + t["empty_frames"]))
        assert sum(not s.body for s in a.schedule) == \
            t["segments"] * t["empty_frames"]
    else:
        assert len(a.schedule) == 2 * period - 2


class _Spy:
    """A runner that records the frames it is fed."""

    kind = "spy"

    def __init__(self):
        self.fed = []
        self.n = 0

    def feed(self, frame):
        from harness.trackers import Output
        self.fed.append(frame)
        self.n += 1
        return Output(True, False, 1, 1.0, np.zeros((2, 3)), np.zeros((1, 3)),
                      None)

    def state(self):
        return {"n": self.n}

    def set_state(self, state):
        self.n = state["n"]

    def lbs(self, theta):
        return np.zeros((2, 3))

    def descent(self, theta):
        return None


def test_program_and_reference_get_the_same_frames(bench_copy):
    cell = spec.load_cell("tiny_fused_reentry",
                          bench_copy / "BENCHMARK.json", bench_copy)
    scene = make_scene(cell.config, cell.traffic, 7, "cpu")
    program, reference = _Spy(), _Spy()
    records, _, _ = window(program, scene, 0, 0.05, torch.device("cpu"),
                           None)
    picks = check.pick_frames(records, 7, 3, 1)
    check.frame_gaps(records, picks, scene, reference)
    assert len(reference.fed) == len(picks)
    for i, frame in zip(picks, reference.fed):
        assert frame is program.fed[i]
        assert records[i]["state_before"] == {"n": i}


def test_roofline_counts_by_hand():
    # P=2 vertices, J=1 joint, K=1 shape key
    assert roofline.lbs_flops(2, 1, 1) == 2 * 2 * 3 + 2 * 3 + 60 + \
        2 * 2 * 12 + 2 * 21
    assert roofline.jacobian_flops(2, 1, 1, False) == \
        2 * 2 * 9 + 2 * 2 * 3 + 2 * 2 + 4 * 2 * 3
    assert roofline.jacobian_flops(2, 1, 1, True) == \
        roofline.jacobian_flops(2, 1, 1, False) + 2 * 2 * 9 + 2 * 2 * 3
    D = 6
    assert roofline.gram_flops(2, D) == \
        2 * 6 * D * D + 2 * 6 * D + 2 * 2 * 3 * D + 2 * 2 * D * D + 2 * 2 * D
    assert roofline.solve_flops(D) == D ** 3 // 3 + 2 * D * D
    # two tiles of 256 rows over chunk ranges [0, 2) and [1, 1): 2 chunks
    assert roofline.search_pairs([(0, 2), (1, 1)], 512, 256) == 2 * 512 * 256
    pairs = 2 * 512 * 256
    flops = roofline.fit_flops(2, 1, 1, D, 3, 5, pairs)
    per_lin = (roofline.jacobian_flops(2, 1, 1, False) +
               roofline.gram_flops(2, D) + pairs * 9)
    per_step = roofline.solve_flops(D) + roofline.lbs_flops(2, 1, 1)
    assert flops == roofline.lbs_flops(2, 1, 1) + 3 * per_lin + 5 * per_step
    # 512 rows, 1024 slots, 2 tiles: the bytes of the search's arguments
    ms, by = roofline.search_bound_ms(512, 1024, 2, pairs)
    n_bytes = 512 * 12 + 512 * 4 + 1024 * 12 + 1024 * 4 + 1024 + 2 * 4 * 2 \
        + 512 * 8
    t_bytes = n_bytes / 3.35e12
    t_ops = pairs * 9 / 67e12
    assert by == ("operations" if t_ops > t_bytes else "bytes")
    assert ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
