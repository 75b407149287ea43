"""The benchmark's inputs: the frozen model, the generator, the frames each
side gets, and the yardstick's counts."""

import hashlib

import numpy as np
import pytest
import torch

import roofline
from harness import check, model_arrays, spec
from harness.cell import window
from harness.scene import make_scene
from reference import raster


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


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# sha256 of each cell's frames and schedule at seed 2^31 + 77, from the
# harness as it was before a configuration could name its own body model
@pytest.mark.parametrize("workload,digest", [
    ("tiny_fused_steady",
     "f498291bddfeb05ebdc29e954382a65183009f79b37121c3e621ac6370a5f735"),
    ("tiny_host_steady",
     "f498291bddfeb05ebdc29e954382a65183009f79b37121c3e621ac6370a5f735"),
    ("tiny_fused_reentry",
     "1551c002f0b5c6a23441ed2564a625aa7176691cb3b1d4370c36f844dea8d862"),
])
def test_frames_and_schedule_stay_the_same(bench_copy, workload, digest):
    cell = spec.load_cell(workload, bench_copy / "BENCHMARK.json",
                          bench_copy)
    scene = make_scene(cell.config, cell.traffic, 2 ** 31 + 77, "cpu")
    schedule = repr([tuple(s) for s in scene.schedule]).encode()
    assert _digest(scene.frames + [np.frombuffer(schedule, np.uint8)]) \
        == digest


def test_raster_keys_up_to_2_14_faces_are_the_int32_keys():
    g = torch.Generator().manual_seed(3)
    zq = torch.randint(1, 1 << raster.Z_BITS, (4096,), generator=g,
                       dtype=torch.int32)
    for n_faces in (100, 1 << 14):
        face = torch.randint(0, n_faces, (4096,), generator=g)
        keys, bits = raster.fragment_keys(zq, face, n_faces)
        assert bits == 14
        assert torch.equal(keys, (zq << 14) | (face.to(torch.int32) &
                                               ((1 << 14) - 1)))
    keys, bits = raster.fragment_keys(zq, face, (1 << 14) + 1)
    assert bits == 15


def test_raster_outputs_up_to_2_14_faces_stay_the_same():
    """Every output of a raster of 60 random faces, to the bit, as the
    int32 key gave them before the wider key."""
    rng = np.random.default_rng(5)
    P, F, H, W = 90, 60, 48, 64
    proj = torch.as_tensor(rng.uniform([-5, -5], [W + 5, H + 5], (2, P, 2)),
                           dtype=torch.float32)
    z = torch.as_tensor(rng.uniform(1.0, 5.0, (2, P)), dtype=torch.float32)
    faces = torch.as_tensor(np.stack([rng.permutation(P)[:3]
                                      for _ in range(F)]), dtype=torch.int32)
    r = raster.rasterize_batch(proj, z, faces, H, W, 200000)
    assert int((r.fid >= 0).sum()) == 5795
    assert _digest(t.numpy() for t in r) == \
        "53a21da0eacd887d33b250993d7627dfc235ee5bcb550353d373d7f0c96608f1"


def test_raster_past_2_14_faces_is_a_brute_force_zbuffer():
    """2^14 small faces and 300 large ones over a 32x24 image: the winning
    face of every pixel is that of a per-pixel search over every face, by
    the 17-bit depth and then the lowest face id; faces numbered above
    2^14 win some pixels."""
    rng = np.random.default_rng(11)
    H, W, n_small, n_large = 24, 32, 1 << 14, 300
    centre = np.concatenate([rng.uniform(0, W, (n_small + n_large, 1)),
                             rng.uniform(0, H, (n_small + n_large, 1))], 1)
    size = np.r_[np.full(n_small, 2.0), np.full(n_large, 9.0)][:, None, None]
    angle = rng.uniform(0, 2 * np.pi, (n_small + n_large, 1)) + \
        np.array([0.0, 2.1, 4.2])
    corners = centre[:, None] + size * np.stack([np.cos(angle),
                                                 np.sin(angle)], -1)
    F = n_small + n_large
    proj = torch.as_tensor(corners.reshape(1, 3 * F, 2), dtype=torch.float32)
    z = torch.as_tensor(rng.uniform(1.0, 6.0, (1, 3 * F)),
                        dtype=torch.float32)
    faces = torch.arange(3 * F, dtype=torch.int32).reshape(F, 3)
    r = raster.rasterize_batch(proj, z, faces, H, W, 600000)
    assert int(r.n_dropped[0]) == 0

    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    px, py = xx.reshape(-1, 1), yy.reshape(-1, 1)              # [HW, 1]
    a, b, c = (proj[0, faces[:, k].long()][None] for k in range(3))
    w1, w2, w3 = raster._barycentric(px, py, a, b, c)          # [HW, F]
    za, zb, zc = (z[0, faces[:, k].long()][None] for k in range(3))
    zi = w1 * za + w2 * zb + w3 * zc
    inside = (w1 >= -1e-6) & (w2 >= -1e-6) & (w3 >= -1e-6) & (zi > 0)
    zq = torch.clamp(zi / raster.Z_MAX_DEFAULT * float(1 << raster.Z_BITS),
                     1.0, float((1 << raster.Z_BITS) - 1)).to(torch.int64)
    key = torch.where(inside, zq * F + torch.arange(F), torch.iinfo(
        torch.int64).max)
    best = key.min(1).values
    want = torch.where(best < torch.iinfo(torch.int64).max, best % F, -1)
    got = r.fid[0].reshape(-1).long()
    assert torch.equal(got, want)
    assert (got >= 1 << 14).sum() > 20 and (
        (got >= 0) & (got < 1 << 14)).sum() > 20


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
