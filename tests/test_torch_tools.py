"""The port's tools (``avatar_tpu_torch/tools``) against the reference's,
on shared inputs, mirroring ``tests/test_tools.py``'s flows at small sizes
(``--synthetic-model 1``, 160x160 frames, ``--device cpu``).

Output files are compared with the reference tool's: segmentations,
datasets and labels are integer or copied data and must be equal.  The
demo's per-frame flags and point counts must be equal, its joints within
``DEMO_JOINT_MM`` of the reference's (the reference on its planned NN
path); the fits are held to at most 7 LM steps after the cold reinit
(``--inner-iters 1``), where the host reinit fit is still determined
(ROADMAP §C).  The tool against the tracker it drives is held to the bit.
"""

import dataclasses
import json
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from avatar_tpu.io.dataset import Dataset as JDataset
from avatar_tpu.tools import demo as jdemo
from avatar_tpu.tools import live_demo as jlive
from avatar_tpu.tools import rtree_run as jrun
from avatar_tpu.tools import rtree_run_dataset as jrund
from avatar_tpu.tools import smplsynth as jsynth
from avatar_tpu_torch import tracking as ttracking
from avatar_tpu_torch import tracking_fused as ttracking_fused
from avatar_tpu_torch.io import camera as tcamera
from avatar_tpu_torch.io.dataset import Dataset as TDataset
from avatar_tpu_torch.io.dataset import DatasetWriter as TWriter
from avatar_tpu_torch.tools import data_recording as trec
from avatar_tpu_torch.tools import demo as tdemo
from avatar_tpu_torch.tools import live_demo as tlive
from avatar_tpu_torch.tools import rtree_run as trun
from avatar_tpu_torch.tools import rtree_run_dataset as trund
from avatar_tpu_torch.tools import rtree_train as ttrain
from avatar_tpu_torch.tools import smplsynth as tsynth
from test_torch_host import planned_nn  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
CAM = ["--width", "160", "--height", "160", "--fx", "140", "--fy", "140",
       "--cx", "80", "--cy", "80"]
CPU = ["--device", "cpu"]
DEMO_JOINT_MM = 1.0


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the trackers' many small operators contend
    badly when parallel test workers each take every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 4-frame synthetic dataset written by the reference's smplsynth,
    and two small forests trained by the port."""
    d = tmp_path_factory.mktemp("scene")
    ds = str(d / "ds")
    jsynth.main([ds, "-n", "4", *CAM, "--synthetic-model", "1",
                 "--batch", "4"])
    trees = []
    for seed in (0, 1):
        tree = str(d / f"t{seed}.srtr")
        ttrain.main([tree, "--synthetic-model", "1", "--images", "10",
                     "--pixels", "200", "--features", "16", "--depth", "5",
                     "--min-samples", "20", "--probe", "70", "--seed",
                     str(seed), *CAM, "-q", *CPU])
        trees.append(tree)
    return ds, trees


def _read_outputs(out):
    """{file name: array} of a tool's output directory (PNG or npy)."""
    import cv2

    res = {}
    for name in sorted(os.listdir(out)):
        p = os.path.join(out, name)
        res[name] = np.load(p) if name.endswith(".npy") else cv2.imread(p)
    return res


@pytest.mark.parametrize("n_trees", [1, 2])
@pytest.mark.parametrize("opencv", [True, False])
def test_rtree_run_matches_reference(tmp_path, monkeypatch, n_trees,
                                     opencv):
    """Segmentation of the reference's fixture frame: the PNG with
    OpenCV, the ``.npy`` label image without (the card's machine's
    path)."""
    if not opencv:
        monkeypatch.setitem(sys.modules, "cv2", None)
    depth = os.path.join(FIX, "ref_frame.depth")
    trees = [os.path.join(FIX, "ref_tree.srtr")] * n_trees
    outs = []
    for tool, extra, sub in ((jrun, [], "j"), (trun, CPU, "t")):
        os.makedirs(tmp_path / sub)
        tool.main([depth, *trees, "-o", str(tmp_path / sub / "seg.png"),
                   *extra])
        outs.append(sorted(os.listdir(tmp_path / sub)))
    assert outs[0] == outs[1] == (["seg.png"] if opencv
                                  else ["seg.png.npy"])
    monkeypatch.undo()
    a, b = (_read_outputs(str(tmp_path / s)) for s in "jt")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n_trees,post", [(1, True), (2, True), (2, False)])
def test_rtree_run_dataset_matches_reference(scene, tmp_path, n_trees,
                                             post):
    ds, trees = scene
    args = [ds, *trees[:n_trees], "-i", "0", "-p", "8"]
    if not post:
        args.append("--no-postprocess")
    jrund.main(args + ["--out", str(tmp_path / "j")])
    trund.main(args + ["--out", str(tmp_path / "t"), *CPU])
    a, b = _read_outputs(str(tmp_path / "j")), _read_outputs(
        str(tmp_path / "t"))
    assert sorted(a) == sorted(b) == [f"seg_{i:06d}.png" for i in range(4)]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert (a[k] != 0).any()


def test_rtree_run_dataset_interactive_matches_reference(scene, tmp_path):
    """The a/d/m/q frame-stepping loop: the same frames, mask toggles and
    images under the reference's key script (tests/test_tools.py)."""
    ds, trees = scene
    seen = {}
    for tool, extra, key in ((jrund, [], "j"), (trund, CPU, "t")):
        keys = iter([ord("d"), ord("d"), ord("a"), ord("m"), ord("m"),
                     ord("d"), ord("q")])
        seen[key] = []
        tool.main([ds, trees[0], "--interactive", "--start", "0", "-p", "8",
                   "--out", str(tmp_path / key), *extra],
                  key_source=lambda: next(keys),
                  on_frame=lambda fid, mask, img, key=key: seen[key].append(
                      (fid, mask, img.copy())))
    assert [s[:2] for s in seen["t"]] == [
        (0, False), (1, False), (2, False), (1, False), (1, True),
        (1, False), (2, False)]
    for (fj, mj, ij), (ft, mt, it) in zip(seen["j"], seen["t"]):
        assert (fj, mj) == (ft, mt)
        np.testing.assert_array_equal(ij, it)


def _recording_tracker(monkeypatch, module, cls_name, log, fused=False):
    """Record (ok, n_points, reinitialized, joints) of every ``track``
    the tool makes, and the tracker it built."""
    cls = getattr(module, cls_name)

    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            log.append(self)

        def track(self, *a, **kw):
            res = super().track(*a, **kw)
            joints = (self.pose()[1] if fused
                      else self.ava.joint_pos.copy())
            log.append((res.ok, res.n_points, res.reinitialized, joints))
            return res

    monkeypatch.setattr(module, cls_name, Recording)


DEMO_ARGS = ["-i", "0", "-p", "8", "--synthetic-model", "1", "-I", "2",
             "-M", "100", "--inner-iters", "1", "-t", "2",
             "--max-frames", "3"]


def _host_state(tracker):
    a = tracker.ava
    return (a.p.copy(), a.r.copy(), a.w.copy(), tracker.com_pre.copy(),
            tracker.reinit, tracker.first_init)


def test_demo_matches_reference(scene, planned_nn, monkeypatch):  # noqa: F811
    """The host tracker over the reference's dataset with the same forest,
    each frame from the reference's state before it (free-running, two
    float32 fits part at near-ties and the sequence amplifies it; ROADMAP
    §C): flags and point counts equal, joints within ``DEMO_JOINT_MM``."""
    ds, trees = scene
    states, jlog, tlog = [], [], []

    class JRecording(jdemo.Tracker):
        def track(self, xyz, labels_override=None):
            states.append(_host_state(self))
            res = super().track(xyz, labels_override)
            jlog.append((res.ok, res.n_points, res.reinitialized,
                         self.ava.joint_pos.copy()))
            return res

    class TRecording(tdemo.Tracker):
        def track(self, xyz, labels_override=None):
            a = self.ava
            (a.p, a.r, a.w, self.com_pre, self.reinit,
             self.first_init) = (x.copy() if hasattr(x, "copy") else x
                                 for x in states[len(tlog)])
            res = super().track(xyz, labels_override)
            tlog.append((res.ok, res.n_points, res.reinitialized,
                         self.ava.joint_pos.copy()))
            return res

    monkeypatch.setattr(jdemo, "Tracker", JRecording)
    monkeypatch.setattr(tdemo, "Tracker", TRecording)
    jdemo.main([ds, trees[0], *DEMO_ARGS])
    tdemo.main([ds, trees[0], *DEMO_ARGS, *CPU])
    assert len(jlog) == len(tlog) == 3
    assert all(r[0] for r in jlog) and jlog[0][2]
    for rj, rt in zip(jlog, tlog):
        assert rt[:3] == rj[:3]
        err = np.linalg.norm(rt[3] - rj[3], axis=1).max() * 1e3
        assert err < DEMO_JOINT_MM, f"{err:.4f} mm"


@pytest.mark.parametrize("fused", [False, True])
def test_demo_adds_nothing_to_the_tracker(scene, tmp_path, monkeypatch,
                                          fused):
    """``demo.main`` (with ``--part-groups`` and ``--metrics``) against
    the tracker it builds, driven directly over the same frames: equal to
    the bit."""
    ds, trees = scene
    log = []
    module, name = ((ttracking_fused, "FusedTracker") if fused
                    else (tdemo, "Tracker"))
    _recording_tracker(monkeypatch, module, name, log, fused)
    metrics = str(tmp_path / "m.jsonl")
    args = list(DEMO_ARGS)
    args[args.index("-I") + 1] = "4"        # a quarter of the samples
    tdemo.main([ds, trees[0], *args, "--part-groups", "--metrics", metrics,
                *CPU] + (["--fused"] if fused else []))
    built, got = log[0], log[1:]
    monkeypatch.undo()
    assert len(got) == 3
    with open(metrics) as f:
        assert len(f.readlines()) == sum(r[0] for r in got)
    cls = (ttracking_fused.FusedTracker if fused else ttracking.Tracker)
    direct = cls(built.model, built.intrin, built.image_size,
                 rtree=built.rtree,
                 config=dataclasses.replace(built.config))
    data = TDataset(ds, pad=8)
    for fid, r in zip(range(3), got):
        res = direct.track(data.xyz(fid))
        joints = direct.pose()[1] if fused else direct.ava.joint_pos
        assert (res.ok, res.n_points, res.reinitialized) == r[:3]
        np.testing.assert_array_equal(joints, r[3])


@pytest.mark.parametrize("fused", [False, True])
def test_demo_partmap_sets_the_forest(scene, tmp_path, monkeypatch, fused):
    """``--partmap`` sets a ``.partmap`` on the forest the tool loads: an
    SMPL-X ``model.npz`` (55 joints, 400 shape columns) on a 24-part forest
    is tracked with ``data/smplx55_smpl24.partmap``, and refused without
    it, naming both counts."""
    from test_torch_smplx import _write_smplx_npz

    from avatar_tpu_torch.perception.partgroups import SMPLX55_TO_SMPL24

    ds, trees = scene
    model_dir = tmp_path / "smplx"
    _write_smplx_npz(model_dir, 400)
    args = list(DEMO_ARGS)
    k = args.index("--synthetic-model")
    del args[k:k + 2]
    args += ["--model-dir", str(model_dir), *CPU] + (
        ["--fused"] if fused else [])
    with pytest.raises(ValueError, match="up to 54.*24 parts"):
        tdemo.main([ds, trees[0], *args])
    log = []
    module, name = ((ttracking_fused, "FusedTracker") if fused
                    else (tdemo, "Tracker"))
    _recording_tracker(monkeypatch, module, name, log, fused)
    tdemo.main([ds, trees[0], *args, "--partmap",
                os.path.join(ROOT, "data", "smplx55_smpl24.partmap")])
    built, got = log[0], log[1:]
    assert built.model.num_joints() == 55
    assert built.rtree.part_map == SMPLX55_TO_SMPL24.tolist()
    assert built.rtree.partmap_type == 0
    assert len(got) == 3 and all(r[3].shape == (55, 3) for r in got
                                 if r[0])


def test_demo_throughput_is_refused(scene, tmp_path, monkeypatch, capsys):
    """``--throughput 2 --fused`` (refused before the port had a batch
    path) tracks the first frame, then the rest as batches of 2, prints
    the reference's line and honours ``--metrics``: its tracked count, its
    metrics lines and its poses equal ``track_batch`` driven directly on
    the tracker it built, to the bit.  (On this small scene the fused
    tracker loses both batch frames at the root-jump gate, with ``track``
    as with ``track_batch``.)"""
    ds, trees = scene
    log = []
    _recording_tracker(monkeypatch, ttracking_fused, "FusedTracker", log,
                       fused=True)
    metrics = str(tmp_path / "m.jsonl")
    tdemo.main([ds, trees[0], *DEMO_ARGS, "--part-groups", "--fused",
                "--throughput", "2", "--metrics", metrics, *CPU])
    built = log[0]
    monkeypatch.undo()
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == f"[demo] metrics written to {metrics}"
    m = re.fullmatch(r"\[demo\] (\d+) frames in \d+\.\d\ds \(\d+\.\d fps, "
                     r"(\d+) tracked\), batch=2", out[-2])
    assert m, out[-2]
    direct = ttracking_fused.FusedTracker(
        built.model, built.intrin, built.image_size, rtree=built.rtree,
        config=dataclasses.replace(built.config))
    data = TDataset(ds, pad=8)
    head = direct.track(data.xyz(0))
    res = direct.track_batch([data.xyz(1), data.xyz(2)])
    assert head.ok and (int(m[1]), int(m[2])) == (2, sum(r.ok for r in res))
    with open(metrics) as f:
        lines = [json.loads(ln) for ln in f]
    assert [(r["ok"], r["n_points"]) for r in lines] == [
        (r.ok, r.n_points) for r in [head, *res]]
    for a, b in zip(built.batch_thetas, direct.batch_thetas):
        assert torch.equal(a, b)


class _Stub:
    """A tracker that only records what the key handler does to it."""

    def __init__(self):
        self.reinit, self.backgrounds = False, 0

    def set_background(self, xyz):
        self.backgrounds += 1


def test_live_demo_state_matches_reference():
    keys = [ord(c) for c in " b h  tT23q"] + [27, -1, None, ord("Q")]
    for start_paused in (False, True):
        js, ts = (jlive.LiveDemoState(start_paused),
                  tlive.LiveDemoState(start_paused))
        jt, tt = _Stub(), _Stub()
        for k in keys:
            js.handle_key(k, jt, None)
            ts.handle_key(k, tt, None)
            assert vars(ts) == vars(js) and vars(tt) == vars(jt)
    # a key code above 255 (an arrow key through cv2.waitKeyEx): the
    # reference's handler raises, the port's ignores it
    with pytest.raises(ValueError):
        js.handle_key(300, jt, None)
    before = dict(vars(ts))
    ts.handle_key(300, tt, None)
    assert vars(ts) == before


def test_live_demo_synthetic_interactive():
    """The reference's scripted interactive drive (tests/test_tools.py) on
    the port, its synthetic camera rendering on the CPU."""
    script = {0: ord(" "), 4: ord(" "), 6: ord("b"), 7: ord(" "),
              10: ord("q")}
    frame_no = [0]

    def keys():
        k = script.get(frame_no[0], -1)
        frame_no[0] += 1
        return k

    log = {}
    tlive.main(["--camera", "synthetic", "--frames", "12",
                "--synthetic-model", "1", "-I", "4", "-M", "200",
                "--interactive", *CPU], key_source=keys,
               on_frame=lambda n, st, res: log.__setitem__(
                   n, (st.pause, st.bg_set,
                       None if res is None else res.reinitialized)))
    assert log[0][:2] == (False, True) and log[0][2] is not None
    assert log[2][0] is False and log[2][2] is not None
    assert log[4] == (True, True, None) and log[5][2] is None
    assert log[7][0] is False and log[7][2] is not None
    assert max(log) < 11


@pytest.mark.parametrize("bg_after", [0, 1])
def test_live_demo_warms_after_the_background(scene, tmp_path, monkeypatch,
                                              bg_after):
    """``--fused`` over a recording with a forest: ``warmup`` runs once,
    after ``set_background`` when a background capture is pending (the
    reference warms before it), else on the first tracked frame."""
    ds, trees = scene
    src, rec = TDataset(ds, pad=8), str(tmp_path / "rec")
    w = TWriter(rec, src.intrin, pad=4)
    for i in range(4):
        w.write_depth(i + 1, src.depth(i))
    events = []
    cls = ttracking_fused.FusedTracker
    for name in ("set_background", "warmup", "track"):
        real = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda self, *a, name=name,
                            real=real, **kw: (events.append(name),
                                              real(self, *a, **kw))[1])
    tlive.main([trees[0], "--camera", rec, "--fused", "--frames", "3",
                "--synthetic-model", "1", "-I", "6", "-M", "100",
                "--inner-iters", "1", "--capture-bg-after", str(bg_after),
                *CPU])
    first_warm = events.index("warmup")
    assert events.count("warmup") == 1
    if bg_after:
        assert events.index("set_background") < first_warm
        assert events[:first_warm].count("track") == 1   # frame 0, cold
    else:
        assert "set_background" not in events and first_warm == 0


def test_live_demo_dead_camera_fails(monkeypatch):
    """A camera whose capture thread dies ends the loop with the error;
    the reference's loop would wait for a frame forever."""

    class Dead(tcamera.DepthCamera):
        def intrinsics(self):
            return tcamera.CameraIntrin(fx=50.0, fy=50.0, cx=16.0, cy=12.0)

        def image_size(self):
            return (24, 32)

        def next_frame(self):
            raise OSError("no device")

    monkeypatch.setattr(tlive, "open_camera", lambda spec, **kw: Dead(0))
    err = []

    def run():
        try:
            tlive.main(["--camera", "dead", "--synthetic-model", "1", *CPU])
        except RuntimeError as e:
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and err and "no device" in str(err[0])


def test_data_recording_readable_by_both(tmp_path):
    out = str(tmp_path / "rec")
    trec.main([out, "--camera", "synthetic", "--frames", "3", "--fps", "0",
               "--verify", *CPU])
    j, t = JDataset(out, pad=4), TDataset(out, pad=4)
    assert list(j.frames()) == list(t.frames()) == [1, 2, 3]
    for i in (1, 2, 3):
        for name in ("depth", "xyz", "rgb"):
            np.testing.assert_array_equal(getattr(j, name)(i),
                                          getattr(t, name)(i))
        assert (t.depth(i) > 0).all() and t.rgb(i).shape == (360, 640, 3)


def test_smplsynth_renders_an_smplx_body(tmp_path):
    """``smplsynth`` on an SMPL-X ``model.npz`` of the benchmark's SMPL-X
    body at its configuration's size (20,734 faces, past the reference's
    2^14-face key) with ``data/smplx55_smpl24.partmap``: the depth and
    part-mask files equal the port's own ``render_batch``, and the masks
    hold the 24 parts' labels."""
    from test_torch_smplx import _write_smplx_npz

    from avatar_tpu_torch.core.model import AvatarModel
    from avatar_tpu_torch.io import formats
    from avatar_tpu_torch.io.calibration import CameraIntrin
    from avatar_tpu_torch.train import synth

    model_dir = tmp_path / "smplx"
    config = json.loads(open(os.path.join(
        ROOT, "benchmark", "configs", "fused_smplx_720p.json")).read())
    arrays = _write_smplx_npz(model_dir, 20, rings=config["model"]["rings"])
    assert len(arrays["f"]) == 20734
    partmap = os.path.join(ROOT, "data", "smplx55_smpl24.partmap")
    out = str(tmp_path / "s")
    tsynth.main([out, "-n", "2", "--batch", "2", "--seed", "5", *CAM,
                 "--model-dir", str(model_dir), "--part-map", partmap, *CPU])
    model = AvatarModel(str(model_dir), device="cpu")
    src = synth.make_source(model, CameraIntrin(fx=140.0, fy=140.0, cx=80.0,
                                                cy=80.0),
                            formats.read_partmap(partmap)[0], n_images=2,
                            seed=5)
    depth, mask, _ = synth.render_batch(src, model.parents, [0, 1], 5, 160,
                                        160, model.num_shape_keys())
    ds = TDataset(out, pad=8)
    labels = set()
    for i in range(2):
        np.testing.assert_array_equal(ds.depth(i), depth[i].numpy())
        np.testing.assert_array_equal(ds.part_mask(i), mask[i].numpy())
        labels |= set(np.unique(mask[i].numpy()).tolist())
    assert labels - {255} and max(labels - {255}) <= 23
    assert len(labels - {255}) >= 10


def test_smplsynth_files(tmp_path):
    """Depth and part-mask files equal the port's own ``render_batch``
    (a padded last batch included); the labels are the reference's
    formulas (the 2D projection, ``so3_log`` through the reference's
    ``rotation``) applied to the port's draws, which ``sample_pose``
    repeats for the same (seed, id)."""
    import jax.numpy as jnp

    from avatar_tpu.core import rotation as jrot
    from avatar_tpu_torch.core.lbs import lbs
    from avatar_tpu_torch.io.calibration import CameraIntrin
    from avatar_tpu_torch.testing import synthetic_model
    from avatar_tpu_torch.train import synth

    out = str(tmp_path / "s")
    tsynth.main([out, "-n", "3", "--batch", "2", "--seed", "5", *CAM,
                 "--synthetic-model", "1", *CPU])
    model = synthetic_model(detail=1, device="cpu")
    intrin = CameraIntrin(fx=140.0, fy=140.0, cx=80.0, cy=80.0)
    src = synth.make_source(model, intrin, n_images=3, seed=5)
    K = model.num_shape_keys()
    depth, mask, joints = synth.render_batch(src, model.parents, [0, 1, 2],
                                             5, 160, 160, K)
    ds = TDataset(out, pad=8)
    assert list(ds.frames(start=0)) == [0, 1, 2]
    w, p, rots = synth.sample_pose(src, [0, 1, 2], 5, K)
    for i in range(3):
        np.testing.assert_array_equal(ds.depth(i), depth[i].numpy())
        np.testing.assert_array_equal(ds.part_mask(i), mask[i].numpy())
        wi, pi, ri = synth.sample_pose(src, [i], 5, K)
        for a, b in ((wi[0], w[i]), (pi[0], p[i]), (ri[0], rots[i])):
            assert torch.equal(a, b)
        _, jp, _, _ = lbs(src.lbs, model.parents, w[i], p[i], rots[i])
        assert torch.equal(jp, joints[i])
        jp = jp.numpy()
        lab = ds.joints(i)
        np.testing.assert_array_equal(lab["joints_xyz"], jp)
        np.testing.assert_array_equal(lab["pos"], p[i].numpy())
        np.testing.assert_array_equal(lab["shape"],
                                      w[i].numpy().astype(np.float64))
        j2d = np.stack([jp[:, 0] * intrin.fx / jp[:, 2] + intrin.cx,
                        -jp[:, 1] * intrin.fy / jp[:, 2] + intrin.cy], 1)
        np.testing.assert_array_equal(lab["joints"],
                                      np.round(j2d).astype(np.int32))
        aa = np.asarray(jrot.so3_log(jnp.asarray(rots[i].numpy())))
        np.testing.assert_allclose(lab["rots"], aa.reshape(-1), atol=1e-5)
        np.testing.assert_array_equal(lab["smpl_params"], lab["rots"][3:])
        assert (ds.depth(i) > 0).sum() > 50
