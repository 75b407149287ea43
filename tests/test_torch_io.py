"""Parity of the port's dataset and camera I/O (``avatar_tpu_torch/io/
dataset.py``, ``io/camera.py``) with the reference's.

Files are held byte for byte (``intrin.txt``, ``.depth``, part-mask
``.tiff``, ``.jpg``, joint ``.yml``) and each package reads the other's
directory to equal arrays.  The synthetic camera renders with each
package's own renderer from the same seed: foreground masks may differ on
at most ``EDGE_PX`` pixels per frame (an edge pixel flips where the two
float32 LBS passes round apart), XYZ agrees within ``XYZ_ATOL`` m on the
pixels both call body, and the Lambert RGB within 1 grey level."""

import os
import time

import numpy as np
import pytest

from avatar_tpu.io import camera as jcamera
from avatar_tpu.io import dataset as jdataset
from avatar_tpu.io.calibration import CameraIntrin as JIntrin
from avatar_tpu_torch.io import camera as tcamera
from avatar_tpu_torch.io import dataset as tdataset
from avatar_tpu_torch.io.calibration import CameraIntrin as TIntrin

INTRIN = dict(fx=140.5, fy=139.25, cx=80.0, cy=60.5)
EDGE_PX = 3
XYZ_ATOL = 1e-5


def _frames(seed, n=3, H=48, W=64):
    """Depth maps with zero holes, RGB, part masks and joint labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = (rng.random((H, W)) * 3 + 0.5).astype(np.float32)
        d[rng.random((H, W)) < 0.3] = 0.0
        out.append(dict(
            depth=d,
            rgb=rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
            mask=rng.integers(0, 25, (H, W)).astype(np.uint8),
            joints=(rng.random((24, 2)) * [W, H], rng.random((24, 3)),
                    rng.random(3), rng.standard_normal(10),
                    rng.standard_normal(72), rng.standard_normal(69))))
    return out


def _write(pkg_dataset, intrin, root, frames, pad):
    w = pkg_dataset.DatasetWriter(str(root), intrin, pad=pad)
    assert not w.use_exr        # this OpenCV has no EXR writer, or none
    for i, f in enumerate(frames, start=1):
        w.write_depth(i, f["depth"])
        w.write_rgb(i, f["rgb"])
        w.write_part_mask(i, f["mask"])
        w.write_joints(i, *f["joints"])


def _tree(root):
    return {os.path.relpath(os.path.join(d, n), root)
            for d, _, names in os.walk(root) for n in names}


@pytest.mark.parametrize("pad", [4, 8])
def test_dataset_writers_byte_identical_and_cross_read(tmp_path, pad):
    frames = _frames(pad)
    jroot, troot = tmp_path / "j", tmp_path / "t"
    _write(jdataset, JIntrin(**INTRIN), jroot, frames, pad)
    _write(tdataset, TIntrin(**INTRIN), troot, frames, pad)
    files = _tree(jroot)
    assert files == _tree(troot)
    assert {os.path.splitext(f)[1] for f in files} == {
        ".txt", ".depth", ".jpg", ".tiff", ".yml"}
    for f in sorted(files):
        assert (jroot / f).read_bytes() == (troot / f).read_bytes(), f
    # each package reads the other's directory as the port reads its own
    own = tdataset.Dataset(str(troot), pad=pad)
    np.testing.assert_array_equal(own.depth(2), frames[1]["depth"])
    for other in (jdataset.Dataset(str(troot), pad=pad),
                  tdataset.Dataset(str(jroot), pad=pad)):
        assert list(other.frames()) == list(own.frames()) == [1, 2, 3]
        for i in (1, 2, 3):
            for name in ("depth", "xyz", "rgb", "part_mask"):
                np.testing.assert_array_equal(getattr(other, name)(i),
                                              getattr(own, name)(i))
            a, b = other.joints(i), own.joints(i)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_opencv_writers_name_opencv_without_it(tmp_path, monkeypatch):
    """Without OpenCV the depth frames and intrin.txt still work; the
    OpenCV-only writers raise an error that names OpenCV, and the readers
    of those files return None as the reference's do."""
    monkeypatch.setattr(tdataset, "cv2", None)
    monkeypatch.setattr(tdataset, "_EXR_OK", None)
    f = _frames(1, n=1)[0]
    w = tdataset.DatasetWriter(str(tmp_path), TIntrin(**INTRIN), pad=4)
    assert not w.use_exr
    w.write_depth(1, f["depth"])
    for call in (lambda: w.write_rgb(1, f["rgb"]),
                 lambda: w.write_part_mask(1, f["mask"]),
                 lambda: w.write_joints(1, *f["joints"])):
        with pytest.raises(RuntimeError, match="OpenCV"):
            call()
    ds = tdataset.Dataset(str(tmp_path), pad=4)
    np.testing.assert_array_equal(ds.depth(1), f["depth"])
    assert ds.intrin == TIntrin(**INTRIN)
    assert ds.rgb(1) is None and ds.joints(1) is None


def test_synthetic_camera_matches_reference():
    """Four frames from the same seed, rendered by each package."""
    size = (120, 160)
    j = jcamera.SyntheticCamera(image_size=size, seed=7)
    t = tcamera.SyntheticCamera(image_size=size, seed=7, device="cpu")
    assert t.intrinsics() == TIntrin(**vars(j.intrinsics()))
    assert t.image_size() == j.image_size() == size
    for _ in range(4):
        (xj, rj), (xt, rt) = j.next_frame(), t.next_frame()
        assert xt.shape == xj.shape == size + (3,) and xt.dtype == np.float32
        fj, ft = xj[..., 2] < t.wall_depth, xt[..., 2] < t.wall_depth
        assert fj.sum() > 100
        assert (fj != ft).sum() <= EDGE_PX
        np.testing.assert_allclose(xt[fj & ft], xj[fj & ft], rtol=0,
                                   atol=XYZ_ATOL)
        np.testing.assert_array_equal(xt[~fj & ~ft], xj[~fj & ~ft])
        assert rt.shape == rj.shape == size + (3,)
        assert np.abs(rt.astype(int) - rj.astype(int)).max() <= 1
    np.testing.assert_allclose(t.gt.r, j.gt.r, atol=1e-6)
    np.testing.assert_allclose(t.gt.p, j.gt.p, atol=1e-12)


def _recording(tmp_path, n=3):
    root = tmp_path / "rec"
    w = tdataset.DatasetWriter(str(root), TIntrin(**INTRIN), pad=4)
    rng = np.random.default_rng(9)
    for i in range(1, n + 1):
        d = (rng.random((12, 16)) * 3 + 0.05).astype(np.float32)
        d[rng.random((12, 16)) < 0.2] = 0.0
        d[i, :3] = 0.06          # closer than 0.1 m: noise
        w.write_depth(i, d)
        w.write_rgb(i, rng.integers(0, 256, (12, 16, 3)).astype(np.uint8))
    return str(root)


@pytest.mark.parametrize("loop", [True, False])
def test_dataset_camera_playback_matches_reference(tmp_path, loop):
    """Playback order, looping, the end of a recording and the noise
    removal (points closer than 0.1 m zeroed) are the reference's."""
    root = _recording(tmp_path)
    j = jcamera.DatasetCamera(root, loop=loop)
    t = tcamera.DatasetCamera(root, loop=loop)
    assert t.image_size() == j.image_size() == (12, 16)
    assert t.intrinsics() == TIntrin(**vars(j.intrinsics()))
    for _ in range(7):
        (xj, rj), (xt, rt) = j.next_frame(), t.next_frame()
        if xj is None:
            assert xt is None and rt is None and not loop
            continue
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(t._noise_removal(xt),
                                      j._noise_removal(xj))
        assert (t._noise_removal(xt)[..., 2] != xt[..., 2]).any()


def test_open_camera_dispatch_and_missing_backends(tmp_path):
    root = _recording(tmp_path, n=1)
    assert type(tcamera.open_camera(root)).__name__ == type(
        jcamera.open_camera(root)).__name__ == "DatasetCamera"
    cam = tcamera.open_camera("synthetic", device="cpu",
                              image_size=(24, 32))
    assert isinstance(cam, tcamera.SyntheticCamera)
    assert cam.model.device.type == "cpu"
    for spec in ("k4a", "freenect2"):
        with pytest.raises(RuntimeError) as tj:
            jcamera.open_camera(spec)
        with pytest.raises(RuntimeError) as tt:
            tcamera.open_camera(spec)
        assert str(tt.value) == str(tj.value)


class _Failing(tcamera.DepthCamera):
    """Delivers two frames, then its backend raises."""

    def __init__(self):
        super().__init__(fps_cap=0)
        self.n = 0

    def next_frame(self):
        self.n += 1
        if self.n > 2:
            raise OSError("device unplugged")
        return np.ones((4, 5, 3), np.float32), None


def test_capture_error_reaches_the_consumer():
    """The reference's thread dies silently and its consumer waits for
    the next frame forever; the port's consumer gets the error."""
    cam = _Failing()
    cam.begin_capture()
    thread = cam._thread
    deadline = time.monotonic() + 10
    try:
        with pytest.raises(RuntimeError, match="device unplugged") as e:
            while time.monotonic() < deadline:
                cam.get_frame()
                time.sleep(0.001)
        assert isinstance(e.value.__cause__, OSError)
        for call in (cam.get_xyz_map, cam.get_rgb_map):
            with pytest.raises(RuntimeError):
                call()
    finally:
        cam.end_capture()
    assert cam.frame_id == 2
    assert not thread.is_alive()
