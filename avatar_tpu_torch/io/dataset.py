"""OpenARK dataset reading and writing (counterpart of
``avatar_tpu/io/dataset.py``; recorded sequences and synthetic data).

Directory layout (as consumed by reference demo.cpp:112-170 and produced by
data-recording.cpp / smplsynth.cpp):

    <root>/intrin.txt
    <root>/depth_exr/depth_XXXXXXXX.exr     (or .depth RLE)
    <root>/rgb/rgb_XXXXXXXX.jpg             (recordings only)
    <root>/part_mask/part_mask_XXXXXXXX.tiff (synthetic only)
    <root>/joint/joint_XXXXXXXX.yml          (synthetic only; OpenCV
                                              FileStorage YAML with joints,
                                              joints_xyz, pos, shape, rots,
                                              smpl_params)

Frame ids are zero-padded; recordings pad to 4 (demo.cpp:121), synthetic to
8 (smplsynth.cpp:104).  Host numpy: depth frames (``.depth``) and
``intrin.txt`` need nothing else, the EXR, RGB, part-mask and joint files
need OpenCV.  Without it the readers return None, as the reference's do,
and the OpenCV-only writers raise an error that says so.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

from avatar_tpu_torch.io import formats
from avatar_tpu_torch.io.calibration import CameraIntrin

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
try:
    import cv2
except ImportError:  # pragma: no cover - the card's machine has no OpenCV
    cv2 = None


def _exr_supported() -> bool:
    """Probe once whether this OpenCV build has an EXR codec."""
    global _EXR_OK
    if _EXR_OK is None:
        if cv2 is None:
            _EXR_OK = False
        else:
            try:
                _EXR_OK = bool(cv2.haveImageWriter("probe.exr"))
            except AttributeError:
                import tempfile

                with tempfile.TemporaryDirectory() as d:
                    try:
                        _EXR_OK = bool(cv2.imwrite(
                            os.path.join(d, "p.exr"),
                            np.zeros((2, 2), np.float32)))
                    except cv2.error:
                        _EXR_OK = False
    return _EXR_OK


_EXR_OK = None


def _need_cv2(what: str):
    if cv2 is None:
        raise RuntimeError(f"writing {what} needs OpenCV (cv2), which is "
                           "not installed; depth frames and intrin.txt do "
                           "not")
    return cv2


class Dataset:
    """Reader for an OpenARK dataset directory."""

    def __init__(self, root: str, pad: int = 4):
        self.root = root
        self.pad = pad
        self.intrin = CameraIntrin.from_file(os.path.join(root, "intrin.txt"))

    def _find(self, sub: str, prefix: str, frame_id: int) -> Optional[str]:
        for ext in (".exr", ".depth", ".tiff", ".png", ".jpg"):
            p = os.path.join(self.root, sub,
                             f"{prefix}_{frame_id:0{self.pad}d}{ext}")
            if os.path.exists(p):
                return p
        return None

    def has_frame(self, frame_id: int) -> bool:
        return self._find("depth_exr", "depth", frame_id) is not None

    def depth(self, frame_id: int) -> np.ndarray:
        """[H, W] float32 depth (or [H, W, 3] XYZ for 3-channel EXR)."""
        p = self._find("depth_exr", "depth", frame_id)
        if p is None:
            raise FileNotFoundError(f"no depth frame {frame_id} in {self.root}")
        return formats.read_depth(p)

    def xyz(self, frame_id: int) -> np.ndarray:
        """[H, W, 3] XYZ map (reference util::readXYZ semantics)."""
        m = self.depth(frame_id)
        if m.ndim == 2:
            return self.intrin.depth_to_xyz_np(m)
        return m

    def rgb(self, frame_id: int) -> Optional[np.ndarray]:
        p = self._find("rgb", "rgb", frame_id)
        if p is None or cv2 is None:
            return None
        return cv2.imread(p)

    def part_mask(self, frame_id: int) -> Optional[np.ndarray]:
        p = self._find("part_mask", "part_mask", frame_id)
        if p is None or cv2 is None:
            return None
        return cv2.imread(p, cv2.IMREAD_GRAYSCALE)

    def joints(self, frame_id: int) -> Optional[Dict[str, np.ndarray]]:
        p = os.path.join(self.root, "joint",
                         f"joint_{frame_id:0{self.pad}d}.yml")
        if not os.path.exists(p) or cv2 is None:
            return None
        fs = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
        out = {}
        for key in ("joints", "joints_xyz", "pos", "shape", "rots",
                    "smpl_params"):
            node = fs.getNode(key)
            if not node.empty():
                out[key] = np.asarray(node.mat()).squeeze()
        fs.release()
        return out

    def frames(self, start: int = 1) -> Iterator[int]:
        i = start
        while self.has_frame(i):
            yield i
            i += 1


class DatasetWriter:
    """Writer for recordings and synthetic datasets."""

    def __init__(self, root: str, intrin: CameraIntrin, pad: int = 8,
                 use_exr: bool = True):
        self.root = root
        self.pad = pad
        # the reference's .depth RLE codec where this OpenCV build has no
        # EXR writer, or there is no OpenCV
        self.use_exr = use_exr and _exr_supported()
        os.makedirs(os.path.join(root, "depth_exr"), exist_ok=True)
        intrin.write_file(os.path.join(root, "intrin.txt"))
        self.intrin = intrin

    def _path(self, sub: str, prefix: str, frame_id: int, ext: str) -> str:
        d = os.path.join(self.root, sub)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{prefix}_{frame_id:0{self.pad}d}{ext}")

    def write_depth(self, frame_id: int, depth: np.ndarray) -> None:
        if self.use_exr:
            cv2.imwrite(self._path("depth_exr", "depth", frame_id, ".exr"),
                        np.asarray(depth, np.float32))
        else:
            formats.write_depth_rle(
                self._path("depth_exr", "depth", frame_id, ".depth"),
                np.asarray(depth, np.float32))

    def write_rgb(self, frame_id: int, rgb: np.ndarray) -> None:
        _need_cv2("RGB frames").imwrite(
            self._path("rgb", "rgb", frame_id, ".jpg"), rgb)

    def write_part_mask(self, frame_id: int, mask: np.ndarray) -> None:
        _need_cv2("part masks").imwrite(
            self._path("part_mask", "part_mask", frame_id, ".tiff"),
            np.asarray(mask, np.uint8))

    def write_joints(self, frame_id: int, joints_2d: np.ndarray,
                     joints_xyz: np.ndarray, pos: np.ndarray,
                     shape: np.ndarray, rots_aa: np.ndarray,
                     smpl_params: np.ndarray) -> None:
        """Write the joint_XXXXXXXX.yml label file (smplsynth.cpp:127-165)."""
        cv = _need_cv2("joint labels")
        fs = cv.FileStorage(self._path("joint", "joint", frame_id, ".yml"),
                            cv.FILE_STORAGE_WRITE)
        fs.write("joints", np.round(joints_2d).astype(np.int32))
        fs.write("joints_xyz", np.asarray(joints_xyz, np.float32))
        fs.write("pos", np.asarray(pos, np.float32).reshape(3, 1))
        fs.write("shape", np.asarray(shape, np.float64))
        fs.write("rots", np.asarray(rots_aa, np.float64).reshape(-1))
        fs.write("smpl_params", np.asarray(smpl_params, np.float64))
        fs.release()
