"""Depth camera abstraction: threaded capture with double buffering
(counterpart of ``avatar_tpu/io/camera.py``).

Rebuild of reference DepthCamera (DepthCamera.h:19-336, DepthCamera.cpp):
a producer thread polls the backend at a capped FPS, writes into a back
buffer and swaps under a lock; consumers read the front buffer.  Backends:

  * AzureKinectCamera — Azure Kinect via pyk4a when installed (the
    environment gates on import, like the reference's WITH_K4A build flag;
    AzureKinectCamera.cpp)
  * Freenect2Camera — Kinect v2 via pylibfreenect2 when installed
    (Freenect2Camera.cpp)
  * DatasetCamera — plays back a recorded OpenARK dataset directory (the
    offline-demo input path, demo.cpp:153-170)
  * SyntheticCamera — renders a moving synthetic avatar on a torch device
    (the card unless asked for the CPU), for demos and tests without
    hardware or data

Frame contract matches the reference: an XYZ map [H, W, 3] float32 (z == 0
invalid) plus an optional RGB image; ``noise_removal`` zeroes points closer
than 0.1 m (DepthCamera.cpp:103-118).  Unlike the reference, an exception
raised in the capture thread is kept and raised again from the consumer
calls (``get_frame``, ``get_xyz_map``, ``get_rgb_map``): a consumer
waiting for the next frame of a dead thread would otherwise wait forever.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np

import torch

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.io.calibration import CameraIntrin
from avatar_tpu_torch.io.dataset import Dataset


class DepthCamera:
    """Abstract camera with a capture thread and double buffering."""

    def __init__(self, fps_cap: float = 30.0):
        self.fps_cap = fps_cap
        self._lock = threading.Lock()
        self._front: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.bad_input = False
        self.frame_id = 0
        self._callbacks = []
        self._error: Optional[BaseException] = None

    # -- backend interface ----------------------------------------------------

    def next_frame(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Produce (xyz_map, rgb) or (None, None) on failure."""
        raise NotImplementedError

    def intrinsics(self) -> CameraIntrin:
        raise NotImplementedError

    def image_size(self) -> Tuple[int, int]:
        raise NotImplementedError

    # -- capture loop (DepthCamera.cpp:24-95) ----------------------------------

    def begin_capture(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    beginCapture = begin_capture

    def end_capture(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    endCapture = end_capture

    def add_update_callback(self, fn) -> None:
        self._callbacks.append(fn)

    def _loop(self) -> None:
        try:
            self._capture()
        except Exception as e:      # kept for the consumer, see get_frame
            self._error = e
            self._running = False

    def _capture(self) -> None:
        min_dt = 1.0 / self.fps_cap if self.fps_cap > 0 else 0.0
        while self._running:
            t0 = time.perf_counter()
            xyz, rgb = self.next_frame()
            if xyz is None:
                self.bad_input = True
                time.sleep(0.005)
                continue
            self.bad_input = False
            xyz = self._noise_removal(xyz)
            with self._lock:
                self._front = (xyz, rgb)
                self.frame_id += 1
            for fn in self._callbacks:
                fn(self)
            dt = time.perf_counter() - t0
            if min_dt > dt:
                time.sleep(min_dt - dt)

    def _raise_capture_error(self) -> None:
        if self._error is not None:
            raise RuntimeError(f"{type(self).__name__}'s capture thread "
                               f"failed: {self._error!r}") from self._error

    @staticmethod
    def _noise_removal(xyz: np.ndarray) -> np.ndarray:
        """Zero out points closer than 0.1 m (DepthCamera.cpp:103-118)."""
        bad = (xyz[..., 2] < 0.1) & (xyz[..., 2] != 0.0)
        if bad.any():
            xyz = xyz.copy()
            xyz[bad] = 0.0
        return xyz

    # -- consumer API -----------------------------------------------------------

    def get_xyz_map(self) -> Optional[np.ndarray]:
        self._raise_capture_error()
        with self._lock:
            return None if self._front is None else self._front[0]

    getXYZMap = get_xyz_map

    def get_rgb_map(self) -> Optional[np.ndarray]:
        self._raise_capture_error()
        with self._lock:
            return None if self._front is None else self._front[1]

    getRGBMap = get_rgb_map

    def get_frame(self):
        """((xyz, rgb) or None, frame counter); raises if the capture
        thread died."""
        self._raise_capture_error()
        with self._lock:
            return self._front, self.frame_id


class DatasetCamera(DepthCamera):
    """Plays a recorded OpenARK dataset as a camera (loops by default)."""

    def __init__(self, root: str, pad: int = 4, fps_cap: float = 30.0,
                 loop: bool = True, start: int = 1):
        super().__init__(fps_cap)
        self.dataset = Dataset(root, pad=pad)
        self.loop = loop
        self._next = start
        self._start = start
        first = self.dataset.xyz(start)
        self._size = first.shape[:2]

    def intrinsics(self) -> CameraIntrin:
        return self.dataset.intrin

    def image_size(self):
        return self._size

    def next_frame(self):
        if not self.dataset.has_frame(self._next):
            if not self.loop or self._next == self._start:
                return None, None
            self._next = self._start
        xyz = self.dataset.xyz(self._next)
        rgb = self.dataset.rgb(self._next)
        self._next += 1
        return np.asarray(xyz, np.float32), rgb


class SyntheticCamera(DepthCamera):
    """Renders a smoothly moving synthetic avatar (no hardware needed) on
    ``device``, where it builds its detail-2 model unless given ``model``
    (which then sets the device)."""

    def __init__(self, model=None, intrin: Optional[CameraIntrin] = None,
                 image_size=(360, 640), fps_cap: float = 30.0,
                 seed: int = 7, wall_depth: float = 4.0,
                 device: str | torch.device = "cuda"):
        super().__init__(fps_cap)
        from avatar_tpu_torch.core.model import Avatar
        from avatar_tpu_torch.testing import synthetic_model

        self.model = model or synthetic_model(detail=2, device=device)
        H, W = image_size
        self.intrin = intrin or CameraIntrin(
            fx=0.9 * W / 2, fy=0.9 * W / 2, cx=W / 2, cy=H / 2)
        self._size = (H, W)
        self.wall_depth = wall_depth
        self._rng = np.random.default_rng(seed)
        self.gt = Avatar(self.model)
        self.gt.randomize(seed=seed)
        self.gt.w *= 0.3
        self.gt.p = np.array([0.0, 0.1, 2.6])
        self.gt.r[0] = np.diag([-1.0, 1.0, -1.0])
        self._drift = self._rng.normal(0, 0.015, (self.model.num_joints(), 3))
        # the per-frame drift rotation, in float32 as the reference
        # evaluates it; host state, so on the CPU
        self._step = rotation.so3_exp(torch.as_tensor(
            self._drift, dtype=torch.float32)).numpy()

    def intrinsics(self) -> CameraIntrin:
        return self.intrin

    def image_size(self):
        return self._size

    def next_frame(self):
        from avatar_tpu_torch.render.renderer import AvatarRenderer

        self.gt.update()
        rend = AvatarRenderer(self.gt, self.intrin)
        depth = rend.render_depth(self._size)
        rgb = np.stack([rend.render_lambert(self._size)] * 3, -1)
        self.gt.r = np.einsum("jab,jbc->jac", self._step, self.gt.r)
        self.gt.p = self.gt.p + self._rng.normal(0, 0.005, 3)
        d = np.where(depth > 0, depth, np.float32(self.wall_depth))
        return self.intrin.depth_to_xyz_np(d).astype(np.float32), rgb


def open_camera(spec: str, device: str | torch.device = "cuda",
                **kwargs) -> DepthCamera:
    """Open a camera by spec: 'k4a', 'freenect2', 'synthetic', or a dataset
    directory path.  ``device`` is where the synthetic camera renders; the
    others produce host frames."""
    if spec == "k4a":
        return AzureKinectCamera(**kwargs)
    if spec == "freenect2":
        return Freenect2Camera(**kwargs)
    if spec == "synthetic":
        return SyntheticCamera(device=device, **kwargs)
    return DatasetCamera(spec, **kwargs)


class AzureKinectCamera(DepthCamera):
    """Azure Kinect backend via pyk4a (reference AzureKinectCamera.cpp:
    NFOV-unbinned depth at 30 fps, depth aligned into the color camera)."""

    def __init__(self, fps_cap: float = 30.0):
        super().__init__(fps_cap)
        try:
            import pyk4a  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "pyk4a is not installed; Azure Kinect capture unavailable "
                "(the reference gates this behind WITH_K4A the same way)"
            ) from e
        from pyk4a import Config, PyK4A

        self._k4a = PyK4A(Config())
        self._k4a.start()
        calib = self._k4a.calibration
        cm = calib.get_camera_matrix(1)  # color camera
        self._intrin = CameraIntrin(fx=float(cm[0, 0]), fy=float(cm[1, 1]),
                                    cx=float(cm[0, 2]), cy=float(cm[1, 2]))

    def intrinsics(self):
        return self._intrin

    def image_size(self):
        return (720, 1280)

    def next_frame(self):
        cap = self._k4a.get_capture()
        if cap.transformed_depth is None:
            return None, None
        depth = cap.transformed_depth.astype(np.float32) * 1e-3
        xyz = self._intrin.depth_to_xyz_np(depth).astype(np.float32)
        rgb = cap.color[..., :3] if cap.color is not None else None
        return xyz, rgb


class Freenect2Camera(DepthCamera):
    """Kinect v2 backend via pylibfreenect2.

    Mirrors reference Freenect2Camera.cpp:33-200: enumerate devices, pick
    the best available packet pipeline (the reference tries CUDA -> OpenCL
    -> OpenGL -> CPU; pylibfreenect2 exposes the same classes), listen to
    synchronized depth (512x424) + color (1920x1080) streams, undistort and
    register via libfreenect2's Registration, and back-project the
    undistorted depth through the IR camera intrinsics into an XYZ map (the
    same pinhole math Registration::getPointXYZ applies).
    """

    DEPTH_W, DEPTH_H = 512, 424

    def __init__(self, fps_cap: float = 30.0, serial: Optional[str] = None):
        super().__init__(fps_cap)
        try:
            import pylibfreenect2  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "pylibfreenect2 is not installed; Kinect v2 capture "
                "unavailable (reference gates behind WITH_FREENECT2)") from e
        from pylibfreenect2 import (Freenect2, FrameType,
                                    SyncMultiFrameListener)
        from pylibfreenect2 import Frame as F2Frame

        self._fn = Freenect2()
        if self._fn.enumerateDevices() == 0:
            raise RuntimeError("no Kinect v2 device connected")
        serial = serial or self._fn.getDeviceSerialNumber(0)
        self._device = self._fn.openDevice(serial,
                                           pipeline=self._make_pipeline())
        self._listener = SyncMultiFrameListener(
            FrameType.Color | FrameType.Depth)
        self._device.setColorFrameListener(self._listener)
        self._device.setIrAndDepthFrameListener(self._listener)
        self._device.start()

        from pylibfreenect2 import Registration

        ir = self._device.getIrCameraParams()
        self._registration = Registration(
            ir, self._device.getColorCameraParams())
        self._intrin = CameraIntrin(fx=float(ir.fx), fy=float(ir.fy),
                                    cx=float(ir.cx), cy=float(ir.cy))
        self._undistorted = F2Frame(self.DEPTH_W, self.DEPTH_H, 4)
        self._registered = F2Frame(self.DEPTH_W, self.DEPTH_H, 4)

    @staticmethod
    def _make_pipeline():
        """Best available packet pipeline, in the reference's preference
        order (Freenect2Camera.cpp:33-47)."""
        import pylibfreenect2 as f2

        for name in ("CudaPacketPipeline", "OpenCLPacketPipeline",
                     "OpenGLPacketPipeline", "CpuPacketPipeline"):
            cls = getattr(f2, name, None)
            if cls is None:
                continue
            try:
                return cls()
            except Exception:
                continue
        return None

    def intrinsics(self) -> CameraIntrin:
        return self._intrin

    def image_size(self):
        return (self.DEPTH_H, self.DEPTH_W)

    def next_frame(self):
        frames = self._listener.waitForNewFrame(milliseconds=1000)
        if frames is None:
            return None, None
        try:
            self._registration.apply(frames["color"], frames["depth"],
                                     self._undistorted, self._registered)
            depth = self._undistorted.asarray(np.float32).reshape(
                self.DEPTH_H, self.DEPTH_W) * 1e-3  # mm -> m
            xyz = self._intrin.depth_to_xyz_np(depth).astype(np.float32)
            # registered color is BGRX at depth resolution
            reg = self._registered.asarray(np.uint8).reshape(
                self.DEPTH_H, self.DEPTH_W, 4)
            rgb = reg[..., :3].copy()
        finally:
            self._listener.release(frames)
        return xyz, rgb

    def end_capture(self) -> None:
        super().end_capture()
        if getattr(self, "_device", None) is not None:
            self._device.stop()
            self._device.close()
            self._device = None
