"""Face landmark tracking prototype over OpenARK datasets (counterpart of
``avatar_tpu/tools/face_landmark_tracking.py``).  Host-only: numpy, with
OpenCV and dlib where installed; it touches no model and no device, so it
takes no ``--device``.

Rebuild of the reference's standalone ``face_landmark_tracking.py`` (632 LoC
side prototype, not part of its build), keeping its full structure:

  * face detection every frame (reference :215-243 FaceDetectorDNN), with
    detections merged into already-tracked faces by box overlap
    (:470-520 stage 1);
  * 68-point landmark fit reduced to the same 20 trackable points — nose
    (4), left eye (6), right eye (6), mouth (4) (:252-283, ``keep`` list);
  * landmarks grouped into 4 per-feature boxes, each with its own OpenCV
    box tracker (:131-168 make_feature_bbox_from_landmarks, :285-292
    Tracker), re-initialized from fresh landmarks on tracking failure;
  * a per-face state machine INIT -> TRACKED -> LOSE_TRACK(3..5) with
    penalties for failed/escaped feature boxes, dropping the face past
    LOSE_TRACK_MAX (:30-35, :590-620 stage 3);
  * head pose via cv2.solvePnP of the 4 feature-box centers + 2 mouth
    corners against the approximate 6-point 3D face template, plus the
    depth-based forward vector for visualization (:319-377).

Every external capability is gated on availability (the reference hard-
requires dlib + downloaded model files):

  * face detection: OpenCV-DNN caffemodel (--dnn-model/--dnn-config) or
    dlib HOG, else a depth-based heuristic head finder;
  * landmarks: dlib 68-point predictor (--landmark-model);
  * without any models the heuristic single-box path still runs (exercises
    dataset IO and the tracker state machine).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from avatar_tpu_torch.io.dataset import Dataset

# reference state machine constants (:30-37)
STATE_NO_FACE = 0
STATE_INIT = 1
STATE_TRACKED = 2
STATE_LOSE_TRACK_MAX = 5
MIN_FACE_AREA = 500

# approximate 6-point 3D face template, orthographic-ish image units
# (reference model_3D_points, :49-57): nose tip, mouth center, left eye,
# right eye, left mouth corner, right mouth corner
FACE_3D = np.array([
    (0.0, 0.0, 0.0),
    (0.0, -40.0, -30.0),
    (-35.0, 55.0, -40.0),
    (35.0, 55.0, -40.0),
    (-25.0, -35.0, -60.0),
    (25.0, -35.0, -60.0),
], dtype=np.float64)

# the 20 trackable landmarks kept from the 68 (reference ``keep``, :258):
# 4 nose, 6 left eye, 6 right eye, 4 mouth
KEEP_68 = [30, 31, 33, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
           48, 51, 54, 57]
# feature groups over the kept-20 indexing (reference
# make_feature_bbox_from_landmarks, :131-168)
FEATURE_SLICES = {
    "nose": slice(0, 4),
    "left_eye": slice(4, 10),
    "right_eye": slice(10, 16),
    "mouth": slice(16, 20),
}
FEATURE_NAMES = list(FEATURE_SLICES)


def bbox_of_points(pts: np.ndarray, margin: int = 4):
    x0, y0 = pts.min(axis=0)
    x1, y1 = pts.max(axis=0)
    return (int(x0) - margin, int(y0) - margin,
            int(x1 - x0) + 2 * margin, int(y1 - y0) + 2 * margin)


def feature_bboxes(landmarks20: np.ndarray):
    """Grouped per-feature boxes from the kept-20 landmarks."""
    return [bbox_of_points(landmarks20[FEATURE_SLICES[n]])
            for n in FEATURE_NAMES]


def boxes_overlap(a, b) -> int:
    """0 = disjoint; 1/2 = which box is smaller and should be dropped
    (reference boxes_overlap, :380-404: center containment test)."""
    if not a or not b:
        return 0
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    acx, acy = ax + aw / 2, ay + ah / 2
    bcx, bcy = bx + bw / 2, by + bh / 2
    hit = (bx <= acx <= bx + bw and by <= acy <= by + bh) or \
          (ax <= bcx <= ax + aw and ay <= bcy <= ay + ah)
    if not hit:
        return 0
    return 2 if aw * ah > bw * bh else 1


def overlap_fraction(inner, outer) -> float:
    """Intersection area over the smaller box's area (reference
    overlapping_percentage, :181-190; shapely replaced by direct math)."""
    ax, ay, aw, ah = inner
    bx, by, bw, bh = outer
    ix = max(0.0, min(ax + aw, bx + bw) - max(ax, bx))
    iy = max(0.0, min(ay + ah, by + bh) - max(ay, by))
    denom = min(aw * ah, bw * bh)
    return (ix * iy) / denom if denom > 0 else 0.0


# ---------------------------------------------------------------------------
# detectors (capability-gated)
# ---------------------------------------------------------------------------


class FaceDetectorDNN:
    """OpenCV-DNN SSD face detector (reference FaceDetectorDNN, :215-243)."""

    def __init__(self, model: str, config: str, conf: float = 0.8):
        import cv2

        self.net = cv2.dnn.readNetFromCaffe(config, model)
        self.conf = conf

    def detect(self, rgb, depth=None):
        import cv2

        H, W = rgb.shape[:2]
        blob = cv2.dnn.blobFromImage(rgb, 1.0, (300, 300), [104, 117, 123])
        self.net.setInput(blob)
        det = self.net.forward()
        faces = []
        for i in range(det.shape[2]):
            if det[0, 0, i, 2] > self.conf:
                x1, y1, x2, y2 = (det[0, 0, i, 3:7] *
                                  [W, H, W, H]).astype(int)
                faces.append((x1, y1, x2 - x1, y2 - y1))
        return faces


class FaceDetectorDlib:
    """dlib HOG frontal-face detector."""

    def __init__(self):
        import dlib

        self.det = dlib.get_frontal_face_detector()

    def detect(self, rgb, depth=None):
        rects = self.det(rgb, 0)
        return [(r.left(), r.top(), r.width(), r.height()) for r in rects]


class HeuristicHeadDetector:
    """Depth-based head finder: the top of the largest foreground blob
    (model-free fallback; not in the reference, which requires a DNN)."""

    def detect(self, rgb, depth):
        if depth is None:
            return []
        valid = depth[depth > 0]
        if valid.size < 100:
            return []
        near = np.percentile(valid, 30)
        fg = (depth > 0) & (depth < near + 0.8)
        if fg.sum() < 100:
            return []
        ys, xs = np.nonzero(fg)
        top = ys.min()
        band = ys < top + max(4, (ys.max() - top) // 6)
        bx, by = xs[band], ys[band]
        w = max(int(bx.max() - bx.min()), 8)
        return [(int(bx.min()), int(by.min()), w, w)]


class FacemarkDetectorDlib:
    """dlib 68-point landmark fit reduced to the kept 20 (reference
    FacemarkDetectorDlib, :266-283)."""

    def __init__(self, model_path: str):
        import dlib

        self.predictor = dlib.shape_predictor(model_path)

    def detect(self, rgb, bbox):
        import dlib

        if not bbox:
            return None
        x, y, w, h = bbox
        shape = self.predictor(rgb, dlib.rectangle(x, y, x + w, y + h))
        pts = np.array([[p.x, p.y] for p in shape.parts()], np.float64)
        return pts[KEEP_68]


def make_box_tracker(rgb, bbox):
    """Single-feature OpenCV box tracker (reference Tracker, :285-292 picks
    KCF; fall back through available implementations)."""
    import cv2

    for maker in ("TrackerKCF_create", "TrackerMOSSE_create",
                  "TrackerCSRT_create"):
        fn = getattr(cv2, maker, None) or getattr(
            getattr(cv2, "legacy", cv2), maker, None)
        if fn is None:
            continue
        try:
            t = fn()
            t.init(rgb, tuple(int(v) for v in bbox))
            return t
        except Exception:
            continue
    return None


class TrackedFace:
    """One face: 4 per-feature box trackers + state machine."""

    def __init__(self, face_box, landmarks20, rgb):
        self.face_box = face_box
        self.state = STATE_INIT
        self.landmarks = landmarks20
        self.bboxes = feature_bboxes(landmarks20)
        self.trackers = [make_box_tracker(rgb, b) for b in self.bboxes]
        self.pose = None

    def update(self, rgb, fresh_landmarks):
        """Stage-3 update (reference :560-620): advance each feature
        tracker; failed or escaped boxes add a lose-track penalty and are
        re-seeded from the freshly detected landmarks."""
        penalty = 0
        new_boxes = []
        for i, name in enumerate(FEATURE_NAMES):
            t = self.trackers[i]
            ok, box = (t.update(rgb) if t is not None else (False, None))
            if not ok:
                penalty = 1
                if fresh_landmarks is not None:
                    box = bbox_of_points(fresh_landmarks[FEATURE_SLICES[name]])
                    self.trackers[i] = make_box_tracker(rgb, box)
                else:
                    box = self.bboxes[i]
            else:
                box = tuple(int(v) for v in box)
                if overlap_fraction(box, self.face_box) < 0.99:
                    penalty = 1  # feature escaped the face region
            new_boxes.append(box)
        self.bboxes = new_boxes
        if fresh_landmarks is not None:
            self.landmarks = fresh_landmarks
        if penalty:
            self.state = max(self.state, STATE_TRACKED) + penalty
        else:
            self.state = STATE_TRACKED
        return self.state <= STATE_LOSE_TRACK_MAX

    def head_pose(self, intrin, xyz=None):
        """solvePnP of feature-box centers + mouth corners against the
        6-point template (reference facial_orientation, :319-377)."""
        import cv2

        if self.landmarks is None:
            return None
        b = self.bboxes
        centers = [(bb[0] + bb[2] / 2, bb[1] + bb[3] / 2) for bb in b]
        img_pts = np.array([
            centers[0],                 # nose box center
            centers[3],                 # mouth box center
            centers[1],                 # left eye box center
            centers[2],                 # right eye box center
            self.landmarks[16],         # left mouth corner
            self.landmarks[18],         # right mouth corner
        ], np.float64)
        K = np.array([[intrin.fx, 0, intrin.cx],
                      [0, intrin.fy, intrin.cy], [0, 0, 1.0]])
        ok, rvec, tvec = cv2.solvePnP(FACE_3D, img_pts, K, np.zeros(4),
                                      flags=cv2.SOLVEPNP_ITERATIVE)
        if not ok:
            return None
        self.pose = np.concatenate([rvec.ravel(), tvec.ravel()])
        return self.pose


class Pipeline:
    """Detector/landmark pipeline with capability gating."""

    def __init__(self, args):
        self.face_detector = None
        if args.dnn_model and os.path.exists(args.dnn_model):
            try:
                self.face_detector = FaceDetectorDNN(args.dnn_model,
                                                     args.dnn_config)
            except Exception as e:  # pragma: no cover
                print(f"[face] DNN detector unavailable: {e}",
                      file=sys.stderr)
        if self.face_detector is None:
            try:
                self.face_detector = FaceDetectorDlib()
            except ImportError:
                self.face_detector = HeuristicHeadDetector()
        self.facemark = None
        if args.landmark_model:
            try:
                self.facemark = FacemarkDetectorDlib(args.landmark_model)
            except ImportError:
                print("[face] dlib unavailable; landmarks disabled",
                      file=sys.stderr)

    def detect_faces(self, rgb, depth):
        faces = list(self.face_detector.detect(rgb, depth))
        # drop tiny faces and overlapping smaller faces (stage 1, :470-500)
        for i in range(len(faces)):
            if faces[i] and faces[i][2] * faces[i][3] < MIN_FACE_AREA:
                faces[i] = None
            for j in range(i):
                w = boxes_overlap(faces[i], faces[j])
                if w == 1:
                    faces[i] = None
                elif w == 2:
                    faces[j] = None
        return [f for f in faces if f]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset_path")
    ap.add_argument("-i", "--start", type=int, default=1)
    ap.add_argument("-p", "--pad", type=int, default=4)
    ap.add_argument("--landmark-model", default="",
                    help="dlib 68-point shape predictor .dat (optional)")
    ap.add_argument("--dnn-model", default="",
                    help="OpenCV-DNN caffemodel for face detection")
    ap.add_argument("--dnn-config", default="deploy.prototxt")
    ap.add_argument("--max-frames", type=int, default=0)
    args = ap.parse_args(argv)

    ds = Dataset(args.dataset_path, pad=args.pad)
    pipe = Pipeline(args)
    tracked: list = []

    n = 0
    for fid in ds.frames(start=args.start):
        depth = ds.depth(fid)
        if depth.ndim == 3:
            depth = depth[..., 2]
        rgb = ds.rgb(fid)
        vis = rgb if rgb is not None else np.stack(
            [(np.clip(depth / 4.0, 0, 1) * 255).astype(np.uint8)] * 3, -1)

        # stage 1: detect + merge into tracked faces
        faces = pipe.detect_faces(vis, depth)
        fresh = []
        for f in faces:
            merged = False
            for tf in tracked:
                if boxes_overlap(f, tf.face_box):
                    tf.face_box = f
                    merged = True
                    break
            if not merged:
                fresh.append(f)

        # stage 2: initialize new per-feature trackers
        for f in fresh:
            if pipe.facemark is not None:
                lm = pipe.facemark.detect(vis, f)
                if lm is None:
                    continue
            else:
                # no landmark model: synthesize a nose/eyes/mouth layout
                # from the face box so the tracker machinery still runs
                x, y, w, h = f
                g = np.array([[x + w * fx, y + h * fy] for fx, fy in [
                    (0.5, 0.55), (0.45, 0.6), (0.5, 0.62), (0.55, 0.6),
                    (0.3, 0.4), (0.33, 0.38), (0.37, 0.38), (0.4, 0.4),
                    (0.37, 0.42), (0.33, 0.42),
                    (0.6, 0.4), (0.63, 0.38), (0.67, 0.38), (0.7, 0.4),
                    (0.67, 0.42), (0.63, 0.42),
                    (0.35, 0.78), (0.5, 0.75), (0.65, 0.78), (0.5, 0.85),
                ]], np.float64)
                lm = g
            tracked.append(TrackedFace(f, lm, vis))

        # stage 3: advance existing trackers
        still = []
        for tf in tracked:
            if tf.state == STATE_INIT:
                tf.state = STATE_TRACKED
                still.append(tf)
                continue
            fresh_lm = (pipe.facemark.detect(vis, tf.face_box)
                        if pipe.facemark is not None else None)
            if tf.update(vis, fresh_lm):
                still.append(tf)
        tracked = still

        for k, tf in enumerate(tracked):
            pose = tf.head_pose(ds.intrin)
            boxes = " ".join(f"{nm}={bb}" for nm, bb in
                             zip(FEATURE_NAMES, tf.bboxes))
            ps = (" pose=" + str(np.round(pose, 2))
                  if pose is not None else "")
            print(f"frame {fid} face {k}: state={tf.state} {boxes}{ps}")
        if not tracked:
            print(f"frame {fid}: no face")
        n += 1
        if args.max_frames and n >= args.max_frames:
            break


if __name__ == "__main__":
    main()
