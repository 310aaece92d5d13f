"""Monocular sequence access (Redwood chairs / Freiburg cars layouts).

A copy of dspslam_tpu/datasets/mono.py (host numpy), the reference's
MonoSequence (reconstruct/mono_sequence.py): RGB frames from a directory,
per-frame 2D instance masks, one dominant object per frame (the largest
mask, mono_sequence.py:95), background rays sampled from non-mask pixels
of the expanded box. Mono detections carry no LiDAR: surface evidence
comes later from the object's member map points
(objects/mono_pipeline.py).

The masks come from offline labels or, with `detect_online` (the
reference's factory, reconstruct/__init__.py:1-23), from Mask R-CNN on
the frame: `detect_online_mono` dispatches it, collects its outputs, keeps
the boxes DSP-SLAM's validity filter keeps (class, score, `min_bb_area`,
margins) and builds the largest-mask detection from them.

Two changes from the JAX package: the mask erosion (`cv2.erode` with a
k x k box there) is `erode_box`, numpy code that gives what `cv2.erode`
gives, border included, as the port does not import OpenCV; and the
online path, which the JAX package's MonoSequence lacks.
"""

from __future__ import annotations

import os

import numpy as np

from ..detect import maskrcnn, offline
from ..frontend import undistort
from ..objects.detections import Detection, pixel_rays, sample_background_pixels
from ..utils import io as io_mod
from ..utils import timing


def object_class(data_type: str) -> str:
    """The detector's class of a mono dataset: Redwood's chairs, otherwise
    (Freiburg) cars."""
    return "chairs" if str(data_type).lower() == "redwood" else "cars"


def erode_box(mask: np.ndarray, k: int) -> np.ndarray:
    """Binary erosion of an (H, W) mask by a k x k box, as
    `cv2.erode(mask, np.ones((k, k)))`: the anchor at (k // 2, k // 2), so
    the window spans offsets -(k // 2) .. k - 1 - k // 2, and pixels outside
    the image never erode (OpenCV's default border value for erosion)."""
    a = k // 2
    holes = np.pad((~mask.astype(bool)).astype(np.int32), ((a, k - 1 - a), (a, k - 1 - a)))
    s = np.pad(holes.cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    H, W = mask.shape
    window = s[k:k + H, k:k + W] - s[:H, k:k + W] - s[k:k + H, :W] + s[:H, :W]
    return window == 0


def build_mono_detection(masks_2d: np.ndarray, boxes_2d: np.ndarray, invK: np.ndarray,
                         min_mask_area: float = 1000.0, bg_stride: float = 4.0,
                         max_bg_rays: int = 200, mask_erosion: int = 0, dist_coeffs=None):
    """Largest-mask detection -> Detection with background rays only.

    Background-ray pixels are undistorted before lifting to rays when lens
    coefficients are given (the reference's mono_sequence.py:106-107 runs
    cv2.undistortPoints on the sampled pixels)."""
    if masks_2d is None or len(masks_2d) == 0:
        return None
    areas = masks_2d.reshape(len(masks_2d), -1).sum(axis=-1)
    best = int(np.argmax(areas))
    if areas[best] < min_mask_area:
        return None
    mask = masks_2d[best]
    if mask_erosion > 0:
        mask = erode_box(mask, mask_erosion)
    bbox = np.asarray(boxes_2d[best][:4])
    bg_px = sample_background_pixels(bbox, mask, bg_stride, max_bg_rays)
    if len(bg_px) and undistort.has_distortion(dist_coeffs):
        K = np.linalg.inv(np.asarray(invK, np.float64))
        bg_px = undistort.undistort_points(bg_px.astype(np.float32), K, dist_coeffs)
    return Detection(
        T_cam_obj=np.eye(4, dtype=np.float32), scale=1.0, box_size=np.zeros(3, np.float32),
        surface_points=np.zeros((0, 3), np.float32),
        rays=pixel_rays(bg_px, invK) if len(bg_px) else None,
        depth=np.zeros(0, np.float32), num_foreground=0, mask=mask, bbox=bbox,
    )


def detect_online_mono(detector_2d, image, invK: np.ndarray, det_cfg, dist_coeffs=None) -> list:
    """One keyframe's online detection in a mono sequence (the reference's
    mono_sequence.py get_detections with detect_online): Mask R-CNN
    dispatched on `image` ((H, W, 3) RGB or (H, W) grey, a host array or a
    tensor on the detector's device) and collected, DSP-SLAM's validity
    filter (`maskrcnn.get_valid_detections` at the configured
    `min_bb_area` and the detector's score threshold), then the largest
    valid mask, eroded, with its
    background rays (`build_mono_detection`) -> [Detection], or [] when no
    mask passes."""
    with timing.span("detect_mono"):
        pred = detector_2d.collect(detector_2d.dispatch(image))
        boxes, masks = maskrcnn.get_valid_detections(pred["pred_boxes"], pred["pred_masks"], tuple(image.shape[:2]),
                                                     min_bb_area=det_cfg.min_bb_area,
                                                     min_score=detector_2d.cfg.score_threshold)
        det = build_mono_detection(
            masks, boxes, invK, min_mask_area=det_cfg.min_mask_area, bg_stride=det_cfg.downsample_ratio,
            max_bg_rays=det_cfg.max_bg_rays, mask_erosion=getattr(det_cfg, "mask_erosion", 0),
            dist_coeffs=dist_coeffs,
        )
    return [det] if det is not None else []


class MonoSequence:
    """Frames and detections of a mono sequence. With `detect_online` in
    the detection section, `detector_2d` (`kitti.get_detector_2d`) runs on
    each asked frame's image and no label file is read."""

    def __init__(self, data_dir: str, detection_cfg, K: np.ndarray, dist_coeffs=None, detector_2d=None):
        self.root = data_dir
        self.dist_coeffs = dist_coeffs
        image_0 = os.path.join(data_dir, "image_0")
        self.rgb_dir = image_0 if os.path.isdir(image_0) else data_dir
        self.K = np.asarray(K, np.float32)
        self.invK = np.linalg.inv(self.K).astype(np.float32)
        self.det_cfg = detection_cfg
        self.detector_2d = detector_2d
        self.frames = sorted(f for f in os.listdir(self.rgb_dir) if f.endswith((".png", ".jpg")))

    @property
    def num_frames(self):
        return len(self.frames)

    def load_rgb(self, frame_id: int):
        return io_mod.load_image_rgb(os.path.join(self.rgb_dir, self.frames[frame_id]))

    def load_gray(self, frame_id: int):
        return self.load_rgb(frame_id).astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)

    def get_frame_detections(self, frame_id: int):
        cfg = self.det_cfg
        if getattr(cfg, "detect_online", False):
            if self.detector_2d is None:
                raise ValueError("detect_online mono sequences need a detector_2d (datasets.kitti.get_detector_2d)")
            return detect_online_mono(self.detector_2d, self.load_rgb(frame_id), self.invK, cfg, self.dist_coeffs)
        try:
            boxes_2d, masks_2d = offline.load_labels_2d(cfg.path_label_2d, frame_id)
        except FileNotFoundError:
            return []
        det = build_mono_detection(
            masks_2d, boxes_2d, self.invK, min_mask_area=cfg.min_mask_area,
            bg_stride=cfg.downsample_ratio, max_bg_rays=cfg.max_bg_rays,
            mask_erosion=getattr(cfg, "mask_erosion", 0), dist_coeffs=self.dist_coeffs,
        )
        return [det] if det is not None else []
