"""Monocular sequence access (Redwood chairs / Freiburg cars layouts).

A copy of dspslam_tpu/datasets/mono.py (host numpy), the reference's
MonoSequence (reconstruct/mono_sequence.py): RGB frames from a directory,
per-frame 2D instance masks from offline labels, one dominant object per
frame (the largest mask, mono_sequence.py:95), background rays sampled
from non-mask pixels of the expanded box. Mono detections carry no LiDAR:
surface evidence comes later from the object's member map points
(objects/mono_pipeline.py).

One change: the mask erosion (`cv2.erode` with a k x k box in the JAX
package) is `erode_box`, numpy code that gives what `cv2.erode` gives,
border included; the port does not import OpenCV.
"""

from __future__ import annotations

import os

import numpy as np

from ..detect import offline
from ..frontend import undistort
from ..objects.detections import Detection, pixel_rays, sample_background_pixels
from ..utils import io as io_mod


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


class MonoSequence:
    def __init__(self, data_dir: str, detection_cfg, K: np.ndarray, dist_coeffs=None):
        self.root = data_dir
        self.dist_coeffs = dist_coeffs
        image_0 = os.path.join(data_dir, "image_0")
        self.rgb_dir = image_0 if os.path.isdir(image_0) else data_dir
        self.K = np.asarray(K, np.float32)
        self.invK = np.linalg.inv(self.K).astype(np.float32)
        self.det_cfg = detection_cfg
        self.frames = sorted(f for f in os.listdir(self.rgb_dir) if f.endswith((".png", ".jpg")))

    @property
    def num_frames(self):
        return len(self.frames)

    def load_gray(self, frame_id: int):
        img = io_mod.load_image_rgb(os.path.join(self.rgb_dir, self.frames[frame_id])).astype(np.float32)
        return img @ np.array([0.299, 0.587, 0.114], np.float32)

    def get_frame_detections(self, frame_id: int):
        cfg = self.det_cfg
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
