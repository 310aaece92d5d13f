"""KITTI odometry sequence access: stereo images + velodyne + detections.

A copy of dspslam_tpu/datasets/kitti.py with offline labels only: the
reference's KITIISequence (reconstruct/kitti_sequence.py:219-273) and the
dsp_slam.cc image loading loop:
calibration from calib.txt, stereo pairs from image_2/image_3, raw
velodyne scans, timestamps from times.txt, and per-frame object
measurements built from offline labels through
objects.detections.build_frame_detections.
"""

from __future__ import annotations

import os

import numpy as np

from ..detect import offline
from ..objects import detections as det_mod
from ..utils import io as io_mod


def get_detectors(det_cfg, object_class: str = "cars"):
    """Online-detector factory (reference reconstruct/__init__.py:1-13):
    (None, None) for offline labels. The online detectors (MaskRCNN and
    PointPillars) come with slice 6 and are not ported."""
    if det_cfg is None or not getattr(det_cfg, "detect_online", False):
        return None, None
    raise NotImplementedError(
        "online detection (detect_online: MaskRCNN + PointPillars) comes with slice 6 "
        "and is not ported; use offline labels (path_label_2d / path_label_3d)")


class KITTISequence:
    def __init__(self, data_dir: str, detection_cfg=None):
        self.root = data_dir
        self.rgb_dir = os.path.join(data_dir, "image_2")
        self.rgb_right_dir = os.path.join(data_dir, "image_3")
        self.velo_dir = os.path.join(data_dir, "velodyne")
        calib = io_mod.read_kitti_calib(os.path.join(data_dir, "calib.txt"))
        self.K, self.T_cam_velo = io_mod.kitti_cam2_calibration(calib)
        self.invK = np.linalg.inv(self.K).astype(np.float32)
        self.det_cfg = detection_cfg
        times_path = os.path.join(data_dir, "times.txt")
        self.timestamps = (
            np.loadtxt(times_path) if os.path.exists(times_path) else None
        )
        frames = [
            f for f in os.listdir(self.rgb_dir) if f.endswith(".png")
        ] if os.path.isdir(self.rgb_dir) else []
        self.num_frames = len(frames)
        get_detectors(detection_cfg)     # raises for online detection

    def timestamp(self, frame_id: int) -> float:
        if self.timestamps is not None and frame_id < len(self.timestamps):
            return float(self.timestamps[frame_id])
        return frame_id / 10.0

    def load_stereo_gray(self, frame_id: int):
        """(left, right) float32 grayscale images."""
        def gray(path):
            img = io_mod.load_image_rgb(path).astype(np.float32)
            return img @ np.array([0.299, 0.587, 0.114], np.float32)

        l = gray(os.path.join(self.rgb_dir, f"{frame_id:06d}.png"))
        r = gray(os.path.join(self.rgb_right_dir, f"{frame_id:06d}.png"))
        return l, r

    def load_velodyne(self, frame_id: int):
        return io_mod.load_velodyne(
            os.path.join(self.velo_dir, f"{frame_id:06d}.bin")
        )

    def get_frame_detections(self, frame_id: int, image_hw):
        """Per-frame object measurements from cached labels
        (kitti_sequence.py's FrameWithLiDAR.get_detections)."""
        cfg = self.det_cfg
        velo = self.load_velodyne(frame_id)
        boxes_3d = offline.load_labels_3d(cfg.path_label_3d, frame_id)
        boxes_2d, masks_2d = offline.load_labels_2d(cfg.path_label_2d, frame_id)
        return det_mod.build_frame_detections(
            boxes_3d, masks_2d, boxes_2d, velo, self.K, self.invK,
            self.T_cam_velo, image_hw,
            max_lidar_points=cfg.num_lidar_max,
            min_mask_area=cfg.min_mask_area,
            bg_stride=cfg.downsample_ratio,
            max_bg_rays=cfg.max_bg_rays,
        )
