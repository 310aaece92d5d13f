"""KITTI odometry sequence access: stereo images + velodyne + detections.

Port of dspslam_tpu/datasets/kitti.py: the reference's KITIISequence
(reconstruct/kitti_sequence.py:219-273) and the dsp_slam.cc image loading
loop: calibration from calib.txt, stereo pairs from image_2/image_3, raw
velodyne scans, timestamps from times.txt, and per-frame object
measurements built through objects.detections.build_frame_detections from
the online detectors (MaskRCNN and PointPillars on the sequence's device)
or from offline labels.
"""

from __future__ import annotations

import os

import numpy as np

from ..detect import maskrcnn, offline, pointpillars
from ..objects import detections as det_mod
from ..utils import io as io_mod
from ..utils import timing


def _settings(cls, block):
    """A frozen detector config from a block of its fields (lists as tuples)."""
    block = block or {}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in block.items()})


def detector_configs(det_cfg):
    """(MaskRCNNConfig, PointPillarsConfig) of the detection section's
    `detector_2d` / `detector_3d` blocks; each config's defaults where its
    block is absent."""
    return (_settings(maskrcnn.MaskRCNNConfig, getattr(det_cfg, "detector_2d", None)),
            _settings(pointpillars.PointPillarsConfig, getattr(det_cfg, "detector_3d", None)))


def get_detector_2d(det_cfg, object_class: str = "cars", device=None):
    """The online Mask R-CNN alone (reference reconstruct/__init__.py:1-13
    for the mono sequences, which run no LiDAR): `Detector2D` on `device`
    (None means cuda) keeping `object_class`'s labels, or None for offline
    labels. Its settings are the configured `detector_2d` block; a
    configured weight path that exists is ingested from the reference's
    mmdet checkpoint, otherwise the network carries seeded random
    weights."""
    if det_cfg is None or not getattr(det_cfg, "detect_online", False):
        return None
    cfg_2d, _ = detector_configs(det_cfg)
    w2d = getattr(det_cfg, "weight_path_2d", None)
    params_2d = maskrcnn.load_mmdet_checkpoint(w2d, cfg_2d) if w2d and os.path.exists(w2d) else None
    return maskrcnn.Detector2D(params=params_2d, cfg=cfg_2d, object_class=object_class, device=device)


def get_detectors(det_cfg, object_class: str = "cars", device=None):
    """Online-detector factory (reference reconstruct/__init__.py:1-13):
    (detector_2d, detector_3d) on `device` (None means cuda), or (None,
    None) for offline labels. Mask R-CNN comes from `get_detector_2d`;
    PointPillars takes the configured `detector_3d` block and, where its
    configured weight path exists, the reference's mmdet3d checkpoint,
    otherwise seeded random weights."""
    det2d = get_detector_2d(det_cfg, object_class, device)
    if det2d is None:
        return None, None
    _, cfg_3d = detector_configs(det_cfg)
    w3d = getattr(det_cfg, "weight_path_3d", None)
    params_3d = (pointpillars.load_mmdet3d_checkpoint(w3d, cfg_3d)
                 if w3d and os.path.exists(w3d) else None)
    det3d = pointpillars.Detector3D(params=params_3d, cfg=cfg_3d, device=device)
    return det2d, det3d


def detect_online(detector_2d, detector_3d, image, velo):
    """One keyframe's online detection (kitti_sequence.py's
    FrameWithLiDAR.get_detections with detect_online): PointPillars on the
    scan and Mask R-CNN on the image, both dispatched before either is
    collected -> (boxes_3d (K, 7), boxes_2d (M, 5), masks_2d (M, H, W)).
    `image` is (H, W, 3) RGB or (H, W) grey, a host array or a tensor on
    the detector's device; `velo` the (N, 4) scan on the host."""
    with timing.span("detect"):
        h3d = detector_3d.dispatch(velo)
        h2d = detector_2d.dispatch(image)
        with timing.span("det_collect"):
            boxes_3d = detector_3d.collect(h3d)
            pred = detector_2d.collect(h2d)
    return boxes_3d, pred["pred_boxes"], pred["pred_masks"]


class KITTISequence:
    def __init__(self, data_dir: str, detection_cfg=None, device=None):
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
        self.detector_2d, self.detector_3d = get_detectors(detection_cfg, device=device)

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
        """Per-frame object measurements (kitti_sequence.py's
        FrameWithLiDAR.get_detections): both online detectors
        (`detect_online`) when configured; otherwise cached-label
        playback."""
        cfg = self.det_cfg
        velo = self.load_velodyne(frame_id)
        if self.detector_3d is not None:
            img = io_mod.load_image_rgb(os.path.join(self.rgb_dir, f"{frame_id:06d}.png"))
            boxes_3d, boxes_2d, masks_2d = detect_online(self.detector_2d, self.detector_3d, img, velo)
        else:
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
