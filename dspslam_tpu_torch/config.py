"""Structured configuration for the whole framework.

One dataclass tree replaces the reference's three config tiers (SURVEY.md
§5): per-sequence OpenCV YAML (camera/ORB/viewer), per-dataset JSON
(detectors, DeepSDF dir, optimizer hyperparameters — configs/
config_kitti.json), and mmcv detector python configs. JSON files written
for the reference load directly via `SystemConfig.from_reference_json`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from .shape.gn import GNConfig


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float = 707.0912
    fy: float = 707.0912
    cx: float = 601.8873
    cy: float = 183.1104
    width: int = 1241
    height: int = 376
    fps: float = 10.0
    baseline_fx: float = 379.8145  # stereo baseline times fx ("Camera.bf")
    depth_threshold: float = 35.0  # close/far point threshold ("ThDepth")
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @property
    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32
        )


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    cell_size: int = 30


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Detector + measurement preprocessing caps (config_kitti.json)."""

    detect_online: bool = False
    path_label_2d: Optional[str] = None
    path_label_3d: Optional[str] = None
    weight_path_2d: Optional[str] = None
    weight_path_3d: Optional[str] = None
    min_bb_area: float = 1600.0
    min_mask_area: float = 1000.0
    downsample_ratio: float = 4.0
    num_lidar_max: int = 250
    num_lidar_min: int = 10
    max_bg_rays: int = 200
    # mono mask shrink in pixels ("Objects.maskErrosion": boundary pixels
    # of instance masks are unreliable; reference erodes before ray
    # sampling — redwood 5, freiburg 10)
    mask_erosion: int = 0
    # static padding caps of the batched device pipeline
    max_detections: int = 8
    max_surface_points: int = 256
    max_rays: int = 512
    # the online detectors' settings (detect_online): MaskRCNNConfig and
    # PointPillarsConfig fields by name; None keeps their defaults
    detector_2d: Optional[dict] = dataclasses.field(default=None, hash=False)
    detector_3d: Optional[dict] = dataclasses.field(default=None, hash=False)


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    data_type: str = "KITTI"
    sensor: str = "stereo_lidar"  # mono | stereo | stereo_lidar | rgbd
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    detection: DetectionConfig = dataclasses.field(default_factory=DetectionConfig)
    optimizer: GNConfig = dataclasses.field(default_factory=GNConfig)
    deepsdf_dir: Optional[str] = None
    voxels_dim: int = 32

    # ------------------------------------------------------------------
    # native format: the WHOLE tree in one JSON file (the reference needs
    # a per-sequence OpenCV YAML + a dataset JSON + mmcv python configs)
    def to_json(self, path: str | None = None) -> str:
        d = dataclasses.asdict(self)
        # the detectors' blocks only where set (None is the networks'
        # defaults): a file without them stays readable by the JAX package
        for key in ("detector_2d", "detector_3d"):
            if d["detection"][key] is None:
                del d["detection"][key]
        s = json.dumps(d, indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @staticmethod
    def load(path: str) -> "SystemConfig":
        """Sniffing loader: native configs (configs/*.json, a "camera"
        section) or the reference dataset-JSON format."""
        with open(path) as f:
            d = json.load(f)
        if "camera" in d:
            return SystemConfig.from_json(path)
        return SystemConfig.from_reference_json(path)

    @staticmethod
    def from_json(path: str) -> "SystemConfig":
        with open(path) as f:
            d = json.load(f)
        return SystemConfig(
            data_type=d.get("data_type", "KITTI"),
            sensor=d.get("sensor", "stereo_lidar"),
            camera=CameraConfig(**d.get("camera", {})),
            orb=ORBConfig(**d.get("orb", {})),
            detection=DetectionConfig(**d.get("detection", {})),
            optimizer=GNConfig(**d.get("optimizer", {})),
            deepsdf_dir=d.get("deepsdf_dir"),
            voxels_dim=d.get("voxels_dim", 32),
        )

    @staticmethod
    def from_reference_yaml(path: str, base: "SystemConfig" = None) -> "SystemConfig":
        """Load a reference per-sequence OpenCV YAML (camera + ORB + viewer
        settings, e.g. configs/KITTI04-12.yaml). The '%YAML:1.0' directive
        and OpenCV-specific tags are stripped before parsing."""
        import yaml

        with open(path) as f:
            text = f.read()
        lines = [
            l for l in text.splitlines()
            if not l.startswith("%YAML") and "!!opencv" not in l
        ]
        data = yaml.safe_load("\n".join(lines)) or {}
        base = base or SystemConfig()
        cam = CameraConfig(
            fx=data.get("Camera.fx", base.camera.fx),
            fy=data.get("Camera.fy", base.camera.fy),
            cx=data.get("Camera.cx", base.camera.cx),
            cy=data.get("Camera.cy", base.camera.cy),
            width=int(data.get("Camera.width", base.camera.width)),
            height=int(data.get("Camera.height", base.camera.height)),
            fps=data.get("Camera.fps", base.camera.fps),
            baseline_fx=data.get("Camera.bf", base.camera.baseline_fx),
            depth_threshold=data.get("ThDepth", base.camera.depth_threshold),
            k1=data.get("Camera.k1", 0.0),
            k2=data.get("Camera.k2", 0.0),
            p1=data.get("Camera.p1", 0.0),
            p2=data.get("Camera.p2", 0.0),
            k3=data.get("Camera.k3", 0.0),
        )
        orb = ORBConfig(
            n_features=int(data.get("ORBextractor.nFeatures", base.orb.n_features)),
            scale_factor=data.get("ORBextractor.scaleFactor", base.orb.scale_factor),
            n_levels=int(data.get("ORBextractor.nLevels", base.orb.n_levels)),
            ini_th_fast=int(data.get("ORBextractor.iniThFAST", base.orb.ini_th_fast)),
            min_th_fast=int(data.get("ORBextractor.minThFAST", base.orb.min_th_fast)),
        )
        det = dataclasses.replace(
            base.detection,
            mask_erosion=int(
                data.get("Objects.maskErrosion", base.detection.mask_erosion)
            ),
        )
        return dataclasses.replace(base, camera=cam, orb=orb, detection=det)

    @staticmethod
    def from_reference_json(path: str, **overrides) -> "SystemConfig":
        """Load a reference-format dataset JSON (e.g. config_kitti.json)."""
        with open(path) as f:
            cfg = json.load(f)
        opt = cfg.get("optimizer", {})
        joint = opt.get("joint_optim", {})
        pose_only = opt.get("pose_only_optim", {})
        gn_cfg = GNConfig(
            code_len=opt.get("code_len", 64),
            num_depth_samples=opt.get("num_depth_samples", 50),
            cut_off=opt.get("cut_off_threshold", 0.01),
            k1=joint.get("k1", 1.0),
            k2=joint.get("k2", 100.0),
            k3=joint.get("k3", 0.25),
            k4=joint.get("k4", 1e7),
            b1=joint.get("b1", 0.20),
            b2=joint.get("b2", 0.025),
            learning_rate=joint.get("learning_rate", 1.0),
            scale_damping=joint.get("scale_damping", 1.0),
            num_iterations=joint.get("num_iterations", 10),
            pose_only_iterations=pose_only.get("num_iterations", 5),
        )
        det_cfg = DetectionConfig(
            detect_online=cfg.get("detect_online", False),
            path_label_2d=cfg.get("path_label_2d"),
            path_label_3d=cfg.get("path_label_3d"),
            weight_path_2d=cfg.get("Detector2D", {}).get("weight_path"),
            weight_path_3d=cfg.get("Detector3D", {}).get("weight_path"),
            min_bb_area=cfg.get("min_bb_area", 1600.0),
            min_mask_area=cfg.get("min_mask_area", 1000.0),
            downsample_ratio=cfg.get("downsample_ratio", 4.0),
            num_lidar_max=cfg.get("num_lidar_max", 250),
            num_lidar_min=cfg.get("num_lidar_min", 10),
        )
        base = SystemConfig(
            data_type=cfg.get("data_type", "KITTI"),
            detection=det_cfg,
            optimizer=gn_cfg,
            deepsdf_dir=cfg.get("DeepSDF_DIR"),
            voxels_dim=cfg.get("voxels_dim", 32),
        )
        return dataclasses.replace(base, **overrides) if overrides else base
