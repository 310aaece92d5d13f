from . import kitti, mono


def get_sequence(data_dir: str, system_cfg, device=None):
    """Sequence factory (reference reconstruct/__init__.py:16-23), as the JAX
    package's: KITTI -> stereo+LiDAR sequence (its online detectors, when the
    config asks for them, on `device`, None meaning cuda); Redwood /
    Freiburg -> mono sequence (its online Mask R-CNN likewise)."""
    if system_cfg.data_type == "KITTI":
        return kitti.KITTISequence(data_dir, system_cfg.detection, device=device)
    det2d = kitti.get_detector_2d(system_cfg.detection, mono.object_class(system_cfg.data_type), device)
    return mono.MonoSequence(data_dir, system_cfg.detection, system_cfg.camera.K, detector_2d=det2d)
