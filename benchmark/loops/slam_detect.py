"""The detect cell: loops/slam.py's stereo drives with DSP-SLAM's online
detectors on every keyframe (`detect_online: true`).

Set-up writes the configuration's detectors' weights (seeded random, in
the mmdet / mmdet3d checkpoints' layout, benchmark/detweights.py) under
benchmark/.cache/weights/, builds both networks through the port's
`datasets.kitti.get_detectors` with the configuration's `detector_2d` /
`detector_3d` settings and those files, and ray casts each drive's LiDAR
scans (benchmark/lidar.py). In the window every keyframe calls the port's
shared online-detection function (`datasets.kitti.detect_online`) on its
own left frame (the grey frame, which the detector tiles to three
channels) and its scan, and fetches both networks' outputs; random
weights find next to nothing, so the object pipeline then gets the world's
labels, as in kitti_full (`GroundTruthDetections`).

`correct` is kitti_full's check of the SLAM path plus the detectors
followed stage by stage on a seeded sample of keyframes (benchmark/
detcheck.py). Counters the port keeps while the window runs
(`det2d_nms_rounds`, `det3d_points`, `det2d_kept`, `det3d_kept`) go into
the set-up line's notes (`window_counts`).
"""

from __future__ import annotations

import numpy as np

from .. import checks, detcheck, detfaults, detweights, lidar
from ..reference import maskrcnn as ref2d
from ..reference import pointpillars as ref3d
from .slam import GroundTruthDetections, Sampler, SlamCell

COUNTERS = ("det2d_nms_rounds", "det3d_points", "det2d_kept", "det3d_kept")


class OnlineDetections:
    """A drive's detection source with the detectors in front: a keyframe's
    call runs both networks on its frame's image and scan, then returns the
    ground-truth source's labels."""

    def __init__(self, cell, labels: GroundTruthDetections):
        self.cell, self.labels = cell, labels

    def __call__(self, idx):
        from dspslam_tpu_torch.datasets import kitti

        cell, d = self.cell, self.labels.drive
        k = min(idx, len(d.traj) - 1)
        keep = cell.det_sampler is not None and cell.det_sampler.take()
        if keep:
            cell.tap2d.record, cell.tap3d.record = {}, {}
        try:
            kitti.detect_online(cell.det2d, cell.det3d, d.frames[k][0], d.scans[k])
        finally:
            rec = {**(cell.tap2d.record or {}), **(cell.tap3d.record or {})}
            cell.tap2d.record = cell.tap3d.record = None
        if keep:
            cell.det_kept.append({"image": d.frames[k][0], "scan": d.scans[k], "rec": rec})
        return self.labels(idx)


def _online_system_class(base):
    """`base` whose detection source, once assigned, is wrapped by
    `OnlineDetections`: loops/slam.py assigns each drive's labels source
    after building the system."""

    class OnlineDetectionSystem(base):
        def __setattr__(self, name, value):
            if name == "detection_source" and isinstance(value, GroundTruthDetections):
                value = OnlineDetections(self._detect_cell, value)
            super().__setattr__(name, value)

    return OnlineDetectionSystem


class DetectCell(SlamCell):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.det_sampler = None
        self.det_kept: list[dict] = []
        self.tap2d = self.tap3d = None
        self._system_class = None
        self._det_saved = {}

    def setup(self):
        from dspslam_tpu_torch.config import DetectionConfig
        from dspslam_tpu_torch.datasets import kitti
        from dspslam_tpu_torch.detect import maskrcnn, pointpillars
        from dspslam_tpu_torch.utils import timing

        log, det = self.log, self.config["detection"]
        seeds = np.random.default_rng([self.seed, 17]).integers(2 ** 31, size=2)
        with log.stage("detector_weights"):
            self.weights_2d, hit2 = detweights.write("maskrcnn", det["detector_2d"], int(seeds[0]))
            self.weights_3d, hit3 = detweights.write("pointpillars", det["detector_3d"], int(seeds[1]))
            log.notes["detector_weights_cache_hits"] = int(hit2) + int(hit3)
        with log.stage("detectors"):
            det_cfg = DetectionConfig(**{**det, "weight_path_2d": self.weights_2d, "weight_path_3d": self.weights_3d})
            self.det2d, self.det3d = kitti.get_detectors(det_cfg, device=self.device)
        sd2 = sd3 = None
        if self.variant == detfaults.CONTROL:
            sd2, sd3 = ref2d.load(self.weights_2d, self.device), ref3d.load(self.weights_3d, self.device)
        self._det_saved = detfaults.install(self.variant, maskrcnn, pointpillars, sd2, sd3, det["detector_3d"])
        self.tap2d = detcheck.StageTap(maskrcnn, detcheck.STAGES_2D)
        self.tap3d = detcheck.StageTap(pointpillars, detcheck.STAGES_3D)
        self.det_sample_rng = np.random.default_rng([self.seed, 23])
        super().setup()          # imports, kernels, the decoder fit, renders, the warm-up drive
        with log.stage("scans"):
            log.notes["scan_cache_hits"] = sum(lidar.load_or_render(d, self.mix["lidar"]) for d in self.drives
                                               if getattr(d, "scans", None) is None)
        self._counts0 = timing.totals()

    def drive(self, d, *args, **kwargs):
        if getattr(d, "scans", None) is None:          # the warm-up drive: before set-up renders them all
            lidar.load_or_render(d, self.mix["lidar"])
        return super().drive(d, *args, **kwargs)

    def build_system(self, spans):
        system = super().build_system(spans)
        if self._system_class is None:
            self._system_class = _online_system_class(type(system))
        object.__setattr__(system, "_detect_cell", self)
        system.__class__ = self._system_class
        return system

    def window(self, seconds: float, trace=None) -> float:
        from dspslam_tpu_torch.utils import timing

        chk = self.mix["check"]
        self.det_sampler = Sampler(self.det_sample_rng, chk["det_spacing"], chk["det_cap"])
        try:
            return super().window(seconds, trace)
        finally:
            self.det_sampler = None
            now = timing.totals()
            self.log.notes["window_counts"] = {k: now.get(k, 0) - self._counts0.get(k, 0) for k in COUNTERS}

    def release(self):
        super().release()
        for tap in (self.tap2d, self.tap3d):
            if tap is not None:
                tap.remove()
        detfaults.restore(self._det_saved)
        self.det2d = self.det3d = None

    def check(self) -> dict:
        """kitti_full's numbers, and the detectors' on the sampled keyframes."""
        out = super().check()
        det = self.config["detection"]
        sd2, sd3 = ref2d.load(self.weights_2d, self.device), ref3d.load(self.weights_3d, self.device)
        readings = []
        for k in self.det_kept:
            readings.append({**detcheck.det2d_gaps(k["rec"], sd2, k["image"], det["detector_2d"]),
                             **detcheck.det3d_gaps(k["rec"], sd3, k["scan"], det["detector_3d"])})
        if not readings:
            raise RuntimeError("no keyframe's detections were sampled in the window")
        out.update(checks.worst(readings))
        self.checked["detect_keyframes"] = len(readings)
        return out


Cell = DetectCell
