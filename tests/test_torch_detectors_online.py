"""Online detection through the port's entry points on the CPU: the
detector factory `datasets.kitti.get_detectors`, `KITTISequence` with
`detect_online`, `apps.dsp_slam --device cpu` over tests/fixtures/mini_kitti
with `detect_online: true`, and `apps.benchmark_detectors`, all with the
small detector configs of tests/test_torch_{maskrcnn,pointpillars}.py
(seeded random weights: the full-width networks belong on the card).

Checked: both detectors are built on the asked device, and configured
weight files are ingested (equal to the loaders' trees); a keyframe's
detections are built from the online detectors' outputs, as the JAX
package's KITTISequence builds them (JAX datasets/kitti.py:87-99) from the
same detector outputs (within 1e-5), and the port's PointPillars boxes
agree with JAX's PointPillars on the same weights within 2e-2 of the
largest value (the bf16 backbone rounds differently; the deblocks' kernels
repeat one phase, where the port's transposed convolutions and JAX's
resize + convolution agree, tests/deconv_parity.py); the CLI tracks all 3
frames with both detectors dispatched once per keyframe. A keyframe's
online detection goes through `kitti.detect_online`, and the detection
section's `detector_2d` / `detector_3d` blocks reach the networks.
"""

import dataclasses
import json
import os

import deconv_parity
import jax
import numpy as np
import pytest
import torch

from dspslam_tpu_torch.datasets import kitti
from dspslam_tpu_torch.detect import layers
from dspslam_tpu_torch.detect import maskrcnn as tmr
from dspslam_tpu_torch.detect import pointpillars as tpp
from dspslam_tpu_torch.utils import io
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_kitti")
CFG_2D = tmr.MaskRCNNConfig(num_classes=4, stage_blocks=(1, 1, 1, 1), fpn_channels=32, fc_dim=64,
                            rpn_pre_nms=64, rpn_post_nms=16, max_detections=5)
CFG_3D = tpp.PointPillarsConfig(
    pc_range=(0.0, -10.24, -3.0, 20.48, 10.24, 1.0), voxel_size=(0.32, 0.32, 4.0),
    max_pillars=1024, max_points_per_pillar=16, pfn_channels=32, backbone_layers=(2, 2, 2),
    backbone_channels=(32, 64, 128), fpn_channels=(32, 32, 32), nms_pre=64, max_detections=10,
)


SMALL = {"detector_2d": dataclasses.asdict(CFG_2D), "detector_3d": dataclasses.asdict(CFG_3D)}


@pytest.fixture
def small_detectors(monkeypatch):
    """KITTISequence builds its detectors at the small test configs, given
    as the detection section's blocks."""
    orig = kitti.get_detectors

    def small(det_cfg, *args, **kwargs):
        return orig(det_cfg and dataclasses.replace(det_cfg, **SMALL), *args, **kwargs)

    monkeypatch.setattr(kitti, "get_detectors", small)


def _det_cfg(**kw):
    from dspslam_tpu_torch.config import DetectionConfig

    with open(os.path.join(FIXTURE, "config.template.json")) as f:
        det = json.load(f)["detection"]
    det = {k: (v.replace("{SEQ}", FIXTURE) if isinstance(v, str) else v) for k, v in det.items()}
    return DetectionConfig(**{**det, "detect_online": True, **kw})


def test_get_detectors_builds_both_on_the_cpu(tmp_path):
    from test_torch_maskrcnn import _mmdet_state_dict
    from test_torch_pointpillars import _mmdet3d_state_dict

    assert kitti.get_detectors(None) == (None, None)
    assert kitti.get_detectors(_det_cfg(detect_online=False)) == (None, None)
    d2, d3 = kitti.get_detectors(_det_cfg(**SMALL), device="cpu")
    assert isinstance(d2, tmr.Detector2D) and isinstance(d3, tpp.Detector3D)
    assert d2.device.type == d3.device.type == "cpu" and d2.class_ids == [2]
    w2, w3 = tmp_path / "m.pth", tmp_path / "p.pth"
    torch.save({"state_dict": _mmdet_state_dict(CFG_2D)}, w2)
    torch.save({"state_dict": _mmdet3d_state_dict(CFG_3D)}, w3)
    d2, d3 = kitti.get_detectors(_det_cfg(weight_path_2d=str(w2), weight_path_3d=str(w3), **SMALL), "chairs",
                                 device="cpu")
    assert d2.class_ids == [56, 57]
    for loaded, want in ((d2.params, tmr.load_mmdet_checkpoint(str(w2), CFG_2D)),
                         (d3.params, tpp.load_mmdet3d_checkpoint(str(w3), CFG_3D))):
        for a, b in zip(jax.tree_util.tree_leaves(layers.tree_map(lambda t: t.numpy(), loaded)),
                        jax.tree_util.tree_leaves(layers.tree_map(lambda t: t.numpy(), want))):
            np.testing.assert_array_equal(a, b)


def test_sequence_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        kitti.KITTISequence(FIXTURE, _det_cfg())


class Replay:
    """A detector that returns recorded outputs."""

    def __init__(self, out):
        self.out = out

    def make_prediction(self, _):
        return self.out


def test_online_frame_detections_match_jax(small_detectors):
    from dspslam_tpu.config import DetectionConfig as JDetectionConfig
    from dspslam_tpu.datasets import kitti as jkitti
    from dspslam_tpu.detect import pointpillars as jpp

    seq = kitti.KITTISequence(FIXTURE, _det_cfg(), device="cpu")
    det2d, det3d = seq.detector_2d, seq.detector_3d
    assert isinstance(det2d, tmr.Detector2D) and det2d.cfg == CFG_2D and det3d.cfg == CFG_3D
    port_np = deconv_parity.phase_constant(layers.tree_map(lambda t: t.numpy(), det3d.params))
    det3d.params = tpp.params_from_jax(port_np)
    velo = seq.load_velodyne(0)
    img = io.load_image_rgb(os.path.join(FIXTURE, "image_2", "000000.png"))
    boxes_3d, pred_2d = det3d.make_prediction(velo), det2d.make_prediction(img)
    assert boxes_3d.ndim == 2 and boxes_3d.shape[1] == 7 and len(boxes_3d) >= 1
    # against JAX's PointPillars with the same weights: the bf16 backbone
    # rounds differently, so the boxes agree within 2e-2 of the largest value
    jdet3d = jpp.Detector3D(params=jax.tree_util.tree_map(jax.numpy.asarray, deconv_parity.jax_tree(port_np)),
                            cfg=jpp.PointPillarsConfig(**{f.name: getattr(CFG_3D, f.name)
                                                          for f in dataclasses.fields(CFG_3D)}))
    jboxes = jdet3d.make_prediction(velo)
    assert jboxes.shape == boxes_3d.shape
    assert np.abs(boxes_3d - jboxes).max() <= 2e-2 * np.abs(jboxes).max()
    # the online branch builds the measurements as JAX's does from the same
    # detector outputs
    dets = seq.get_frame_detections(0, (160, 512))
    def jax_cfg(cfg):           # the port's section has the detectors' blocks besides JAX's fields
        return JDetectionConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JDetectionConfig)})

    jseq = jkitti.KITTISequence(FIXTURE, jax_cfg(_det_cfg(detect_online=False)))
    jseq.det_cfg = jax_cfg(_det_cfg())
    jseq.detector_3d, jseq.detector_2d = Replay(boxes_3d), Replay(pred_2d)
    jdets = jseq.get_frame_detections(0, (160, 512))
    assert len(dets) == len(jdets) == len(boxes_3d)
    for a, b in zip(dets, jdets):
        np.testing.assert_allclose(a.T_cam_obj, b.T_cam_obj, atol=1e-5)
        np.testing.assert_allclose(a.surface_points, b.surface_points, atol=1e-5)
    assert det2d.dispatches == det3d.dispatches == 2


def test_sequence_detects_through_the_shared_function(small_detectors, monkeypatch):
    """KITTISequence's online half is `kitti.detect_online`, the function
    the benchmark's detect cell calls: both detectors dispatched, then both
    collected, the 3D boxes, 2D boxes and masks handed on."""
    seq = kitti.KITTISequence(FIXTURE, _det_cfg(), device="cpu")
    calls = []
    orig = kitti.detect_online

    def counted(det2d, det3d, image, velo):
        calls.append((det2d, det3d, image.shape, velo.shape))
        return orig(det2d, det3d, image, velo)

    monkeypatch.setattr(kitti, "detect_online", counted)
    seq.get_frame_detections(0, (160, 512))
    assert len(calls) == 1 and calls[0][:2] == (seq.detector_2d, seq.detector_3d)
    assert calls[0][2] == (160, 512, 3) and calls[0][3][1] == 4
    assert seq.detector_2d.dispatches == seq.detector_3d.dispatches == 1
    b3, b2, m2 = orig(seq.detector_2d, seq.detector_3d, np.zeros((160, 512), np.uint8), seq.load_velodyne(0))
    assert b3.shape[1] == 7 and b2.shape[1] == 5 and m2.shape[1:] == (160, 512)


def test_configured_detector_settings_reach_the_networks():
    """The detection section's `detector_2d` / `detector_3d` blocks (lists
    as tuples) are the networks' settings; a config without them keeps the
    defaults."""
    blocks = {"detector_2d": dataclasses.asdict(CFG_2D) | {"test_scale": [96, 64], "rpn_nms_across_levels": False},
              "detector_3d": dataclasses.asdict(CFG_3D) | {"max_pillars": 512}}
    d2, d3 = kitti.get_detectors(_det_cfg(**blocks), device="cpu")
    assert d2.cfg == dataclasses.replace(CFG_2D, test_scale=(96, 64), rpn_nms_across_levels=False)
    assert d3.cfg == dataclasses.replace(CFG_3D, max_pillars=512)
    assert kitti.detector_configs(_det_cfg()) == (tmr.MaskRCNNConfig(), tpp.PointPillarsConfig())


def test_dsp_slam_cli_with_online_detection(small_detectors, tmp_path):
    from dspslam_tpu_torch.apps import dsp_slam as tdsp

    with open(os.path.join(FIXTURE, "config.template.json")) as f:
        cfg = json.loads(f.read().replace("{SEQ}", FIXTURE))
    cfg["detection"]["detect_online"] = True
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    calls, seqs = [], []
    orig = kitti.KITTISequence.get_frame_detections

    def counted(self, frame_id, image_hw):
        calls.append(frame_id)
        seqs.append(self)
        return orig(self, frame_id, image_hw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kitti.KITTISequence, "get_frame_detections", counted)
        system = tdsp.main(["--sequence_dir", FIXTURE, "--config", str(path), "--no_loop",
                            "--map_dir", str(tmp_path / "map"), "--device", "cpu"])
    assert system.state.name == "OK"
    cams = np.loadtxt(tmp_path / "map" / "Cameras.txt").reshape(-1, 3, 4)
    assert cams.shape == (3, 3, 4) and np.isfinite(cams).all()
    assert len(calls) == len(system.map.keyframes) >= 1 and len(set(map(id, seqs))) == 1
    assert seqs[0].detector_2d.dispatches == seqs[0].detector_3d.dispatches == len(calls)
    assert os.path.exists(tmp_path / "map" / "MapObjects.txt")


def test_benchmark_detectors_small():
    from dspslam_tpu_torch.apps import benchmark_detectors as bd

    scan = bd.synthetic_scan(n=20_000, seed=1)
    assert scan.shape == (20_000, 4) and scan.dtype == np.float32
    ms, host_ms = bd.bench_pointpillars(2, torch.device("cpu"), cfg=CFG_3D, scan=scan)
    assert ms > 0 and 0 < host_ms < ms
    assert bd.bench_maskrcnn(2, torch.device("cpu"), cfg=CFG_2D, hw=(96, 128)) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bd.main(["--iters", "1"])
