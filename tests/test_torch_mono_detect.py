"""The port's online detection for mono sequences on the CPU, and its mono
object stages against the plain references of the benchmark
(benchmark/reference/mono.py).

Online detection: `datasets.mono.detect_online_mono` with a small Mask
R-CNN (stage blocks 1, a 16-channel stem, a 32-channel FPN, 4 classes,
seeded random weights) on a 540 x 960 frame at mmdet's test scale (1333,
800): resized to 750 x 1333, padded to 768 x 1344, its boxes and masks
back at 540 x 960; equal to `Detector2D.dispatch` + `collect` + the
validity filter + `build_mono_detection` done by hand; [] when no box
passes the filter. `MonoSequence` with `detect_online` runs its detector
and reads no label file; `kitti.get_detector_2d` builds Mask R-CNN alone,
`get_detectors` both networks. The spans `detect_mono`, `mono_assoc`,
`mono_gn`, `mono_mesh` and the counters `mono_dets`, `mono_objects_born`,
`mono_gn_calls`, `mono_gn_rows`, `mono_meshes` fire once per call.

Against the references: the mask erosion, the largest-mask detection with
its background rays, the PCA cuboid seed (up to the flip that the
eigenvectors' signs leave), the scale floor, the flip and the pick of a
first reconstruction.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark import detweights
from benchmark.reference import mono as ref_mono
from dspslam_tpu_torch.config import DetectionConfig
from dspslam_tpu_torch.datasets import kitti, mono
from dspslam_tpu_torch.detect import maskrcnn, offline, pointpillars
from dspslam_tpu_torch.models import deepsdf
from dspslam_tpu_torch.objects import cuboid
from dspslam_tpu_torch.objects import mono_pipeline
from dspslam_tpu_torch.shape import gn
from dspslam_tpu_torch.slam import map as map_mod
from dspslam_tpu_torch.utils import timing
from torch_threads import one_torch_thread  # noqa: F401

H, W = 540, 960
CFG_2D = maskrcnn.MaskRCNNConfig(num_classes=4, stage_blocks=(1, 1, 1, 1), stem_channels=16, fpn_channels=32,
                                 fc_dim=64, rpn_pre_nms=64, rpn_post_nms=32, max_detections=8,
                                 score_threshold=0.0, test_scale=(1333, 800), size_divisor=32)
DET_CFG = DetectionConfig(detect_online=True, min_bb_area=1600.0, min_mask_area=1000.0, downsample_ratio=4.0,
                          max_bg_rays=200, mask_erosion=10, detector_2d=dataclasses.asdict(CFG_2D))
K = np.array([[930.166, 0.0, 480.0], [0.0, 930.166, 270.0], [0.0, 0.0, 1.0]], np.float32)
INV_K = np.linalg.inv(K).astype(np.float32)


class Sink:
    def __init__(self):
        self.names = []

    def add(self, name, seconds):
        self.names.append(name)


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(3).integers(0, 255, (H, W, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def det_cfg(tmp_path_factory):
    """DET_CFG with seeded weights in mmdet's layout (benchmark/detweights.py),
    whose heads, at seed 6, find car boxes on the test frame."""
    path = tmp_path_factory.mktemp("w") / "mrcnn.pth"
    torch.save({"state_dict": detweights.maskrcnn_state_dict(DET_CFG.detector_2d, 6)}, path)
    return dataclasses.replace(DET_CFG, weight_path_2d=str(path))


@pytest.fixture(scope="module")
def detector(det_cfg):
    return kitti.get_detector_2d(det_cfg, "cars", device="cpu")


def test_the_freiburg_frame_runs_at_mmdets_test_size(detector, frame):
    assert maskrcnn.input_size((H, W), CFG_2D) == (750, 1333)
    x = maskrcnn.prepare_image(torch.from_numpy(frame), CFG_2D)
    assert x.shape == (1, 3, 768, 1344)
    pred = detector.collect(detector.dispatch(frame))
    boxes, masks = pred["pred_boxes"], pred["pred_masks"]
    assert len(boxes) > 0 and masks.shape == (len(boxes), H, W)
    assert (boxes[:, [0, 2]] >= -1e-3).all() and (boxes[:, [0, 2]] <= W + 1e-3).all()
    assert (boxes[:, [1, 3]] >= -1e-3).all() and (boxes[:, [1, 3]] <= H + 1e-3).all()
    for b, m in zip(boxes, masks):       # each pasted mask lies inside its box, rounded to pixels
        ys, xs = np.nonzero(m)
        if len(xs):
            assert xs.min() >= round(b[0]) - 1 and xs.max() <= round(b[2]) and ys.max() <= round(b[3])


def test_detect_online_mono_equals_its_steps_by_hand(detector, det_cfg, frame):
    sink = Sink()
    with timing.attached(sink):
        dets = mono.detect_online_mono(detector, frame, INV_K, det_cfg)
    assert sink.names.count("detect_mono") == 1
    pred = detector.collect(detector.dispatch(frame))
    boxes, masks = maskrcnn.get_valid_detections(pred["pred_boxes"], pred["pred_masks"], (H, W),
                                                 min_bb_area=det_cfg.min_bb_area, min_score=CFG_2D.score_threshold)
    assert 0 < len(boxes) < len(pred["pred_boxes"])         # the filter keeps some boxes, not all
    want = mono.build_mono_detection(masks, boxes, INV_K, min_mask_area=det_cfg.min_mask_area,
                                     bg_stride=det_cfg.downsample_ratio, max_bg_rays=det_cfg.max_bg_rays,
                                     mask_erosion=det_cfg.mask_erosion)
    assert want is not None and len(dets) == 1
    d = dets[0]
    assert np.array_equal(d.mask, want.mask) and np.array_equal(d.bbox, want.bbox)
    assert np.array_equal(d.rays, want.rays) and d.num_foreground == 0 and len(d.surface_points) == 0


def test_nothing_past_the_car_filter_gives_no_detection(det_cfg, frame):
    cfg = dataclasses.replace(det_cfg, detector_2d={**det_cfg.detector_2d, "score_threshold": 1.01})
    det2d = kitti.get_detector_2d(cfg, "cars", device="cpu")
    assert mono.detect_online_mono(det2d, frame, INV_K, cfg) == []


class FakeDetector:
    """Two instances in the 540 x 960 frame, the second the larger."""

    cfg = maskrcnn.MaskRCNNConfig(score_threshold=0.7)

    def __init__(self):
        self.images = []

    def dispatch(self, img):
        self.images.append(img)
        return img.shape[:2]

    def collect(self, hw):
        masks = np.zeros((2,) + hw, bool)
        masks[0, 100:160, 100:180] = True
        masks[1, 200:320, 400:600] = True
        boxes = np.array([[100, 100, 180, 160, 0.9], [400, 200, 600, 320, 0.95]], np.float32)
        return {"pred_boxes": boxes, "pred_masks": masks}


def test_mono_sequence_online_runs_the_detector_and_reads_no_label(tmp_path, monkeypatch, frame):
    from PIL import Image

    os.makedirs(tmp_path / "image_0")
    Image.fromarray(frame).save(tmp_path / "image_0" / "000000.png")

    def no_labels(*a, **k):
        raise AssertionError("an online sequence read a label file")

    monkeypatch.setattr(offline, "load_labels_2d", no_labels)
    fake = FakeDetector()
    cfg = dataclasses.replace(DET_CFG, path_label_2d=str(tmp_path / "labels"))
    seq = mono.MonoSequence(str(tmp_path), cfg, K, detector_2d=fake)
    (det,) = seq.get_frame_detections(0)
    assert len(fake.images) == 1 and np.array_equal(fake.images[0], frame)
    assert np.array_equal(det.bbox, [400, 200, 600, 320])
    assert det.mask.sum() == (120 - 9) * (200 - 9)       # the larger mask eroded by a 10 x 10 box
    with pytest.raises(ValueError):
        mono.MonoSequence(str(tmp_path), cfg, K).get_frame_detections(0)
    # offline, the same sequence reads its labels and never the detector
    monkeypatch.undo()
    off = mono.MonoSequence(str(tmp_path), dataclasses.replace(cfg, detect_online=False), K, detector_2d=fake)
    assert off.get_frame_detections(0) == [] and len(fake.images) == 1


def test_get_detector_2d_builds_no_pointpillars(monkeypatch):
    built = []
    orig = pointpillars.Detector3D

    def counted(*a, **k):
        built.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(pointpillars, "Detector3D", counted)
    assert kitti.get_detector_2d(None) is None
    assert kitti.get_detector_2d(dataclasses.replace(DET_CFG, detect_online=False)) is None
    det2d = kitti.get_detector_2d(DET_CFG, "chairs", device="cpu")
    assert isinstance(det2d, maskrcnn.Detector2D) and det2d.class_ids == [56, 57] and not built
    small_3d = {"pc_range": [0.0, -5.12, -3.0, 5.12, 5.12, 1.0], "voxel_size": [0.32, 0.32, 4.0], "max_pillars": 64,
                "max_points_per_pillar": 8, "pfn_channels": 16, "backbone_layers": [1, 1, 1],
                "backbone_channels": [16, 16, 16], "fpn_channels": [8, 8, 8], "nms_pre": 16, "max_detections": 4}
    d2, d3 = kitti.get_detectors(dataclasses.replace(DET_CFG, detector_3d=small_3d), device="cpu")
    assert isinstance(d2, maskrcnn.Detector2D) and isinstance(d3, orig) and built == [1]
    assert mono.object_class("Redwood") == "chairs" and mono.object_class("Freiburg") == "cars"


def _sphere_keyframe(n=120, center=(0.0, 0.3, 5.0), radius=0.8, seed=0):
    """A map with n points on a sphere's camera-facing side, a keyframe at
    the origin observing them all, and a detection whose mask covers the
    sphere with background rays around it."""
    rng = np.random.default_rng(seed)
    c = np.asarray(center)
    d = rng.normal(size=(4 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d[d[:, 2] < -0.2][:n]
    pts = c + radius * d
    slam_map = map_mod.Map()
    uv = pts[:, :2] / pts[:, 2:] * K[0, 0] + K[:2, 2]
    frame = map_mod.Frame(0.0, {"xy": uv.astype(np.float32)})
    for i, p in enumerate(pts):
        mp = map_mod.MapPoint(p, np.zeros(8, np.uint32), 0)
        slam_map.add_point(mp)
        frame.map_point_ids[i] = mp.id
    kf = map_mod.KeyFrame(frame)
    vv, uu = np.mgrid[0:H, 0:W]
    proj_c, r_px = c[:2] / c[2] * K[0, 0] + K[:2, 2], radius / c[2] * K[0, 0] * 1.15
    mask = (uu - proj_c[0]) ** 2 + (vv - proj_c[1]) ** 2 < r_px ** 2
    ys, xs = np.nonzero(mask)
    det = mono.build_mono_detection(mask[None], np.array([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]],
                                                         np.float32), INV_K)
    kf.detections = [det]
    return slam_map, kf


def test_the_mono_pipelines_spans_and_counters_fire_once_per_call():
    slam_map, kf = _sphere_keyframe()
    decoder = deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=8, device="cpu"))
    pipe = mono_pipeline.MonoObjectPipeline(slam_map, decoder, gn.GNConfig(code_len=8, k4=0.0, num_iterations=2,
                                                                           max_grad_points=64),
                                            max_surface_points=128, max_rays=256, voxels_dim=8, warmup_kfs=1,
                                            recon_every=1)
    names = ("mono_dets", "mono_objects_born", "mono_gn_calls", "mono_gn_rows", "mono_meshes")
    before, sink = timing.totals(), Sink()
    with timing.attached(sink):
        pipe.apply_keyframe(kf, pipe.dispatch_keyframe(kf))
    after = timing.totals()
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in names}
    assert counts == {"mono_dets": 1, "mono_objects_born": 1, "mono_gn_calls": 1, "mono_gn_rows": 2,
                      "mono_meshes": 1}, counts
    assert {n: sink.names.count(n) for n in ("mono_assoc", "mono_gn", "mono_mesh")} == \
        {"mono_assoc": 1, "mono_gn": 1, "mono_mesh": 1}
    assert pipe.gn_calls == 1 and pipe.gn_batches == [2]
    obj = next(iter(slam_map.objects.values()))
    assert obj.has_valid_pose and len(obj.vertices) > 0
    # a keyframe with no detection counts nothing and opens no span
    kf.detections = []
    before, sink = timing.totals(), Sink()
    with timing.attached(sink):
        pipe.apply_keyframe(kf, None)
    assert timing.totals().get("mono_dets", 0) == before.get("mono_dets", 0) and not sink.names


@pytest.mark.parametrize("k", (1, 2, 5, 10))
def test_erosion_matches_the_reference(k):
    rng = np.random.default_rng(k)
    mask = np.zeros((60, 90), bool)
    mask[5:50, 3:80] = True
    mask[rng.integers(0, 60, 40), rng.integers(0, 90, 40)] = False
    mask[0:8, 0:12] = True          # touching the border, which never erodes
    assert np.array_equal(mono.erode_box(mask, k), ref_mono.erode(mask, k))


def test_the_largest_mask_detection_matches_the_reference():
    rng = np.random.default_rng(7)
    masks = np.zeros((3, 120, 200), bool)
    masks[0, 10:40, 10:50] = True
    masks[1, 30:100, 60:170] = True
    masks[2, 70:110, 5:40] = True
    masks[1, rng.integers(30, 100, 60), rng.integers(60, 170, 60)] = False
    boxes = np.array([[10, 10, 50, 40, 0.9], [60, 30, 170, 100, 0.8], [5, 70, 40, 110, 0.95]], np.float32)
    invK = np.linalg.inv(np.array([[150.0, 0, 100.0], [0, 150.0, 60.0], [0, 0, 1]], np.float32)).astype(np.float32)
    for erosion, stride, cap in ((0, 4.0, 200), (5, 3.0, 50), (10, 2.0, 1000)):
        det = mono.build_mono_detection(masks, boxes, invK, min_mask_area=100.0, bg_stride=stride,
                                        max_bg_rays=cap, mask_erosion=erosion)
        ref = ref_mono.mono_detection(masks, boxes, invK, 100.0, stride, cap, erosion)
        assert ref["pick"] == 1 and np.array_equal(det.mask, ref["mask"]) and np.array_equal(det.bbox, ref["bbox"])
        assert det.rays.shape == ref["rays"].shape and np.abs(det.rays - ref["rays"]).max() <= 1e-6
    assert mono.build_mono_detection(masks, boxes, invK, min_mask_area=1e5) is None
    assert ref_mono.mono_detection(masks, boxes, invK, 1e5, 4.0, 200, 0) is None


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_the_cuboid_seed_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pts = (rng.normal(size=(300, 3)) * [1.8, 0.7, 0.9]) @ R.T + [1.0, 0.5, 6.0]
    pts = np.concatenate([pts, rng.normal(size=(6, 3)) * 8.0]).astype(np.float32)    # a few outliers
    prog, ref = cuboid.compute_cuboid_pca(pts), ref_mono.cuboid_pca(pts)
    T, Tr = prog["T_wo_sim3"], ref["T_wo_sim3"]
    gap = min(np.abs(T - Tr).max(), np.abs(T - ref_mono.flip(Tr)).max())
    assert gap <= 1e-4 * np.abs(Tr).max()
    assert np.array_equal(prog["inlier_mask"], ref["inliers"])
    assert np.array_equal(cuboid.flipped_pose(T), ref_mono.flip(T))
    floor = cuboid.floor_scale_to_domain(T, pts[:300])
    assert np.abs(floor - ref_mono.floor_scale(T, pts[:300])).max() <= 1e-6 * np.abs(floor).max()
    assert np.linalg.det(floor[:3, :3]) > np.linalg.det(T[:3, :3])       # the floor raised the scale


def test_the_pick_matches_the_reference():
    def results(losses, finite=(True, True)):
        return [{"t_cam_obj": np.eye(4) if ok else np.full((4, 4), np.nan), "loss": loss}
                for loss, ok in zip(losses, finite)]

    for losses, finite in (((2.0, 1.0), (True, True)), ((1.0, 2.0), (True, True)), ((1.0, 1.0), (True, True)),
                           ((1.0, 2.0), (False, True)), ((1.0, 2.0), (False, False))):
        res = results(losses, finite)
        best = mono_pipeline.best_of(res)
        want = ref_mono.pick(list(losses), list(finite))
        assert (best is None and want is None) or best is res[want]
