"""The port's detectors against the plain references of the benchmark
(benchmark/reference/maskrcnn.py, pointpillars.py) on the CPU, in float32,
at a small size with seeded random weights in the mmdet / mmdet3d
checkpoints' layout (BatchNorm kept, as a checkpoint stores it), ingested
by the port's loaders.

Mask R-CNN (stage blocks 1, 16-channel stem, 32-channel FPN, 4 classes) on
a 64 x 96 image resized to 80 x 120 and padded to 96 x 128 (test_scale
(160, 80)), 64 RPN candidates a level, NMS within each level, 32
proposals, 8 detections; PointPillars (pillar cap 256, 16 points a pillar,
a 64 x 64 BEV grid) on a few hundred points.

Tolerances: the resized, normalized input within 1e-5 (mmdet's mean and
std against the port's ImageNet pair over 255: one rounding apart); every
float32 stage within 1e-5 relative (BatchNorm folded into the convolutions
in the port, applied after them in the reference: the sums round apart);
the selections (top-k, decode, both NMS, labels) equal, as the references
decode in the port's order of operations; the pillars equal by BEV cell,
their features within 1e-5 m (the centroid sums in another order);
PointPillars' outputs within 2e-2 of the largest value (the port's BEV
network runs in bf16); its NMS with no pick the definition forbids.
The transposed convolutions (R12) equal the reference's written-out sum
within 1e-6 at kernel = stride 1, 2 and 4, and differ from the nearest
resize + convolution that stood in for them.
"""

import numpy as np
import pytest
import torch

from benchmark import detweights
from benchmark.reference import maskrcnn as ref2d
from benchmark.reference import pointpillars as ref3d
from dspslam_tpu_torch.detect import layers
from dspslam_tpu_torch.detect import maskrcnn as tmr
from dspslam_tpu_torch.detect import pointpillars as tpp
from torch_threads import one_torch_thread  # noqa: F401

CFG_2D = {"num_classes": 4, "stage_blocks": [1, 1, 1, 1], "stem_channels": 16, "fpn_channels": 32,
          "anchor_scales": [8.0], "anchor_ratios": [0.5, 1.0, 2.0], "rpn_pre_nms": 64, "rpn_post_nms": 32,
          "rpn_nms_iou": 0.7, "rpn_nms_across_levels": False, "backbone_dtype": "float32", "roi_size": 7,
          "mask_roi_size": 14, "fc_dim": 64, "score_threshold": 0.0, "nms_iou": 0.5, "max_detections": 8,
          "test_scale": [160, 80], "size_divisor": 32}
CFG_3D = {"pc_range": [0.0, -10.24, -3.0, 20.48, 10.24, 1.0], "voxel_size": [0.32, 0.32, 4.0],
          "max_points_per_pillar": 16, "max_pillars": 256, "pfn_channels": 16, "backbone_layers": [1, 1, 1],
          "backbone_strides": [2, 2, 2], "backbone_channels": [16, 32, 32], "fpn_upsample": [1, 2, 4],
          "fpn_channels": [16, 16, 16], "anchor_size": [1.6, 3.9, 1.56], "anchor_z": -1.78,
          "anchor_rotations": [0.0, 1.57], "score_threshold": 0.1, "nms_iou_threshold": 0.01, "nms_pre": 64,
          "max_detections": 10}


def frozen(cls, block):
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in block.items()})


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_transposed_conv_is_the_published_layer(k):
    """R12: the port's layer is mmdet's ConvTranspose2d (kernel = stride) on
    the checkpoint's (in, out, k, k) weights; the nearest resize followed by
    a convolution with the transposed kernel, which both packages ran
    before, is another layer."""
    g = torch.Generator().manual_seed(k)
    x = torch.randn(2, 6, 5, 7, generator=g)
    w, b = torch.randn(6, 4, k, k, generator=g), torch.randn(4, generator=g)
    port = layers.conv_transpose2d(x, {"w": w, "b": b})
    ref = ref2d.transposed_conv(x, w, b)
    assert port.shape == ref.shape == (2, 4, 5 * k, 7 * k)
    torch.testing.assert_close(port, ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(port, torch.nn.functional.conv_transpose2d(x, w, b, stride=k), rtol=0, atol=1e-5)
    up = layers.resize_nearest(x, (5 * k, 7 * k))
    substitute = layers.conv2d_same(up, {"w": w.transpose(0, 1), "b": b})
    assert substitute.shape == port.shape
    if k > 1:
        assert _rel(substitute, port) > 0.1


@pytest.fixture(scope="module")
def maskrcnn(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "mrcnn.pth"
    sd = detweights.maskrcnn_state_dict(CFG_2D, 5)
    torch.save({"state_dict": sd}, path)
    cfg = frozen(tmr.MaskRCNNConfig, CFG_2D)
    return tmr.load_mmdet_checkpoint(str(path), cfg), ref2d.load(str(path)), cfg


def test_maskrcnn_matches_the_reference(maskrcnn):
    params, sd, cfg = maskrcnn
    img = np.random.default_rng(0).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    x = tmr.prepare_image(torch.from_numpy(img), cfg)
    x_ref, hw = ref2d.prepare(img, CFG_2D["test_scale"], 32)
    assert x.shape == (1, 3, 96, 128) and hw == tmr.input_size((64, 96), cfg) == (80, 120)
    assert float(torch.abs(x - x_ref).max()) <= 1e-5 and float(torch.abs(x[..., 80:, :]).max()) == 0.0
    feats = tmr.resnet_fpn(params, x, cfg)
    for f, r in zip(feats, ref2d.backbone(sd, x)):
        assert _rel(f, r) <= 1e-5
    levels = tmr.rpn_heads(params, feats)
    for (s, d), (rs, rd) in zip(levels, ref2d.rpn_heads(sd, feats)):
        assert _rel(s, rs) <= 1e-5 and _rel(d, rd) <= 1e-5
    level_hw = [f.shape[-2:] for f in feats]
    props, valid = tmr.rpn_select(levels, level_hw, hw, cfg)
    ref_props = ref2d.rpn_select(levels, level_hw, hw, 64, 32, 0.7, across_levels=False)
    assert int(valid.sum()) == len(ref_props) == 32
    torch.testing.assert_close(props, ref_props, rtol=0, atol=0)
    boxes, scores, classes, probs = tmr.box_head(params, feats, props, valid, hw, cfg)
    r_boxes, r_scores, r_classes, r_probs = ref2d.box_head(sd, feats, props, valid, hw)
    assert _rel(probs, r_probs) <= 1e-5 and _rel(boxes, r_boxes) <= 1e-5
    kb, ks, kv, kl = tmr.select_boxes(boxes, scores, classes, cfg)
    rb, rs, rl = ref2d.select(boxes, scores, classes, 0.5, 8)
    n = int(kv.sum())
    assert n == len(rb) >= 2
    torch.testing.assert_close(kb[:n], rb, rtol=0, atol=0)
    assert torch.equal(kl[:n], rl)
    masks = tmr.mask_head(params, feats, kb, kl, cfg)
    assert _rel(masks[:n], ref2d.mask_head(sd, feats, kb[:n], kl[:n])) <= 1e-5


def test_rpn_suppresses_within_each_level_only():
    """mmdet's test_cfg.rpn: a box of one level does not suppress a box of
    another. Two equal boxes on two levels both survive within levels, and
    one survives across them."""
    box = torch.tensor([[10.0, 10.0, 40.0, 30.0]])
    boxes, scores = torch.cat([box, box, box + 50]), torch.tensor([0.9, 0.8, 0.7])
    within = tmr.greedy_nms(boxes, scores, 3, 0.7, -1e9, groups=torch.tensor([0, 1, 1]))
    across = tmr.greedy_nms(boxes, scores, 3, 0.7, -1e9)
    assert within[2].tolist() == [1.0, 1.0, 1.0] and across[2].tolist() == [1.0, 1.0, 0.0]


def test_detector2d_scales_boxes_back(maskrcnn):
    """collect() maps the network's boxes from the resized frame back to
    the image: mmdet's rescale by the per-axis scale factors."""
    params, _, cfg = maskrcnn
    det = tmr.Detector2D(params=params, cfg=cfg, device="cpu")
    det.class_ids = [0, 1, 2, 3]
    img = np.random.default_rng(1).integers(0, 256, (64, 96), dtype=np.uint8)
    out = tmr.detect(params, torch.from_numpy(img), (64, 96), cfg)
    pred = det.make_prediction(img)
    keep = (out["valid"] > 0).numpy()
    want = out["boxes"].numpy()[keep] / np.asarray([120 / 96, 80 / 64, 120 / 96, 80 / 64], np.float32)
    assert len(pred["pred_boxes"]) == int(keep.sum()) >= 1 and pred["pred_masks"].shape[1:] == (64, 96)
    np.testing.assert_allclose(pred["pred_boxes"][:, :4], want, rtol=1e-6)


def _scan(seed=3):
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(0.5, 20, 300), rng.uniform(-10, 10, 300), np.full(300, -1.7),
                       rng.uniform(0, 1, 300)], -1)
    cars = [np.concatenate([rng.normal([cx, cy, -1.0], [0.8, 0.4, 0.3], (80, 3)), np.full((80, 1), 0.6)], -1)
            for cx, cy in ((6.0, 2.0), (12.0, -4.0))]
    return np.concatenate([ground] + cars).astype(np.float32)


def test_pointpillars_matches_the_reference(tmp_path):
    path = tmp_path / "pp.pth"
    sd_t = detweights.pointpillars_state_dict(CFG_3D, 9)
    torch.save({"state_dict": sd_t}, path)
    cfg = frozen(tpp.PointPillarsConfig, CFG_3D)
    det = tpp.Detector3D(params=tpp.load_mmdet3d_checkpoint(str(path), cfg), cfg=cfg, device="cpu")
    sd = ref3d.load(str(path))
    scan = _scan()
    pil = tpp.build_pillars_from_points(det.upload(scan), cfg)
    ref = ref3d.pillars(scan, CFG_3D)
    live = pil["pillar_mask"] > 0
    nx = cfg.grid_size[0]
    keys = (pil["coords"][live, 1] * nx + pil["coords"][live, 0]).long().numpy()
    order = np.argsort(keys)
    np.testing.assert_array_equal(keys[order], ref["keys"])
    np.testing.assert_array_equal(pil["mask"][live].numpy()[order], ref["mask"])
    np.testing.assert_allclose(pil["features"][live].numpy()[order], ref["features"], rtol=0, atol=1e-5)
    cls, deltas, dirs = tpp.forward(det.params, pil, cfg)
    for a, b in zip((cls, deltas, dirs), ref3d.forward(sd, pil, CFG_3D)):
        assert float(torch.abs(a - b).max()) <= 2e-2 * float(torch.abs(b).max())
    boxes = tpp.decode_boxes(deltas, det.anchors)
    torch.testing.assert_close(boxes, ref3d.decode(deltas, ref3d.anchors(CFG_3D, (32, 32))), rtol=0, atol=0)
    kept, _, valid = tpp.select_detections(cls, boxes, dirs, cfg)
    cand, scores = ref3d.candidates(cls, boxes, dirs, 64)
    picks = [int(torch.argmin(torch.abs(cand - b[None]).amax(-1))) for b in kept[valid > 0]]
    assert len(picks) >= 2 and torch.equal(cand[picks], kept[valid > 0])
    iou = ref3d.rotated_iou(cand.double().numpy())
    assert ref3d.nms_misses(iou, scores.double().numpy(), picks, 0.01, 10, 0.1, 1e-4) == 0
    assert ref3d.nms_misses(iou, scores.double().numpy(), picks[1:], 0.01, 10, 0.1, 1e-4) >= 1
