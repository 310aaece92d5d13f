"""The port's Mask R-CNN (dspslam_tpu_torch/detect/maskrcnn.py) against
dspslam_tpu/detect/maskrcnn.py on the CPU, at tests/test_maskrcnn.py's small
config, with the JAX package's seeded weights carried across through
`params_from_jax` and numpy-seeded images. The mask head's upsample is a
transposed convolution in the port and a resize + convolution in JAX (R12):
its kernel repeats one phase (tests/deconv_parity.py), where the two agree,
and tests/test_torch_detect_reference.py holds the general layer to the
plain reference.

Tolerances:
- `_conv2d` (SAME padding, strides 1 and 2, k in {1, 3, 7}, even and odd
  sizes), the max pool and the FPN's nearest resize: f32 within 1e-5 of the
  largest value; the pool and the resize exactly;
- `resnet_fpn` in float32: max |d| / max |f| <= 1e-5 per level; in bf16
  (the default backbone, whose products round per layer where XLA may keep
  more precision inside a fusion) <= 3e-2;
- `detect` in float32: boxes within 1e-3 px, scores 1e-5, labels and
  validity equal, mask logits within 1e-5 of the largest;
- greedy NMS and the RPN's top-k on planted ties: equal;
- roi_align within 1e-5, fpn_level_of, paste_masks, the validity filter and
  the checkpoint loader: equal.
"""

import dataclasses

import deconv_parity
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dspslam_tpu.detect import maskrcnn as jmr
from dspslam_tpu_torch.detect import layers
from dspslam_tpu_torch.detect import maskrcnn as tmr
from torch_threads import one_torch_thread  # noqa: F401

JCFG = jmr.MaskRCNNConfig(
    num_classes=4, stage_blocks=(1, 1, 1, 1), fpn_channels=32, fc_dim=64,
    rpn_pre_nms=64, rpn_post_nms=16, max_detections=5,
)
TCFG = tmr.MaskRCNNConfig(**dataclasses.asdict(JCFG))


def numpy_params(cfg, seed=0):
    """He-normal weights and small nonzero biases, seeded with numpy, in
    the JAX package's tree layout."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict) and "w" in node:
            w = node["w"]
            fan_in = w[0].numel() if w.ndim == 4 else w.shape[0]
            return {"w": (rng.normal(size=tuple(w.shape)) * np.sqrt(2.0 / fan_in)).astype(np.float32),
                    "b": (rng.normal(size=tuple(node["b"].shape)) * 0.1).astype(np.float32)}
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return [fill(v) for v in node]

    return fill(tmr.init_params(cfg))


@pytest.fixture(scope="module")
def params():
    port, jax_np = deconv_parity.split(numpy_params(TCFG))
    return jax.tree_util.tree_map(jnp.asarray, jax_np), tmr.params_from_jax(port)


jax_resnet_fpn = jax.jit(jmr.resnet_fpn, static_argnums=2)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    return float(np.abs(a - np.asarray(b, np.float64)).max() / max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("hw", [(16, 20), (15, 17)], ids=["even", "odd"])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_same_padding(hw, k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(1, 3, *hw)).astype(np.float32)
    p = {"w": rng.normal(size=(4, 3, k, k)).astype(np.float32), "b": rng.normal(size=4).astype(np.float32)}
    j = np.asarray(jmr._conv2d(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()}, stride))
    t = layers.conv2d_same(torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in p.items()}, stride)
    assert t.shape == j.shape
    assert _rel(j, t.numpy()) <= 1e-5


def test_stem_padding_is_asymmetric_at_even_height():
    # KITTI's 376 rows: the 7x7/2 stem pads 2 above and 3 below; the 3x3/2
    # pool at an even size pads 0 and 1. torch's symmetric padding=k//2
    # gives the same shape but samples one pixel off.
    assert layers.same_pads(376, 7, 2) == (2, 3)
    assert layers.same_pads(1241, 7, 2) == (3, 3)
    assert layers.same_pads(188, 3, 2) == (0, 1)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 1, 12, 10)).astype(np.float32))
    p = {"w": torch.from_numpy(rng.normal(size=(1, 1, 7, 7)).astype(np.float32)), "b": torch.zeros(1)}
    sym = F.conv2d(x, p["w"], stride=2, padding=3)
    same = layers.conv2d_same(x, p, 2)
    assert sym.shape == same.shape and not torch.allclose(sym, same)


@pytest.mark.parametrize("hw", [(16, 20), (15, 17)], ids=["even", "odd"])
def test_max_pool_same(hw):
    x = np.random.default_rng(3).normal(size=(1, 2, *hw)).astype(np.float32)
    j = -jax.lax.reduce_window(-jnp.asarray(x), jnp.inf, jax.lax.min, (1, 1, 3, 3), (1, 1, 2, 2), "SAME")
    np.testing.assert_array_equal(layers.max_pool_same(torch.from_numpy(x), 3, 2).numpy(), np.asarray(j))


@pytest.mark.parametrize("src,dst", [((24, 78), (47, 156)), ((47, 156), (94, 311)), ((12, 39), (24, 78))])
def test_fpn_resize_matches_jax_nearest(src, dst):
    # 376-px KITTI levels: 24 -> 47 and 47 -> 94 rows are not 2x
    x = np.random.default_rng(4).normal(size=(1, 2, *src)).astype(np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, *dst), "nearest"))
    np.testing.assert_array_equal(layers.resize_nearest(torch.from_numpy(x), dst).numpy(), j)
    if dst[0] != 2 * src[0]:
        floor_rule = F.interpolate(torch.from_numpy(x), size=dst, mode="nearest").numpy()
        assert not np.array_equal(floor_rule, j)


@pytest.mark.parametrize("hw", [(128, 160), (117, 171)], ids=["even", "odd"])
def test_resnet_fpn_float32(params, hw):
    jp, tp = params
    cfg_j, cfg_t = (dataclasses.replace(c, backbone_dtype="float32") for c in (JCFG, TCFG))
    img = np.random.default_rng(1).uniform(0, 255, (*hw, 3)).astype(np.float32)
    jf = jax_resnet_fpn(jp, jmr.normalize_image(img), cfg_j)
    tf = tmr.resnet_fpn(tp, tmr.normalize_image(torch.from_numpy(img)), cfg_t)
    assert len(tf) == 5
    for a, b in zip(jf, tf):
        assert b.shape == a.shape and b.dtype == torch.float32
        assert _rel(a, b.numpy()) <= 1e-5


def test_resnet_fpn_bf16_and_gray_tiling(params):
    jp, tp = params
    img = np.random.default_rng(2).uniform(0, 255, (117, 171)).astype(np.float32)
    np.testing.assert_array_equal(tmr.normalize_image(torch.from_numpy(img)).numpy(),
                                  np.asarray(jmr.normalize_image(img)))
    jf = jax_resnet_fpn(jp, jmr.normalize_image(img), JCFG)
    tf = tmr.resnet_fpn(tp, tmr.normalize_image(torch.from_numpy(img)), TCFG)
    for a, b in zip(jf, tf):
        assert _rel(a, b.numpy()) <= 3e-2


def test_detect_float32_matches_jax(params):
    jp, tp = params
    cfg_j, cfg_t = (dataclasses.replace(c, backbone_dtype="float32") for c in (JCFG, TCFG))
    img = np.random.default_rng(1).uniform(0, 255, (128, 160, 3)).astype(np.float32)
    jo = jmr.detect(jp, jnp.asarray(img), (128, 160), cfg_j)
    to = tmr.detect(tp, torch.from_numpy(img), (128, 160), cfg_t)
    assert to["boxes"].shape == (5, 4) and to["mask_logits"].shape == (5, 28, 28)
    np.testing.assert_allclose(to["boxes"].numpy(), np.asarray(jo["boxes"]), atol=1e-3)
    np.testing.assert_allclose(to["scores"].numpy(), np.asarray(jo["scores"]), atol=1e-5)
    np.testing.assert_array_equal(to["labels"].numpy(), np.asarray(jo["labels"]))
    np.testing.assert_array_equal(to["valid"].numpy(), np.asarray(jo["valid"]))
    assert _rel(jo["mask_logits"], to["mask_logits"].numpy()) <= 1e-5


# (rounds, score threshold): fewer rounds than boxes; the two ties at 0.6
# that are picked sit on the threshold exactly (kept only above it, in f32);
# rounds beyond the 24 boxes; and the RPN's threshold, at which the rounds
# past the last live box pick dead slots that are not kept
@pytest.mark.parametrize("k,thresh", [(10, -np.inf), (24, 0.3), (24, 0.6), (30, 0.05), (40, -1e9)],
                         ids=["few_rounds", "mid", "at_threshold", "beyond_boxes", "rpn_beyond_live"])
def test_greedy_nms_planted_ties(k, thresh):
    rng = np.random.default_rng(9)
    xy = rng.uniform(0, 40, (24, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 12, (24, 2))], -1).astype(np.float32)
    boxes[12:18] = boxes[:6] + 0.5                 # heavy overlaps
    scores = np.round(rng.uniform(0, 1, 24), 1).astype(np.float32)   # many exact ties
    scores[[3, 7, 12, 20]] = 1.0
    jb, js, jv = jmr.greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), k, 0.5, score_thresh=thresh)
    tb, ts, tv = tmr.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), k, 0.5,
                                score_thresh=thresh)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if thresh == 0.6:
        assert tv.sum() == 11                      # 11 picks above 0.6; the two at 0.6 are not kept
    if k > 24:                                     # every box is dead after 24 rounds
        assert tv.sum() > 0 and tv[-1] == 0


def test_top_k_ties_lower_index_first():
    x = np.asarray([1.0, 3.0, 3.0, 2.0, 3.0, 1.0, 2.0], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    tv, ti = layers.top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_rpn_candidates_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(1, 32, 32 // 2**i, 40 // 2**i)).astype(np.float32) for i in range(5)]
    jprop, jval = jax.jit(jmr.rpn_propose, static_argnums=(2, 3))(
        jp, [jnp.asarray(f) for f in feats], (128, 160), JCFG)
    tprop, tval = tmr.rpn_propose(tp, [torch.from_numpy(f) for f in feats], (128, 160), TCFG)
    np.testing.assert_allclose(tprop.numpy(), np.asarray(jprop), atol=1e-3)
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))


def test_roi_align_and_levels():
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(8, 40, 56)).astype(np.float32)
    x0, y0 = rng.uniform(0, 40, 12), rng.uniform(0, 28, 12)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, 14, 12), y0 + rng.uniform(2, 10, 12)], -1).astype(np.float32)
    boxes[-3:] = [[-5.0, -3.0, 10.0, 8.0], [48.0, 32.0, 60.0, 45.0], [-4.0, -4.0, 60.0, 44.0]]
    j = np.asarray(jmr.roi_align(jnp.asarray(feat), jnp.asarray(boxes), 7))
    t = tmr.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes), 7).numpy()
    assert t.shape == (12, 8, 7, 7)
    np.testing.assert_allclose(t, j, atol=1e-5)
    wh = np.concatenate([rng.uniform(8, 900, (50, 2)), [[112, 112], [224, 224], [448, 448], [32, 32]]])
    lv_boxes = np.concatenate([np.zeros_like(wh), wh], -1).astype(np.float32)
    np.testing.assert_array_equal(tmr.fpn_level_of(torch.from_numpy(lv_boxes)).numpy(),
                                  np.asarray(jmr.fpn_level_of(jnp.asarray(lv_boxes))))


def test_paste_masks_and_validity_filter():
    rng = np.random.default_rng(8)
    boxes = np.asarray([[10, 5, 90, 60], [0, 0, 20, 30], [50, 50, 49, 60], [100, 10, 160, 70]], np.float32)
    logits = rng.normal(size=(4, 28, 28)).astype(np.float32)
    valid = np.asarray([1, 1, 1, 0], np.float32)
    np.testing.assert_array_equal(tmr.paste_masks(boxes, logits, valid, (80, 128)),
                                  jmr.paste_masks(boxes, logits, valid, (80, 128)))
    dets = np.asarray([[100, 50, 300, 200, 0.9], [5, 50, 300, 200, 0.9], [100, 50, 130, 70, 0.9],
                       [100, 50, 300, 200, 0.5]], np.float32)
    masks = rng.uniform(size=(4, 376, 1241)) > 0.5
    for a, b in zip(tmr.get_valid_detections(dets, masks, (376, 1241)),
                    jmr.get_valid_detections(dets, masks, (376, 1241))):
        np.testing.assert_array_equal(a, b)


def _mmdet_state_dict(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv_bn(conv, bn, cout, cin, k):
        sd[conv + ".weight"] = torch.randn(cout, cin, k, k, generator=g)
        sd[bn + ".weight"] = torch.randn(cout, generator=g)
        sd[bn + ".bias"] = torch.randn(cout, generator=g)
        sd[bn + ".running_mean"] = torch.randn(cout, generator=g)
        sd[bn + ".running_var"] = torch.rand(cout, generator=g) + 0.5

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = torch.randn(cout, cin, k, k, generator=g)
        sd[key + ".bias"] = torch.randn(cout, generator=g)

    def fc(key, dout, din):
        sd[key + ".weight"] = torch.randn(dout, din, generator=g)
        sd[key + ".bias"] = torch.randn(dout, generator=g)

    conv_bn("backbone.conv1", "backbone.bn1", 64, 3, 7)
    cin, width = 64, 64
    for si in range(4):
        cout = width * 4
        for bi in range(cfg.stage_blocks[si]):
            base = f"backbone.layer{si + 1}.{bi}"
            conv_bn(base + ".conv1", base + ".bn1", width, cin if bi == 0 else cout, 1)
            conv_bn(base + ".conv2", base + ".bn2", width, width, 3)
            conv_bn(base + ".conv3", base + ".bn3", cout, width, 1)
            if bi == 0:
                conv_bn(base + ".downsample.0", base + ".downsample.1", cout, cin, 1)
        cin, width = cout, width * 2
    c = cfg.fpn_channels
    for i, ch in enumerate((256, 512, 1024, 2048)):
        conv(f"neck.lateral_convs.{i}.conv", c, ch, 1)
        conv(f"neck.fpn_convs.{i}.conv", c, c, 3)
    conv("rpn_head.rpn_conv", c, c, 3)
    conv("rpn_head.rpn_cls", 3, c, 1)
    conv("rpn_head.rpn_reg", 12, c, 1)
    fc("roi_head.bbox_head.shared_fcs.0", cfg.fc_dim, c * cfg.roi_size**2)
    fc("roi_head.bbox_head.shared_fcs.1", cfg.fc_dim, cfg.fc_dim)
    fc("roi_head.bbox_head.fc_cls", cfg.num_classes + 1, cfg.fc_dim)
    fc("roi_head.bbox_head.fc_reg", cfg.num_classes * 4, cfg.fc_dim)
    for i in range(4):
        conv(f"roi_head.mask_head.convs.{i}.conv", c, c, 3)
    sd["roi_head.mask_head.upsample.weight"] = torch.randn(c, c, 2, 2, generator=g)
    sd["roi_head.mask_head.upsample.bias"] = torch.randn(c, generator=g)
    conv("roi_head.mask_head.conv_logits", cfg.num_classes, c, 1)
    return sd


def test_checkpoint_loader_matches_jax(tmp_path):
    """Every leaf as JAX's loader gives it, but the three the port reads as
    mmdet 2.x stores them: the classifier with its background row (last in
    mmdet 2.x) moved first, the box regressor with the target stds folded
    in, and the mask upsample's (in, out, 2, 2) transposed kernel as it is
    (JAX transposes it for its resize + conv substitute, R12)."""
    path = tmp_path / "mrcnn.pth"
    sd = _mmdet_state_dict(JCFG)
    torch.save({"state_dict": sd}, path)
    jp = jax.tree_util.tree_flatten_with_path(jmr.load_mmdet_checkpoint(str(path), JCFG))[0]
    tp = layers.tree_map(lambda t: t.numpy(), tmr.load_mmdet_checkpoint(str(path), TCFG))
    tl = jax.tree_util.tree_leaves(tp)
    assert len(tl) == len(jp)
    order = [JCFG.num_classes] + list(range(JCFG.num_classes))
    stds = np.tile(np.asarray(tmr.RCNN_TARGET_STDS, np.float32), JCFG.num_classes)
    want = {("cls", "w"): sd["roi_head.bbox_head.fc_cls.weight"].numpy().T[:, order],
            ("cls", "b"): sd["roi_head.bbox_head.fc_cls.bias"].numpy()[order],
            ("reg", "w"): sd["roi_head.bbox_head.fc_reg.weight"].numpy().T * stds,
            ("reg", "b"): sd["roi_head.bbox_head.fc_reg.bias"].numpy() * stds,
            ("mask_deconv", "w"): sd["roi_head.mask_head.upsample.weight"].numpy()}
    for (path_j, a), b in zip(jp, tl):
        key = (path_j[0].key, path_j[-1].key)
        np.testing.assert_array_equal(b, want[key] if key in want else np.asarray(a), err_msg=str(key))
    # the loaded net runs, the mask upsample as a 2x2 stride-2 transposed conv
    img = np.random.default_rng(3).uniform(0, 255, (96, 128, 3)).astype(np.float32)
    out = tmr.detect(tmr.load_mmdet_checkpoint(str(path), TCFG), torch.from_numpy(img), (96, 128), TCFG)
    assert np.isfinite(out["scores"].numpy()).all()


def test_detector2d_matches_jax_on_the_cpu(params):
    jp, tp = params
    cfg_j, cfg_t = (dataclasses.replace(c, backbone_dtype="float32") for c in (JCFG, TCFG))
    jd = jmr.Detector2D(params=jp, cfg=cfg_j)
    td = tmr.Detector2D(params=tp, cfg=cfg_t, device="cpu")
    jd.class_ids = td.class_ids = [0, 1, 2, 3]
    jd.cfg = dataclasses.replace(cfg_j, score_threshold=0.0)
    td.cfg = dataclasses.replace(cfg_t, score_threshold=0.0)
    img = np.random.default_rng(1).uniform(0, 255, (128, 160, 3)).astype(np.float32)
    a, b = jd.make_prediction(img), td.make_prediction(img)
    assert b["pred_boxes"].shape[1] == 5 and len(b["pred_boxes"]) >= 1
    np.testing.assert_allclose(b["pred_boxes"], a["pred_boxes"], atol=1e-3)
    np.testing.assert_array_equal(b["pred_masks"], a["pred_masks"])
    assert td.dispatches == 1


def test_detector2d_takes_a_tensor_as_it_is(params):
    """dispatch takes an image tensor on the detector's device (the
    tracker's own upload of a keyframe image) as it is: a uint8 gray frame
    as a tensor and as a numpy array give equal detections."""
    _, tp = params
    td = tmr.Detector2D(params=tp, cfg=dataclasses.replace(TCFG, backbone_dtype="float32", score_threshold=0.0),
                        device="cpu")
    td.class_ids = [0, 1, 2, 3]
    img = np.random.default_rng(2).integers(0, 256, (96, 128), dtype=np.uint8)
    a, b = td.make_prediction(img), td.make_prediction(torch.from_numpy(img))
    assert len(a["pred_boxes"]) >= 1 and td.dispatches == 2
    np.testing.assert_array_equal(b["pred_boxes"], a["pred_boxes"])
    np.testing.assert_array_equal(b["pred_masks"], a["pred_masks"])


def test_detector_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tmr.Detector2D(cfg=TCFG)
