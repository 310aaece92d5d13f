"""Mask R-CNN 2D instance segmentation, PyTorch inference.

Port of dspslam_tpu/detect/maskrcnn.py, the reference's mmdet wrapper
(reconstruct/detector2d.py + configs/config_maskrcnn.py) rebuilt from
scratch:

  (test_scale: bilinear resize, zero pad to size_divisor)
  -> ResNet-50 (BN folded) -> FPN (P2..P6) -> RPN -> fixed-K proposals
  -> RoIAlign (7x7) -> box head (2 FC) -> per-class decode + NMS
  -> RoIAlign (14x14) on kept boxes -> mask head (4 convs, a 2x2
  stride-2 transposed convolution) -> 28x28 masks
  -> boxes scaled back, masks pasted at the input's size (host)

Every stage has a fixed shape (top-k and validity flags, no dynamic
filtering), greedy NMS is a fixed-K loop over device tensors, and nothing
between the image upload and the pinned copies of the outputs waits for
the device, so `Detector2D.dispatch` returns while the card works. The
backbone runs in `backbone_dtype` (bf16 by default, JAX's own choice); the
heads and all box math run in f32 with TF32 off. RoIAlign is the gather
form (JAX's `roi_align_matmul` works around slow TPU gathers and is not
ported). `load_mmdet_checkpoint` ingests mmdet 2.x .pth weights with
BatchNorm folding.

mmdetection's test pipeline (mask_rcnn_r50_fpn_1x_coco.py) is the
configuration's: `test_scale` (1333, 800) resizes the image keeping its
aspect ratio (376 x 1241 -> 404 x 1333) and pads it to a multiple of
`size_divisor` (416 x 1344); the RPN keeps the best `rpn_pre_nms` anchors
of each level, suppresses within each level (`rpn_nms_across_levels`
False, mmdet's batched NMS over level ids) and keeps `rpn_post_nms`
proposals; the R-CNN keeps `max_detections`. The defaults keep the JAX
package's cut (native size, 512 / 128, NMS across levels, 16).

The stage functions (`resnet_fpn`, `rpn_heads`, `rpn_select`, `box_head`,
`select_boxes`, `mask_head`) are module attributes that `detect` calls
through the module: the benchmark's check taps them.

The validity filter matches the reference Detector2D (detector2d.py:87-100):
margin crop, min area, score >= 0.70; the class table {"cars": [2],
"chairs": [56, 57]} follows detector2d.py:29.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..slam.map import entry_device, to_torch
from ..slam.tracking import _host_result, _prefetch_to_host
from ..utils import timing
from .layers import conv2d_same, conv_transpose2d, he_normal, max_pool_same, resize_nearest, top_k, tree_map, true_div
from .layers import params_from_jax  # noqa: F401  (JAX numpy pytree -> tensors)

OBJECT_CLASS_TABLE = {"cars": [2], "chairs": [56, 57]}
RPN_STRIDES = (4, 8, 16, 32, 64)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    num_classes: int = 80
    # resnet
    stage_blocks: tuple = (3, 4, 6, 3)
    stem_channels: int = 64
    fpn_channels: int = 256
    # rpn
    anchor_scales: tuple = (8.0,)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    rpn_pre_nms: int = 512           # candidates kept per level
    rpn_post_nms: int = 128          # proposals kept after NMS
    rpn_nms_iou: float = 0.7
    # False: suppress only within each level (mmdet's test_cfg.rpn)
    rpn_nms_across_levels: bool = True
    # resnet+FPN compute dtype (the JAX package's inference default; its
    # trainer uses float32); the RPN / RoI heads and box math stay f32
    backbone_dtype: str = "bfloat16"
    # heads
    roi_size: int = 7
    mask_roi_size: int = 14
    fc_dim: int = 1024
    score_threshold: float = 0.70
    nms_iou: float = 0.5
    max_detections: int = 16
    # the test pipeline: (long, short) edge limits of a keep-ratio resize
    # (None: the image as it comes), and the padding's multiple
    test_scale: tuple | None = None
    size_divisor: int = 32


# ---------------------------------------------------------------------------
# params


def _conv(gen, cin, cout, k):
    return {"w": he_normal(gen, (cout, cin, k, k), cin * k * k), "b": torch.zeros(cout)}


def _fc(gen, din, dout):
    return {"w": he_normal(gen, (din, dout), din), "b": torch.zeros(dout)}


def init_params(cfg: MaskRCNNConfig, gen: torch.Generator | None = None, device=None) -> dict:
    """He-normal weights and zero biases from a seeded generator (seed 0
    when none is given), in the JAX package's tree layout."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    p = {"stem": _conv(gen, 3, cfg.stem_channels, 7), "stages": []}
    cin = cfg.stem_channels
    width = cfg.stem_channels
    for n_blocks in cfg.stage_blocks:
        cout = width * 4
        blocks = []
        for bi in range(n_blocks):
            blk = {
                "conv1": _conv(gen, cin if bi == 0 else cout, width, 1),
                "conv2": _conv(gen, width, width, 3),
                "conv3": _conv(gen, width, cout, 1),
            }
            if bi == 0:
                blk["down"] = _conv(gen, cin, cout, 1)
            blocks.append(blk)
        p["stages"].append(blocks)
        cin = cout
        width *= 2
    c = cfg.fpn_channels
    stage_out = [cfg.stem_channels * 4 * 2**i for i in range(4)]
    p["lateral"] = [_conv(gen, ch, c, 1) for ch in stage_out]
    p["fpn_out"] = [_conv(gen, c, c, 3) for _ in range(4)]
    n_anchor = len(cfg.anchor_scales) * len(cfg.anchor_ratios)
    p["rpn_conv"] = _conv(gen, c, c, 3)
    p["rpn_cls"] = _conv(gen, c, n_anchor, 1)
    p["rpn_reg"] = _conv(gen, c, n_anchor * 4, 1)
    din = c * cfg.roi_size * cfg.roi_size
    p["fc1"] = _fc(gen, din, cfg.fc_dim)
    p["fc2"] = _fc(gen, cfg.fc_dim, cfg.fc_dim)
    p["cls"] = _fc(gen, cfg.fc_dim, cfg.num_classes + 1)
    p["reg"] = _fc(gen, cfg.fc_dim, cfg.num_classes * 4)
    p["mask_convs"] = [_conv(gen, c, c, 3) for _ in range(4)]
    # a transposed convolution: (in, out, 2, 2), each input pixel its own 2x2 block
    p["mask_deconv"] = {"w": he_normal(gen, (c, c, 2, 2), c), "b": torch.zeros(c)}
    p["mask_logits"] = _conv(gen, c, cfg.num_classes, 1)
    return tree_map(lambda t: t.to(device), p)


# ---------------------------------------------------------------------------
# backbone


def resnet_fpn(params, img: torch.Tensor, cfg: MaskRCNNConfig) -> list:
    """(1, 3, H, W) normalized image -> [P2, P3, P4, P5, P6] f32 features
    (the backbone itself runs in cfg.backbone_dtype)."""
    x = torch.relu(conv2d_same(img.to(getattr(torch, cfg.backbone_dtype)), params["stem"], 2))
    x = max_pool_same(x, 3, 2)
    feats = []
    for si, blocks in enumerate(params["stages"]):
        stride = 1 if si == 0 else 2
        for bi, blk in enumerate(blocks):
            s = stride if bi == 0 else 1
            identity = x
            h = torch.relu(conv2d_same(x, blk["conv1"]))
            h = torch.relu(conv2d_same(h, blk["conv2"], s))
            h = conv2d_same(h, blk["conv3"])
            if "down" in blk:
                identity = conv2d_same(x, blk["down"], s)
            x = torch.relu(h + identity)
        feats.append(x)
    # FPN top-down
    laterals = [conv2d_same(f, lp) for f, lp in zip(feats, params["lateral"])]
    for i in range(len(laterals) - 1, 0, -1):
        laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i], laterals[i - 1].shape[-2:])
    outs = [torch.relu(conv2d_same(l, op)).float() for l, op in zip(laterals, params["fpn_out"])]
    # P6: a 1x1 window at stride 2 under SAME padding (which pads nothing)
    return outs + [outs[-1][..., ::2, ::2]]          # strides 4, 8, 16, 32, 64


# ---------------------------------------------------------------------------
# boxes


def _level_anchors(hw, stride: int, cfg: MaskRCNNConfig, device) -> torch.Tensor:
    """(h * w * A, 4) xyxy anchors of one level, built on `device` in
    float64 and rounded to f32 as JAX's numpy table is."""
    h, w = hw
    ys = (torch.arange(h, dtype=torch.float64, device=device) + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float64, device=device) + 0.5) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    out = []
    for scale in cfg.anchor_scales:
        for ratio in cfg.anchor_ratios:
            size = scale * stride
            aw = size * np.sqrt(1.0 / ratio)
            ah = size * np.sqrt(ratio)
            out.append(torch.stack([gx - aw / 2, gy - ah / 2, gx + aw / 2, gy + ah / 2], dim=-1))
    return torch.stack(out, dim=2).reshape(-1, 4).to(torch.float32)


def decode_deltas(deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Standard (dx, dy, dw, dh) decoding on xyxy boxes."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + w / 2
    cy = boxes[:, 1] + h / 2
    ncx = cx + deltas[:, 0] * w
    ncy = cy + deltas[:, 1] * h
    nw = torch.exp(torch.clamp(deltas[:, 2], -4, 4)) * w
    nh = torch.exp(torch.clamp(deltas[:, 3], -4, 4)) * h
    return torch.stack([ncx - nw / 2, ncy - nh / 2, ncx + nw / 2, ncy + nh / 2], dim=-1)


def _clip_boxes(boxes: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return torch.stack([boxes[:, 0].clamp(0.0, W), boxes[:, 1].clamp(0.0, H),
                        boxes[:, 2].clamp(0.0, W), boxes[:, 3].clamp(0.0, H)], dim=-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter, min=1e-6)


def greedy_suppress(iou: torch.Tensor, scores: torch.Tensor, k: int, iou_thresh: float,
                    dead: float, keep):
    """Fixed-K greedy NMS over a precomputed (n, n) overlap matrix: k rounds
    of "take the best live candidate (the first among equal scores), drop
    those that overlap it above iou_thresh"; `keep(s)` says whether a pick
    with score s is a detection. Sync-free: every index stays on the device.
    Returns (picked indices (k,), their scores (k,), ok (k,) bool)."""
    alive = torch.ones_like(scores)
    picks, vals, oks = [], [], []
    for _ in range(k):
        masked = torch.where(alive > 0, scores, dead)
        j = torch.argmax(masked, dim=0, keepdim=True)
        s = masked.gather(0, j)
        ok = keep(s)
        suppress = ok & (iou.index_select(0, j)[0] > iou_thresh)
        alive = torch.where(suppress, 0.0, alive).scatter(0, j, 0.0)
        picks.append(j)
        vals.append(s)
        oks.append(ok)
    return torch.cat(picks), torch.cat(vals), torch.cat(oks)


def greedy_nms(boxes, scores, k: int, iou_thresh: float, score_thresh: float = -float("inf"), groups=None):
    """Fixed-K greedy NMS: returns (boxes (k, 4), scores (k,), valid (k,)).
    With `groups` (n,) a box suppresses only boxes of its own group."""
    iou = iou_matrix(boxes, boxes)
    if groups is not None:
        iou = torch.where(groups[:, None] == groups[None, :], iou, 0.0)
    timing.count("det2d_nms_rounds", k)
    j, s, ok = greedy_suppress(iou, scores, k, iou_thresh, -1e9, lambda s: s > score_thresh)
    kb = torch.where(ok[:, None], boxes.index_select(0, j), 0.0)
    return kb, torch.where(ok, s, 0.0), ok.to(torch.float32)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """(C, H, W) feature + (N, 4) xyxy boxes in feature coords ->
    (N, C, out, out) bilinear crops sampled at bin centres (the gather
    form of JAX's `roi_align`)."""
    C, H, W = feat.shape
    c = true_div(torch.arange(out_size, dtype=torch.float32, device=feat.device) + 0.5, out_size)
    y = boxes[:, 1:2] + c[None] * torch.clamp(boxes[:, 3:4] - boxes[:, 1:2], min=1e-3)   # (N, o)
    x = boxes[:, 0:1] + c[None] * torch.clamp(boxes[:, 2:3] - boxes[:, 0:1], min=1e-3)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    fy = torch.clamp(y - y0, 0.0, 1.0)[None, :, :, None]        # (1, N, o, 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)[None, :, None, :]        # (1, N, 1, o)
    Y0, X0 = y0[:, :, None], x0[:, None, :]
    f00 = feat[:, Y0, X0]                                          # (C, N, o, o)
    f01 = feat[:, Y0, X0 + 1]
    f10 = feat[:, Y0 + 1, X0]
    f11 = feat[:, Y0 + 1, X0 + 1]
    out = (f00 * (1 - fy) * (1 - fx) + f01 * (1 - fy) * fx
           + f10 * fy * (1 - fx) + f11 * fy * fx)
    return out.permute(1, 0, 2, 3)


def fpn_level_of(boxes: torch.Tensor) -> torch.Tensor:
    """mmdet's FPN RoI level, floor(4 + log2(sqrt(w*h)/224)) clamped to
    P2..P5, as an index 0..3 into [P2, P3, P4, P5]."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    scale = torch.sqrt(torch.clamp(w * h, min=1e-6))
    lvl = torch.floor(4.0 + torch.log2(true_div(scale, 224.0) + 1e-8))
    return (torch.clamp(lvl, 2.0, 5.0) - 2.0).to(torch.int64)


def roi_align_fpn(feats, boxes: torch.Tensor, out_size: int, strides=(4, 8, 16, 32)) -> torch.Tensor:
    """Multi-level RoIAlign: each box samples the FPN level matching its
    scale. Aligns against all four levels and takes each box's own (JAX
    selects with a one-hot einsum, which gives the same finite values)."""
    lvl = fpn_level_of(boxes)
    outs = torch.stack([roi_align(feats[i][0], boxes / strides[i], out_size) for i in range(4)])
    return outs[lvl, torch.arange(boxes.shape[0], device=boxes.device)]


# ---------------------------------------------------------------------------
# full forward


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) or (H, W) uint8/float -> (1, 3, H, W) f32 with ImageNet
    normalization (grayscale is tiled on the device)."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None].expand(*img.shape, 3)
    x = true_div(img, 255.0)
    chans = [true_div(x[..., c] - m, s) for c, (m, s) in enumerate(zip(IMAGENET_MEAN, IMAGENET_STD))]
    return torch.stack(chans, dim=0)[None]


def rpn_level_outputs(params, f: torch.Tensor):
    """One FPN level through the RPN heads -> (scores (A*h*w,), deltas
    (A*h*w, 4)) in the anchor layout of _level_anchors."""
    h = torch.relu(conv2d_same(f, params["rpn_conv"]))
    cls = conv2d_same(h, params["rpn_cls"])[0]                # (A, h, w)
    reg = conv2d_same(h, params["rpn_reg"])[0]                # (A*4, h, w)
    n_anchor = cls.shape[0]
    hw = cls.shape[-2:]
    scores = cls.permute(1, 2, 0).reshape(-1)
    deltas = reg.reshape(n_anchor, 4, *hw).permute(2, 3, 0, 1).reshape(-1, 4)
    return scores, deltas


def rpn_heads(params, feats) -> list:
    """The RPN heads on every FPN level -> [(scores, deltas)] per level."""
    return [rpn_level_outputs(params, f) for f in feats]


def rpn_select(level_outputs, level_hw, image_hw, cfg: MaskRCNNConfig):
    """The RPN's per-level top-k, delta decode and clip, then greedy NMS
    over all levels, or within each level (`rpn_nms_across_levels`
    False) -> ((rpn_post_nms, 4) proposals, validity). A round that finds
    no live candidate gives an invalid proposal."""
    H, W = image_hw
    all_boxes, all_scores, all_levels = [], [], []
    for lvl, ((scores, deltas), hw, stride) in enumerate(zip(level_outputs, level_hw, RPN_STRIDES)):
        anchors = _level_anchors(hw, stride, cfg, scores.device)
        top, idx = top_k(scores, min(cfg.rpn_pre_nms, scores.shape[0]))
        boxes = decode_deltas(deltas.index_select(0, idx), anchors.index_select(0, idx))
        all_boxes.append(_clip_boxes(boxes, H, W))
        all_scores.append(top)
        all_levels.append(torch.full(top.shape, lvl, dtype=torch.int64, device=top.device))
    groups = None if cfg.rpn_nms_across_levels else torch.cat(all_levels)
    proposals, _, prop_valid = greedy_nms(torch.cat(all_boxes), torch.cat(all_scores),
                                          cfg.rpn_post_nms, cfg.rpn_nms_iou, score_thresh=-1e9, groups=groups)
    return proposals, prop_valid


def rpn_propose(params, feats, image_hw, cfg: MaskRCNNConfig):
    """Full RPN proposal stage (heads -> per-level top-k -> delta decode ->
    clip -> greedy NMS) -> ((rpn_post_nms, 4) boxes, validity)."""
    return rpn_select(rpn_heads(params, feats), [f.shape[-2:] for f in feats], image_hw, cfg)


def box_head(params, feats, proposals, prop_valid, image_hw, cfg: MaskRCNNConfig):
    """RoIAlign (FPN level per box) -> 2 FC -> per-class decode of each
    proposal's best class -> (boxes (N, 4), best_score (N,), best_cls (N,),
    class probabilities (N, num_classes))."""
    H, W = image_hw
    roi_feat = roi_align_fpn(feats, proposals, cfg.roi_size)   # (N, C, 7, 7)
    flat = roi_feat.reshape(roi_feat.shape[0], -1)
    h1 = torch.relu(flat @ params["fc1"]["w"] + params["fc1"]["b"])
    h2 = torch.relu(h1 @ params["fc2"]["w"] + params["fc2"]["b"])
    cls_logits = h2 @ params["cls"]["w"] + params["cls"]["b"]
    reg = h2 @ params["reg"]["w"] + params["reg"]["b"]
    probs = torch.softmax(cls_logits, dim=-1)[:, 1:]           # drop background
    best_cls = torch.argmax(probs, dim=-1)
    best_score = torch.amax(probs, dim=-1) * prop_valid
    reg_c = torch.gather(reg.reshape(-1, cfg.num_classes, 4), 1,
                         best_cls[:, None, None].expand(-1, 1, 4))[:, 0]
    boxes = _clip_boxes(decode_deltas(reg_c, proposals), H, W)
    return boxes, best_score, best_cls, probs


def select_boxes(boxes, best_score, best_cls, cfg: MaskRCNNConfig):
    """Class-agnostic greedy NMS of the decoded boxes -> (kept boxes,
    scores, valid, labels); a kept box's label is that of the candidate it
    overlaps most (the first among equal overlaps)."""
    kept_boxes, kept_scores, kept_valid = greedy_nms(
        boxes, best_score, cfg.max_detections, cfg.nms_iou, score_thresh=0.05)
    match = torch.argmax(iou_matrix(kept_boxes, boxes), dim=1)
    return kept_boxes, kept_scores, kept_valid, best_cls.index_select(0, match)


def mask_head(params, feats, kept_boxes, kept_labels, cfg: MaskRCNNConfig) -> torch.Tensor:
    """RoIAlign (14x14, same level rule) -> 4 convs -> 2x2 stride-2
    transposed conv -> per-class logits -> each box's own class (N, 28, 28)."""
    h = roi_align_fpn(feats, kept_boxes, cfg.mask_roi_size)
    for cp in params["mask_convs"]:
        h = torch.relu(conv2d_same(h, cp))
    h = torch.relu(conv_transpose2d(h, params["mask_deconv"]))
    mask_logits = conv2d_same(h, params["mask_logits"])          # (N, classes, 28, 28)
    idx = kept_labels[:, None, None, None].expand(-1, 1, *mask_logits.shape[-2:])
    return torch.gather(mask_logits, 1, idx)[:, 0]


def input_size(image_hw, cfg: MaskRCNNConfig) -> tuple:
    """The network's (h, w) for an image of `image_hw` before padding:
    mmcv's keep-ratio rescale, the largest factor that keeps the long edge
    within test_scale's long limit and the short edge within its short
    one, sizes rounded half up; the image's own size without test_scale."""
    h, w = image_hw
    if cfg.test_scale is None:
        return h, w
    f = min(max(cfg.test_scale) / max(h, w), min(cfg.test_scale) / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def prepare_image(img: torch.Tensor, cfg: MaskRCNNConfig) -> torch.Tensor:
    """(H, W, 3) or (H, W) image -> the network's (1, 3, Hp, Wp) input:
    with test_scale, a bilinear resize (half-pixel centres, no
    antialiasing) to input_size, the ImageNet normalization, then zeros
    below and right up to a multiple of size_divisor (mmdet's Resize,
    Normalize, Pad); without it, normalize_image."""
    if cfg.test_scale is None:
        return normalize_image(img)
    img = img.to(torch.float32)
    x = img[None, None] if img.ndim == 2 else img.permute(2, 0, 1)[None]
    h, w = input_size(img.shape[:2], cfg)
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    x = normalize_image(x[0, 0] if img.ndim == 2 else x[0].permute(1, 2, 0))
    d = cfg.size_divisor
    return F.pad(x, (0, -(-w // d) * d - w, 0, -(-h // d) * d - h))


def detect(params, img: torch.Tensor, image_hw: tuple, cfg: MaskRCNNConfig) -> dict:
    """(H, W, 3) uint8/float image tensor (or (H, W) grayscale, tiled on
    the device) -> dict(boxes (K, 4), scores (K,), labels (K,), valid (K,),
    mask_logits (K, 28, 28)), all on img's device, with no host sync.
    Boxes are in the network's frame (input_size(image_hw, cfg))."""
    image_hw = input_size(image_hw, cfg)
    feats = resnet_fpn(params, prepare_image(img, cfg), cfg)
    proposals, prop_valid = rpn_propose(params, feats, image_hw, cfg)
    boxes, best_score, best_cls, _ = box_head(params, feats, proposals, prop_valid, image_hw, cfg)
    kept_boxes, kept_scores, kept_valid, kept_labels = select_boxes(boxes, best_score, best_cls, cfg)
    return {
        "boxes": kept_boxes, "scores": kept_scores, "labels": kept_labels,
        "valid": kept_valid, "mask_logits": mask_head(params, feats, kept_boxes, kept_labels, cfg),
    }


def _resize_bilinear_np(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pure-numpy point-sampled bilinear resize (half-pixel centers; no
    antialiasing on downscale: boxes smaller than the 28x28 logit grid are
    excluded by the reference's min_bb_area=1600 validity filter,
    detector2d.py:87-100, so the paste path only upsamples in practice)."""
    sh, sw = m.shape
    y = (np.arange(h) + 0.5) * sh / h - 0.5
    x = (np.arange(w) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(y).astype(np.int64), 0, sh - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = np.clip(y - y0, 0.0, 1.0)[:, None]
    fx = np.clip(x - x0, 0.0, 1.0)[None, :]
    return (
        m[y0[:, None], x0[None, :]] * (1 - fy) * (1 - fx)
        + m[y0[:, None], x1[None, :]] * (1 - fy) * fx
        + m[y1[:, None], x0[None, :]] * fy * (1 - fx)
        + m[y1[:, None], x1[None, :]] * fy * fx
    )


def paste_masks(boxes, mask_logits, valid, image_hw):
    """28x28 logits -> full-resolution boolean instance masks (host)."""
    H, W = image_hw
    out = np.zeros((len(boxes), H, W), bool)
    for i, (b, m, v) in enumerate(zip(boxes, mask_logits, valid)):
        if v <= 0:
            continue
        x0, y0, x1, y1 = [int(round(float(t))) for t in b]
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, W), min(y1, H)
        if x1 <= x0 or y1 <= y0:
            continue
        resized = _resize_bilinear_np(np.asarray(m), y1 - y0, x1 - x0)
        out[i, y0:y1, x0:x1] = resized > 0.0
    return out


class Detector2D:
    """Online 2D detector (the reference detector2d.py API). `device` None
    means cuda; cuda without a card raises."""

    def __init__(self, params=None, cfg: MaskRCNNConfig = MaskRCNNConfig(),
                 object_class: str = "cars", device=None):
        self.device = entry_device(device, "Detector2D")
        self.cfg = cfg
        params = params if params is not None else init_params(cfg)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.class_ids = OBJECT_CLASS_TABLE.get(object_class, [2])
        self.dispatches = 0

    def dispatch(self, img) -> dict:
        """Async half of make_prediction: upload the image (a tensor on the
        detector's device, such as the tracker's upload of a keyframe image,
        is taken as it is), enqueue the network and start pinned copies of
        its outputs, without waiting for the device. Returns a handle for
        collect()."""
        with timing.span("det2d_dispatch"):
            if isinstance(img, torch.Tensor):
                img = img.to(self.device)
            else:
                img = np.asarray(img)
                img = to_torch(img.astype(np.float32) if img.dtype == np.float64 else img, self.device)
            hw = tuple(img.shape[:2])
            out = detect(self.params, img, hw, self.cfg)
            host, event = _prefetch_to_host({"out": out})
            self.dispatches += 1
        return {"host": host, "event": event, "hw": hw}

    def collect(self, handle) -> dict:
        """Wait for a dispatch's outputs: boxes scaled back to the input
        image, the class and score filter, masks pasted at its size."""
        out = _host_result(handle["host"], handle["event"])["out"]
        boxes, scores, labels = out["boxes"], out["scores"], out["labels"]
        h, w = handle["hw"]
        nh, nw = input_size(handle["hw"], self.cfg)
        boxes = boxes / np.asarray([nw / w, nh / h, nw / w, nh / h], np.float32)
        keep = (out["valid"] > 0) & np.isin(labels, self.class_ids) & (scores >= self.cfg.score_threshold)
        timing.count("det2d_kept", int(keep.sum()))
        masks = paste_masks(boxes, out["mask_logits"], keep.astype(np.float32), handle["hw"])
        return {
            "pred_boxes": np.concatenate([boxes[keep], scores[keep, None]], axis=-1),
            "pred_masks": masks[keep],
        }

    def make_prediction(self, img_rgb: np.ndarray) -> dict:
        """(H, W, 3) or (H, W) -> {'pred_boxes': (M, 5), 'pred_masks': (M, H, W)}."""
        return self.collect(self.dispatch(img_rgb))


def get_valid_detections(boxes, masks, image_hw, min_bb_area=1600.0,
                         margin=(30, 10, 30, 10), min_score=0.70):
    """Reference Detector2D validity filter (detector2d.py:87-100): boxes
    within margins, area above threshold, score gate."""
    h, w = image_hw
    keep = []
    for i, b in enumerate(boxes):
        x0, y0, x1, y1 = b[:4]
        score = b[4] if len(b) > 4 else 1.0
        area = (x1 - x0) * (y1 - y0)
        inside = (
            x0 >= margin[0] and y0 >= margin[1]
            and x1 <= w - margin[2] and y1 <= h - margin[3]
        )
        if inside and area > min_bb_area and score >= min_score:
            keep.append(i)
    return boxes[keep], masks[keep]


# ---------------------------------------------------------------------------
# mmdet checkpoint ingestion


def _fold_bn(w, bn_w, bn_b, bn_mean, bn_var, eps=1e-5):
    scale = bn_w / np.sqrt(bn_var + eps)
    return w * scale[:, None, None, None], (0.0 - bn_mean) * scale + bn_b


# mmdet 2.x's R-CNN box coder (DeltaXYWHBBoxCoder of Shared2FCBBoxHead)
RCNN_TARGET_STDS = (0.1, 0.1, 0.2, 0.2)


def load_mmdet_checkpoint(path: str, cfg: MaskRCNNConfig = MaskRCNNConfig()) -> dict:
    """Ingest an mmdet 2.x Mask R-CNN R50-FPN .pth by key convention -> a
    parameter tree of CPU f32 tensors. mmdet 2.x puts the background
    class last in `fc_cls` and decodes `fc_reg` with target stds (0.1,
    0.1, 0.2, 0.2): the classifier's background row moves first, as
    `box_head` reads it, and the stds fold into `fc_reg`'s rows. The
    mask head's upsample is a ConvTranspose2d; its (in, out, 2, 2) kernel
    is taken as it is."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    sd = saved.get("state_dict", saved)
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    params = init_params(cfg)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def conv_bn(conv_key, bn_key):
        w, b = _fold_bn(sd[conv_key + ".weight"], sd[bn_key + ".weight"], sd[bn_key + ".bias"],
                        sd[bn_key + ".running_mean"], sd[bn_key + ".running_var"])
        return {"w": t(w), "b": t(b)}

    def conv_plain(key):
        return {"w": t(sd[key + ".weight"]), "b": t(sd[key + ".bias"])}

    def fc(key):
        return {"w": t(sd[key + ".weight"].T), "b": t(sd[key + ".bias"])}

    params["stem"] = conv_bn("backbone.conv1", "backbone.bn1")
    for si in range(4):
        for bi in range(cfg.stage_blocks[si]):
            base = f"backbone.layer{si + 1}.{bi}"
            blk = params["stages"][si][bi]
            blk["conv1"] = conv_bn(base + ".conv1", base + ".bn1")
            blk["conv2"] = conv_bn(base + ".conv2", base + ".bn2")
            blk["conv3"] = conv_bn(base + ".conv3", base + ".bn3")
            if bi == 0:
                blk["down"] = conv_bn(base + ".downsample.0", base + ".downsample.1")
    for i in range(4):
        params["lateral"][i] = conv_plain(f"neck.lateral_convs.{i}.conv")
        params["fpn_out"][i] = conv_plain(f"neck.fpn_convs.{i}.conv")
    params["rpn_conv"] = conv_plain("rpn_head.rpn_conv")
    params["rpn_cls"] = conv_plain("rpn_head.rpn_cls")
    params["rpn_reg"] = conv_plain("rpn_head.rpn_reg")
    params["fc1"] = fc("roi_head.bbox_head.shared_fcs.0")
    params["fc2"] = fc("roi_head.bbox_head.shared_fcs.1")
    cls = fc("roi_head.bbox_head.fc_cls")
    order = [cfg.num_classes] + list(range(cfg.num_classes))
    params["cls"] = {"w": cls["w"][:, order], "b": cls["b"][order]}
    stds = torch.tensor(RCNN_TARGET_STDS * cfg.num_classes)
    reg = fc("roi_head.bbox_head.fc_reg")
    params["reg"] = {"w": reg["w"] * stds, "b": reg["b"] * stds}
    for i in range(4):
        params["mask_convs"][i] = conv_plain(f"roi_head.mask_head.convs.{i}.conv")
    params["mask_deconv"] = conv_plain("roi_head.mask_head.upsample")
    params["mask_logits"] = conv_plain("roi_head.mask_head.conv_logits")
    return params
