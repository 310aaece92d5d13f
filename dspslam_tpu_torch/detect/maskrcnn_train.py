"""Synthetic closed-loop training of the Mask R-CNN stack.

Port of dspslam_tpu/detect/maskrcnn_train.py. No pretrained weights are in
the repository, so this trains the from-scratch network (detect/maskrcnn.py)
on a generated scene with planted box + mask instances until it fits. That
proves the inference chain is wired consistently: the anchor grids match
the RPN head's layout, the delta codec round-trips, RoIAlign samples where
the boxes say, the class indexing matches Detector2D's filter, and the mask
head with `paste_masks` reproduces the planted silhouettes (the
make_prediction contract of the reference's detector2d.py:59-86).

The training forward calls the functions inference calls (`resnet_fpn`,
`rpn_level_outputs`, `roi_align_fpn`, `conv2d_same`, `conv_transpose2d`), in
float32 (`small_config`). The JAX trainer selects each box's FPN level with
a one-hot einsum and the port with a per-box gather; both send a box's
gradient to its own level only.

The losses are the standard Mask R-CNN ones, at fixed shapes:
  * RPN: balanced BCE on objectness (positive IoU > 0.5, negative < 0.3)
    and smooth L1 on the deltas of positive anchors, over all FPN levels;
  * RoI heads: trained on ground-truth boxes and jittered copies as
    proposals (softmax CE, smooth L1 on the car class's deltas, BCE on the
    car class's mask against the 28 x 28 crop of the instance mask), plus
    the live RPN's own post-NMS proposals refreshed every `refresh` steps
    (hard-proposal mining; every step by default, R8): without them,
    inference-time proposals can fall outside the jitter distribution and be
    confidently misclassified.

Scene generation, delta encoding, anchors and targets are numpy copies of
the JAX package's; the optimizer is torch.optim.Adam with optax.adam's
defaults (`layers.Trainer`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..slam.map import entry_device
from . import maskrcnn as mr
from .layers import Trainer, conv2d_same, conv_transpose2d, leaves, trainable, tree_map

# Detector2D's labels come from argmax over softmax(cls_logits)[:, 1:], so
# its "cars" filter (label 2, OBJECT_CLASS_TABLE) selects logit column 3
CAR_LABEL = 2
CAR_LOGIT_COL = CAR_LABEL + 1


def small_config() -> mr.MaskRCNNConfig:
    """A test-sized architecture: the same topology, ~1/60 the parameters,
    a float32 backbone for float32 gradients."""
    return mr.MaskRCNNConfig(num_classes=4, stage_blocks=(1, 1, 1, 1), stem_channels=8, fpn_channels=32,
                             backbone_dtype="float32", rpn_pre_nms=256, rpn_post_nms=32, fc_dim=64,
                             max_detections=8)


# ---------------------------------------------------------------------------
# scene generation (numpy)


def make_scene(rng: np.random.Generator, h=192, w=256, n_obj=3):
    """Noise background and bright two-tone rectangles ("cars"). Returns
    (img (H, W, 3) uint8, gt_boxes (N, 4) xyxy, gt_masks (N, H, W) f32)."""
    img = rng.normal(70, 5, (h, w, 3)).astype(np.float32)
    boxes, masks = [], []
    for i in range(n_obj):
        bw = int(rng.integers(44, 64))
        bh = int(rng.integers(28, 40))
        x0 = int(rng.integers(32, w - 32 - bw))
        y0 = int(rng.integers(16, h - 16 - bh))
        # a two-tone interior gives the instance internal structure
        img[y0: y0 + bh, x0: x0 + bw] = 160.0 + 20.0 * i
        img[y0: y0 + bh // 2, x0: x0 + bw] = 120.0 + 20.0 * i
        m = np.zeros((h, w), np.float32)
        m[y0: y0 + bh, x0: x0 + bw] = 1.0
        boxes.append([x0, y0, x0 + bw, y0 + bh])
        masks.append(m)
    return np.clip(img, 0, 255).astype(np.uint8), np.asarray(boxes, np.float32), np.stack(masks)


# ---------------------------------------------------------------------------
# targets (numpy)


def encode_deltas(gt: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Inverse of maskrcnn.decode_deltas, in float32."""
    gt, boxes = np.asarray(gt, np.float32), np.asarray(boxes, np.float32)
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + w / 2
    cy = boxes[:, 1] + h / 2
    gw = np.maximum(gt[:, 2] - gt[:, 0], np.float32(1e-3))
    gh = np.maximum(gt[:, 3] - gt[:, 1], np.float32(1e-3))
    gcx = gt[:, 0] + gw / 2
    gcy = gt[:, 1] + gh / 2
    w, h = np.maximum(w, np.float32(1e-3)), np.maximum(h, np.float32(1e-3))
    return np.stack([(gcx - cx) / w, (gcy - cy) / h, np.log(gw / w), np.log(gh / h)], axis=-1)


def iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """maskrcnn.iou_matrix on host arrays."""
    return mr.iou_matrix(torch.from_numpy(np.asarray(a, np.float32)),
                         torch.from_numpy(np.asarray(b, np.float32))).numpy()


def _feature_hw(h, w, stride):
    s = 1
    while s < stride:
        h, w = -(-h // 2), -(-w // 2)
        s *= 2
    return h, w


def all_anchors(image_hw, cfg: mr.MaskRCNNConfig) -> np.ndarray:
    """Concatenated anchors over P2..P6, in detect()'s RPN order."""
    h, w = image_hw
    return np.concatenate([mr._level_anchors(_feature_hw(h, w, s), s, cfg, "cpu").numpy()
                           for s in mr.RPN_STRIDES])


def rpn_targets(anchors: np.ndarray, gt: np.ndarray):
    """(labels (A,) {1 positive, 0 negative, -1 ignored}, deltas (A, 4))."""
    iou = iou_np(anchors, gt)
    best_gt = iou.argmax(axis=1)
    best_iou = iou.max(axis=1)
    labels = -np.ones(len(anchors), np.int32)
    labels[best_iou < 0.3] = 0
    labels[best_iou > 0.5] = 1
    # every gt claims its best anchor (the classic RPN rule)
    labels[iou.argmax(axis=0)] = 1
    best_gt[iou.argmax(axis=0)] = np.arange(len(gt))
    return labels, encode_deltas(gt[best_gt], anchors)


def roi_proposals(rng, gt: np.ndarray, per_gt=16):
    """GT boxes and jittered copies as RoI-head training proposals. Jitter
    tiers (tight, medium, far shift) emulate the spread of RPN proposals;
    labels follow the 0.5-IoU rule, so medium overlaps train as background
    (without them the class head calls any partial overlap a car and NMS
    keeps sloppy duplicates). Returns (proposals, class targets, match)."""
    props, match = [], []
    for gi, g in enumerate(gt):
        w, h = g[2] - g[0], g[3] - g[1]
        for j in range(per_gt):
            tier = j % 4
            sd = (0.06, 0.12, 0.35, 0.35)[tier]
            off = rng.normal(0, sd, 4) * np.asarray([w, h, w, h])
            if tier == 3:  # unambiguous background: far shift
                off = off + np.asarray([2.5 * w, 2.5 * h, 2.5 * w, 2.5 * h])
            p = g + off
            if p[2] - p[0] < 8:
                p[2] = p[0] + 8
            if p[3] - p[1] < 8:
                p[3] = p[1] + 8
            props.append(p)
            match.append(gi)
    props = np.asarray(props, np.float32)
    match = np.asarray(match, np.int32)
    iou = iou_np(props, gt)[np.arange(len(props)), match]
    return props, np.where(iou >= 0.5, CAR_LOGIT_COL, 0).astype(np.int32), match


def mask_targets(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Each box's 28 x 28 RoIAlign crop of its own instance mask, binarized
    at 0.5: masks (N, H, W), boxes (N, 4) -> (N, 28, 28) f32."""
    crops = [mr.roi_align(m[None], b[None], 28)[0, 0] for m, b in zip(masks, boxes)]
    return (torch.stack(crops) > 0.5).to(torch.float32)


# ---------------------------------------------------------------------------
# loss


def _smooth_l1(x, beta=1.0):
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def loss_fn(params, img: torch.Tensor, targets: dict, image_hw, cfg: mr.MaskRCNNConfig):
    """The Mask R-CNN loss on one image -> (total, dict of the five terms)."""
    feats = mr.resnet_fpn(params, mr.normalize_image(img), cfg)

    # RPN: the same per-level heads and anchor layout as detect()
    outs = mr.rpn_heads(params, feats)
    scores = torch.cat([s for s, _ in outs])
    deltas = torch.cat([d for _, d in outs])
    labels = targets["rpn_labels"]
    pos = (labels == 1).to(torch.float32)
    neg = (labels == 0).to(torch.float32)
    bce = F.binary_cross_entropy_with_logits(scores, pos, reduction="none")
    rpn_cls = (torch.sum(bce * pos) / torch.clamp(torch.sum(pos), min=1.0)
               + torch.sum(bce * neg) / torch.clamp(torch.sum(neg), min=1.0))
    reg_err = _smooth_l1(deltas - targets["rpn_deltas"]).sum(-1)
    rpn_reg = torch.sum(reg_err * pos) / torch.clamp(torch.sum(pos), min=1.0)

    # RoI heads on the proposals
    props = targets["proposals"]
    roi = mr.roi_align_fpn(feats, props, cfg.roi_size)
    flat = roi.reshape(roi.shape[0], -1)
    h1 = torch.relu(flat @ params["fc1"]["w"] + params["fc1"]["b"])
    h2 = torch.relu(h1 @ params["fc2"]["w"] + params["fc2"]["b"])
    cls_logits = h2 @ params["cls"]["w"] + params["cls"]["b"]
    reg = h2 @ params["reg"]["w"] + params["reg"]["b"]
    cls_t = targets["roi_cls"]
    roi_cls = torch.mean(F.cross_entropy(cls_logits, cls_t.to(torch.int64), reduction="none"))
    fg = (cls_t > 0).to(torch.float32)
    reg_c = reg.reshape(-1, cfg.num_classes, 4)[:, CAR_LOGIT_COL - 1]
    roi_reg = (torch.sum(_smooth_l1(reg_c - targets["roi_deltas"]).sum(-1) * fg)
               / torch.clamp(torch.sum(fg), min=1.0))

    # mask head on the same proposals
    hm = mr.roi_align_fpn(feats, props, cfg.mask_roi_size)
    for cp in params["mask_convs"]:
        hm = torch.relu(conv2d_same(hm, cp))
    hm = torch.relu(conv_transpose2d(hm, params["mask_deconv"]))
    mask_logits = conv2d_same(hm, params["mask_logits"])[:, CAR_LOGIT_COL - 1]
    mask_bce = F.binary_cross_entropy_with_logits(mask_logits, targets["mask_targets"],
                                                  reduction="none").mean(dim=(1, 2))
    mask = torch.sum(mask_bce * fg) / torch.clamp(torch.sum(fg), min=1.0)

    total = rpn_cls + rpn_reg + roi_cls + roi_reg + mask
    return total, {"rpn_cls": rpn_cls, "rpn_reg": rpn_reg, "roi_cls": roi_cls, "roi_reg": roi_reg, "mask": mask}


def train_step(params, trainer: Trainer, img: torch.Tensor, targets: dict, image_hw, cfg: mr.MaskRCNNConfig):
    """One Adam step over a trainable parameter tree -> (loss, terms), device
    scalars (no host sync)."""
    loss, aux = loss_fn(params, img, targets, image_hw, cfg)
    trainer.step(loss)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


@torch.no_grad()
def rpn_proposals(params, img: torch.Tensor, image_hw, cfg: mr.MaskRCNNConfig):
    """The live RPN's post-NMS proposals (the rpn_propose stage detect()
    runs): ((rpn_post_nms, 4) boxes, validity)."""
    return mr.rpn_propose(params, mr.resnet_fpn(params, mr.normalize_image(img), cfg), image_hw, cfg)


def mine_rpn_targets(params, img: torch.Tensor, gt_boxes: np.ndarray, gt_masks: np.ndarray, image_hw, cfg):
    """RoI-head targets from the RPN's own current proposals (hard-proposal
    mining): labels by the 0.5-IoU rule, deltas and masks from each
    proposal's best-overlap instance. Invalid NMS slots are (0, 0, 0, 0)
    boxes, IoU 0, so background. Returns device tensors (proposals, class
    targets, deltas, mask targets)."""
    props, _ = rpn_proposals(params, img, image_hw, cfg)
    dev = props.device
    props_np = props.cpu().numpy()
    iou = iou_np(props_np, gt_boxes)
    match = iou.argmax(axis=1)
    best = iou[np.arange(len(props_np)), match]
    roi_cls = np.where(best >= 0.5, CAR_LOGIT_COL, 0).astype(np.int32)
    roi_deltas = encode_deltas(gt_boxes[match], props_np)
    masks = torch.from_numpy(np.ascontiguousarray(gt_masks[match])).to(dev)
    return props, torch.from_numpy(roi_cls).to(dev), torch.from_numpy(roi_deltas).to(dev), mask_targets(masks, props)


def augment_with_rpn(params, img, static_targets: dict, gt_boxes, gt_masks, image_hw, cfg) -> dict:
    """The static jittered RoI set with freshly mined RPN proposals
    appended (a fixed total shape)."""
    mined = mine_rpn_targets(params, img, gt_boxes, gt_masks, image_hw, cfg)
    t = dict(static_targets)
    for key, extra in zip(("proposals", "roi_cls", "roi_deltas", "mask_targets"), mined):
        t[key] = torch.cat([static_targets[key], extra])
    return t


def build_targets(rng, gt_boxes, gt_masks, image_hw, cfg, device) -> dict:
    """The static training targets of one scene as tensors on `device`."""
    rpn_labels, rpn_deltas = rpn_targets(all_anchors(image_hw, cfg), gt_boxes)
    props, roi_cls, match = roi_proposals(rng, gt_boxes)
    roi_deltas = encode_deltas(gt_boxes[match], props)
    # 28 x 28 crops of each matched instance mask at its proposal window
    masks = torch.from_numpy(np.ascontiguousarray(gt_masks[match]))
    t = {"rpn_labels": rpn_labels, "rpn_deltas": rpn_deltas, "proposals": props, "roi_cls": roi_cls,
         "roi_deltas": roi_deltas}
    t = {k: torch.from_numpy(v).to(device) for k, v in t.items()}
    t["mask_targets"] = mask_targets(masks, torch.from_numpy(props)).to(device)
    return t


def overfit_scene(cfg: mr.MaskRCNNConfig, steps=400, seed=0, lr=1e-3, refresh=1, device=None):
    """Train on one planted scene -> (params on `device`, img, gt_boxes,
    gt_masks). Every `refresh` steps the RoI set is re-augmented with the
    RPN's own current proposals, so the heads train on the inference
    distribution. The JAX trainer refreshes every 100 steps: its heads then
    train for up to 99 steps on proposals the RPN no longer makes and may
    call a new background proposal a car (ROADMAP R8); mining at every step
    keeps them on the current proposals. Weights start from
    maskrcnn.init_params seeded with `seed`. `device` None means cuda."""
    device = entry_device(device, "maskrcnn_train")
    rng = np.random.default_rng(seed)
    img, gt_boxes, gt_masks = make_scene(rng)
    image_hw = img.shape[:2]
    static_t = build_targets(rng, gt_boxes, gt_masks, image_hw, cfg, device)
    params = trainable(mr.init_params(cfg, torch.Generator().manual_seed(seed)), device)
    trainer = Trainer(leaves(params), lr)
    timg = torch.from_numpy(img).to(device)
    targets = augment_with_rpn(params, timg, static_t, gt_boxes, gt_masks, image_hw, cfg)
    for step in range(steps):
        if refresh and step and step % refresh == 0:
            targets = augment_with_rpn(params, timg, static_t, gt_boxes, gt_masks, image_hw, cfg)
        train_step(params, trainer, timg, targets, image_hw, cfg)
    return tree_map(lambda t: t.detach(), params), img, gt_boxes, gt_masks


def closed_loop_report(pred_boxes: np.ndarray, pred_masks: np.ndarray, gt_boxes: np.ndarray,
                       gt_masks: np.ndarray) -> dict:
    """What tests/test_detector_closed_loop.py's Mask R-CNN case asserts on
    a detector's output (make_prediction's pred_boxes and pred_masks) for
    the planted scene: each instance's best box IoU and that box's mask IoU
    (`box_iou`, `mask_iou`), each detection's best IoU with an instance
    (`overlap`); `found` (a detection per instance and every box and mask
    IoU above 0.5), `clean` (every detection overlaps an instance by IoU
    above 0.3: none is spurious) and `ok` (both)."""
    n = len(pred_boxes)
    iou = iou_np(pred_boxes[:, :4], gt_boxes) if n else np.zeros((0, len(gt_boxes)), np.float32)
    box_iou, mask_iou = [], []
    for g in range(len(gt_boxes)):
        if not n:
            box_iou.append(0.0)
            mask_iou.append(0.0)
            continue
        best = int(iou[:, g].argmax())
        box_iou.append(float(iou[best, g]))
        inter = (pred_masks[best] & (gt_masks[g] > 0)).sum()
        union = (pred_masks[best] | (gt_masks[g] > 0)).sum()
        mask_iou.append(float(inter / max(union, 1)))
    overlap = [float(x) for x in iou.max(axis=1)] if n else []
    found = n >= len(gt_boxes) and min(box_iou, default=1.0) > 0.5 and min(mask_iou, default=1.0) > 0.5
    clean = all(x > 0.3 for x in overlap)
    return {"detections": n, "box_iou": box_iou, "mask_iou": mask_iou, "overlap": overlap,
            "found": bool(found), "clean": bool(clean), "ok": bool(found and clean)}
