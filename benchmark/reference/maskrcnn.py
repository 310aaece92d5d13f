"""Plain Mask R-CNN R50-FPN inference in float32, for the check of the
port's 2D detector (benchmark/detcheck.py) and the CPU tests.

Written from the published description (He et al., ICCV 2017;
mmdetection 2.x's mask_rcnn_r50_fpn_1x_coco.py and the modules it names)
over an mmdet state dict as the checkpoint stores it: each BatchNorm
applied as written (not folded into its convolution), the classifier's
background class last, the R-CNN's deltas scaled by the box coder's target
stds (0.1, 0.1, 0.2, 0.2), the mask head's upsample a transposed
convolution written as its own sum. It imports nothing of the port and
nothing of JAX.

Where the port departs from mmdet's test path, the reference follows the
port, so that a gap measures the computation and not a convention. The
departures, as the port has them:
  - convolutions and the stem's max pool pad as XLA's SAME (the extra row
    and column below and right) where mmdet pads k // 2 on every side: the
    two differ only at stride 2;
  - each FPN output convolution is followed by a ReLU (mmdet's have none);
  - anchors are centred at (i + 0.5) * stride (mmdet 2.x: i * stride);
  - delta decoding clamps dw and dh at 4 (mmdet: |log(16 / 1000)|);
  - RoIAlign takes one bilinear sample at each bin's centre with no
    half-pixel shift (mmcv's aligned RoIAlign averages ceil(roi / out)
    samples a bin);
  - the RPN keeps boxes that clipping leaves empty (mmdet's min_bbox_size
    0 drops them);
  - the R-CNN's NMS is class-agnostic over each proposal's best class
    (mmdet: per class), and a kept box's label is that of the candidate it
    overlaps most (the first among equal overlaps);
  - the resize is bilinear on float pixels (mmcv resizes the uint8 image).
Box decoding and the overlaps are computed in the port's order of
operations, on the same device, so that the selections compare exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .lowbits import F32

MEAN = (123.675, 116.28, 103.53)      # mmdet's img_norm_cfg, RGB
STD = (58.395, 57.12, 57.375)
STRIDES = (4, 8, 16, 32, 64)
TARGET_STDS = (0.1, 0.1, 0.2, 0.2)
BN_EPS = 1e-5


def load(path: str, device=None) -> dict:
    """An mmdet checkpoint's state dict as float32 tensors on `device`."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    sd = saved.get("state_dict", saved)
    return {k: torch.as_tensor(v).to(device, torch.float32) for k, v in sd.items()}


def stage_blocks(sd: dict) -> list[int]:
    return [len({k.split(".")[2] for k in sd if k.startswith(f"backbone.layer{s}.")}) for s in range(1, 5)]


# ---------------------------------------------------------------------------
# layers


def _same(x, k: int, stride: int, value=0.0):
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def conv(x, w, b=None, stride: int = 1, prec=F32):
    """A convolution with SAME padding, operands and result as `prec` has them."""
    y = F.conv2d(_same(prec.operand(x), w.shape[-1], stride), prec.operand(w), stride=stride)
    if b is not None:
        y = y + b[None, :, None, None]
    return prec.result(y)


def bn(x, sd: dict, key: str, eps: float = BN_EPS):
    g, b = sd[key + ".weight"], sd[key + ".bias"]
    m, v = sd[key + ".running_mean"], sd[key + ".running_var"]
    return (x - m[None, :, None, None]) / torch.sqrt(v + eps)[None, :, None, None] * g[None, :, None, None] \
        + b[None, :, None, None]


def transposed_conv(x, w, b, prec=F32):
    """A transposed convolution whose kernel equals its stride k, as its
    sum: out[n, o, k i + a, k j + c] = sum_ch x[n, ch, i, j] w[ch, o, a, c] + b[o]."""
    k = w.shape[-1]
    n, _, h, wd = x.shape
    y = torch.einsum("nchw,coab->nohawb", prec.operand(x), prec.operand(w)).reshape(n, w.shape[1], h * k, wd * k)
    return prec.result(y + b[None, :, None, None])


# ---------------------------------------------------------------------------
# the test pipeline


def input_size(hw, test_scale) -> tuple:
    """mmcv's keep-ratio rescale of an (h, w) image into test_scale (long,
    short): the largest factor that keeps both edges within their limits,
    sizes rounded half up."""
    h, w = hw
    f = min(max(test_scale) / max(h, w), min(test_scale) / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def prepare(img, test_scale, size_divisor: int, device=None):
    """A host image (H, W) grey or (H, W, 3) RGB -> (the network's input
    (1, 3, Hp, Wp), its size before padding (h, w)): resize, normalize,
    zeros to a multiple of size_divisor (mmdet's Resize, Normalize, Pad)."""
    x = torch.as_tensor(np.asarray(img, np.float32), device=device)
    x = x[None, None].expand(1, 3, *x.shape) if x.ndim == 2 else x.permute(2, 0, 1)[None]
    h, w = input_size(x.shape[-2:], test_scale)
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    mean = torch.tensor(MEAN, device=device)[None, :, None, None]
    std = torch.tensor(STD, device=device)[None, :, None, None]
    x = (x - mean) / std
    hp, wp = -(-h // size_divisor) * size_divisor, -(-w // size_divisor) * size_divisor
    return F.pad(x, (0, wp - w, 0, hp - h)), (h, w)


# ---------------------------------------------------------------------------
# backbone and neck


def backbone(sd: dict, x, prec=F32) -> list:
    """ResNet-50 (mmdet's pytorch style: the stride on each stage's first
    3x3) and the FPN -> [P2, P3, P4, P5, P6]."""
    x = torch.relu(bn(conv(x, sd["backbone.conv1.weight"], stride=2, prec=prec), sd, "backbone.bn1"))
    x = F.max_pool2d(_same(x, 3, 2, float("-inf")), 3, 2)
    outs = []
    for s, n in enumerate(stage_blocks(sd), start=1):
        for i in range(n):
            base = f"backbone.layer{s}.{i}"
            stride = 2 if (s > 1 and i == 0) else 1
            h = torch.relu(bn(conv(x, sd[base + ".conv1.weight"], prec=prec), sd, base + ".bn1"))
            h = torch.relu(bn(conv(h, sd[base + ".conv2.weight"], stride=stride, prec=prec), sd, base + ".bn2"))
            h = bn(conv(h, sd[base + ".conv3.weight"], prec=prec), sd, base + ".bn3")
            if i == 0:
                x = bn(conv(x, sd[base + ".downsample.0.weight"], stride=stride, prec=prec), sd, base + ".downsample.1")
            x = torch.relu(h + x)
        outs.append(x)
    lat = [conv(c, sd[f"neck.lateral_convs.{i}.conv.weight"], sd[f"neck.lateral_convs.{i}.conv.bias"], prec=prec)
           for i, c in enumerate(outs)]
    for i in range(3, 0, -1):           # top-down: each level 2x the next (the input is padded to 32)
        assert lat[i - 1].shape[-2:] == (2 * lat[i].shape[-2], 2 * lat[i].shape[-1]), "pad the input to 32"
        lat[i - 1] = lat[i - 1] + lat[i].repeat_interleave(2, -2).repeat_interleave(2, -1)
    p = [torch.relu(conv(l, sd[f"neck.fpn_convs.{i}.conv.weight"], sd[f"neck.fpn_convs.{i}.conv.bias"], prec=prec))
         for i, l in enumerate(lat)]
    return p + [p[-1][..., ::2, ::2]]    # P6: max pool 1x1, stride 2


# ---------------------------------------------------------------------------
# RPN


def rpn_heads(sd: dict, feats, prec=F32) -> list:
    """Each level's (objectness logits (h w A,), deltas (h w A, 4)),
    position-major, anchor-minor."""
    out = []
    for f in feats:
        h = torch.relu(conv(f, sd["rpn_head.rpn_conv.weight"], sd["rpn_head.rpn_conv.bias"], prec=prec))
        cls = conv(h, sd["rpn_head.rpn_cls.weight"], sd["rpn_head.rpn_cls.bias"], prec=prec)[0]
        reg = conv(h, sd["rpn_head.rpn_reg.weight"], sd["rpn_head.rpn_reg.bias"], prec=prec)[0]
        out.append((cls.permute(1, 2, 0).reshape(-1), reg.permute(1, 2, 0).reshape(-1, 4)))
    return out


def anchors(h: int, w: int, stride: int, scales=(8.0,), ratios=(0.5, 1.0, 2.0), device=None):
    """(h w A, 4) xyxy anchors, position-major, then ratio, then scale
    (mmdet's base-anchor order), worked out in float64."""
    cy, cx = np.meshgrid((np.arange(h) + 0.5) * stride, (np.arange(w) + 0.5) * stride, indexing="ij")
    per = []
    for r in ratios:
        for s in scales:
            aw, ah = s * stride * np.sqrt(1.0 / r), s * stride * np.sqrt(r)
            per.append(np.stack([cx - aw / 2, cy - ah / 2, cx + aw / 2, cy + ah / 2], -1))
    return torch.tensor(np.stack(per, 2).reshape(-1, 4), dtype=torch.float32, device=device)


def decode(d, boxes):
    """(dx, dy, dw, dh) applied to xyxy boxes, dw and dh clamped at 4."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + w / 2
    cy = boxes[:, 1] + h / 2
    ncx = cx + d[:, 0] * w
    ncy = cy + d[:, 1] * h
    nw = torch.exp(torch.clamp(d[:, 2], -4, 4)) * w
    nh = torch.exp(torch.clamp(d[:, 3], -4, 4)) * h
    return torch.stack([ncx - nw / 2, ncy - nh / 2, ncx + nw / 2, ncy + nh / 2], dim=-1)


def clip(boxes, hw):
    h, w = hw
    return torch.stack([boxes[:, 0].clamp(0.0, w), boxes[:, 1].clamp(0.0, h),
                        boxes[:, 2].clamp(0.0, w), boxes[:, 3].clamp(0.0, h)], dim=-1)


def overlaps(a, b):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter, min=1e-6)


def nms(iou: np.ndarray, scores: np.ndarray, thresh: float) -> list[int]:
    """Greedy NMS: candidates in descending score (the lower index first
    among equal scores); each kept one drops the later ones that overlap it
    above `thresh`. Returns the kept indices in order."""
    order = np.argsort(-scores, kind="stable")
    dropped = np.zeros(len(scores), bool)
    keep = []
    for i in order:
        if dropped[i]:
            continue
        keep.append(int(i))
        dropped |= iou[i] > thresh
    return keep


def rpn_select(level_outputs, level_hw, image_hw, pre: int, post: int, iou_thresh: float, across_levels: bool):
    """Proposals from the RPN's outputs on levels of (h, w) `level_hw`: each
    level's best `pre` anchors, decoded and clipped to `image_hw`; NMS
    within each level (or over all of them); the best `post` survivors by
    score -> (n, 4) boxes in descending score."""
    boxes, scores, levels = [], [], []
    for lvl, ((s, d), (h, w)) in enumerate(zip(level_outputs, level_hw)):
        a = anchors(h, w, STRIDES[lvl], device=s.device)
        top, idx = torch.sort(s, descending=True, stable=True)
        top, idx = top[:pre], idx[:pre]
        boxes.append(clip(decode(d[idx], a[idx]), image_hw))
        scores.append(top)
        levels += [lvl] * len(top)
    b, s = torch.cat(boxes), torch.cat(scores)
    iou = overlaps(b, b).cpu().numpy()
    lv = np.asarray(levels)
    if not across_levels:
        iou = np.where(lv[:, None] == lv[None, :], iou, 0.0)
    keep = nms(iou, s.cpu().numpy(), iou_thresh)[:post]
    return b[keep]


# ---------------------------------------------------------------------------
# R-CNN


def level_of(boxes):
    """mmdet's RoI level: floor(log2(sqrt(w h) / 56 + 1e-6)), within P2-P5."""
    scale = torch.sqrt(torch.clamp((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), min=1e-6))
    return torch.clamp(torch.floor(torch.log2(scale / 56.0 + 1e-6)), 0, 3).to(torch.int64)


def roi_align(feats, boxes, out: int):
    """One bilinear sample at each of out x out bin centres of each box,
    on the box's level (map edges clamp) -> (N, C, out, out)."""
    lvl = level_of(boxes)
    res = torch.zeros(boxes.shape[0], feats[0].shape[1], out, out, device=boxes.device)
    c = (torch.arange(out, dtype=torch.float32, device=boxes.device) + 0.5) / out
    for li in range(4):
        sel = torch.nonzero(lvl == li)[:, 0]
        if len(sel) == 0:
            continue
        f = feats[li][0]
        H, W = f.shape[-2:]
        b = boxes[sel] / STRIDES[li]
        y = b[:, 1:2] + c[None] * torch.clamp(b[:, 3:4] - b[:, 1:2], min=1e-3)
        x = b[:, 0:1] + c[None] * torch.clamp(b[:, 2:3] - b[:, 0:1], min=1e-3)
        y, x = y.clamp(0, H - 1), x.clamp(0, W - 1)
        y0 = torch.clamp(torch.floor(y), max=H - 2).to(torch.int64)
        x0 = torch.clamp(torch.floor(x), max=W - 2).to(torch.int64)
        fy, fx = (y - y0)[:, None, :, None], (x - x0)[:, None, None, :]
        Y0, X0 = y0[:, :, None], x0[:, None, :]
        v = lambda yy, xx: f[:, yy, xx].permute(1, 0, 2, 3)      # noqa: E731  (n, C, out, out)
        res[sel] = (v(Y0, X0) * (1 - fy) * (1 - fx) + v(Y0, X0 + 1) * (1 - fy) * fx
                    + v(Y0 + 1, X0) * fy * (1 - fx) + v(Y0 + 1, X0 + 1) * fy * fx)
    return res


def _fc(x, sd, key, prec):
    return prec.result(prec.operand(x) @ prec.operand(sd[key + ".weight"]).T + sd[key + ".bias"])


def box_head(sd: dict, feats, proposals, valid, image_hw, prec=F32):
    """Shared2FCBBoxHead on the proposals -> (each proposal's box for its
    best class (N, 4), that class's probability times validity (N,), the
    class (N,), the class probabilities without background (N, classes))."""
    x = roi_align(feats, proposals, 7).flatten(1)
    x = torch.relu(_fc(x, sd, "roi_head.bbox_head.shared_fcs.0", prec))
    x = torch.relu(_fc(x, sd, "roi_head.bbox_head.shared_fcs.1", prec))
    probs = torch.softmax(_fc(x, sd, "roi_head.bbox_head.fc_cls", prec), dim=-1)[:, :-1]   # background last
    reg = _fc(x, sd, "roi_head.bbox_head.fc_reg", prec).reshape(len(x), -1, 4)
    best = torch.argmax(probs, dim=-1)
    d = reg[torch.arange(len(x), device=x.device), best] * torch.tensor(TARGET_STDS, device=x.device)
    return clip(decode(d, proposals), image_hw), probs.amax(-1) * valid, best, probs


def select(boxes, scores, classes, iou_thresh: float, k: int, score_thresh: float = 0.05):
    """The R-CNN's NMS over candidates scoring above score_thresh, at most
    k kept -> (kept boxes, scores, labels) in descending score."""
    live = torch.nonzero(scores > score_thresh)[:, 0]
    if len(live) == 0:
        return boxes[:0], scores[:0], classes[:0]
    iou = overlaps(boxes[live], boxes[live]).cpu().numpy()
    keep = live[nms(iou, scores[live].cpu().numpy(), iou_thresh)[:k]]
    kept = boxes[keep]
    match = torch.argmax(overlaps(kept, boxes), dim=1) if len(keep) else keep
    return kept, scores[keep], classes[match]


def mask_head(sd: dict, feats, boxes, labels, prec=F32):
    """FCNMaskHead: 14 x 14 RoIAlign, four 3x3 convs, the 2x2 stride-2
    transposed conv, 1x1 class logits -> each box's own class (N, 28, 28)."""
    x = roi_align(feats, boxes, 14)
    for i in range(4):
        x = torch.relu(conv(x, sd[f"roi_head.mask_head.convs.{i}.conv.weight"],
                            sd[f"roi_head.mask_head.convs.{i}.conv.bias"], prec=prec))
    x = torch.relu(transposed_conv(x, sd["roi_head.mask_head.upsample.weight"],
                                   sd["roi_head.mask_head.upsample.bias"], prec=prec))
    logits = conv(x, sd["roi_head.mask_head.conv_logits.weight"], sd["roi_head.mask_head.conv_logits.bias"], prec=prec)
    return logits[torch.arange(len(boxes), device=boxes.device), labels]
