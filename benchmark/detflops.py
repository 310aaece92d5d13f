"""Operation counts of the online detectors' work per keyframe, and the
card's dense BF16 peak.

Counted from the algorithm's shapes, once, whatever implements it: a
convolution producing an (h, w) map of `cout` channels from `cin` with a
k x k kernel is 2 cin cout k^2 h w operations; a transposed convolution
whose kernel equals its stride k costs 2 cin cout k^2 per input pixel; a
product of an (n, i) by an (i, o) matrix 2 n i o. BatchNorm (folded),
biases, activations, pooling, RoIAlign, the scatter, decoding and NMS add
no products and are not counted. Mask R-CNN at its padded input size,
with `rpn_post_nms` proposals through the box head and `max_detections`
boxes through the mask head; PointPillars over its fixed pillar tensors
(max_pillars x max_points_per_pillar points).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the full 700 W limit
PEAK_BF16_FLOPS = 989e12


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def conv(cin: int, cout: int, k: int, h: int, w: int) -> float:
    return 2.0 * cin * cout * k * k * h * w


def maskrcnn_input(cfg: dict, image_hw) -> tuple:
    """The padded network input's (h, w) for an image of image_hw."""
    h, w = image_hw
    if cfg.get("test_scale"):
        f = min(max(cfg["test_scale"]) / max(h, w), min(cfg["test_scale"]) / min(h, w))
        h, w = int(h * f + 0.5), int(w * f + 0.5)
        d = cfg["size_divisor"]
        h, w = _ceil(h, d) * d, _ceil(w, d) * d
    return h, w


def maskrcnn_flops(cfg: dict, image_hw) -> float:
    h, w = maskrcnn_input(cfg, image_hw)
    stem = cfg["stem_channels"]
    h, w = _ceil(h, 2), _ceil(w, 2)
    total = conv(3, stem, 7, h, w)
    h, w = _ceil(h, 2), _ceil(w, 2)                    # max pool
    cin, width, level_hw = stem, stem, []
    for s, n in enumerate(cfg["stage_blocks"]):
        cout = width * 4
        for i in range(n):
            h_in, w_in = h, w
            if s > 0 and i == 0:
                h, w = _ceil(h, 2), _ceil(w, 2)
            c0 = cin if i == 0 else cout
            total += conv(c0, width, 1, h_in, w_in) + conv(width, width, 3, h, w) + conv(width, cout, 1, h, w)
            if i == 0:
                total += conv(cin, cout, 1, h, w)
        level_hw.append((h, w))
        cin, width = cout, width * 2
    c = cfg["fpn_channels"]
    for i, (lh, lw) in enumerate(level_hw):
        total += conv(stem * 4 * 2 ** i, c, 1, lh, lw) + conv(c, c, 3, lh, lw)
    level_hw.append((_ceil(level_hw[-1][0], 2), _ceil(level_hw[-1][1], 2)))
    a = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    for lh, lw in level_hw:
        total += conv(c, c, 3, lh, lw) + conv(c, a, 1, lh, lw) + conv(c, 4 * a, 1, lh, lw)
    fc, k = cfg["fc_dim"], cfg["num_classes"]
    total += 2.0 * cfg["rpn_post_nms"] * (c * cfg["roi_size"] ** 2 * fc + fc * fc + fc * (k + 1) + fc * 4 * k)
    m = cfg["mask_roi_size"]
    per_box = 4 * conv(c, c, 3, m, m) + 2.0 * c * c * 4 * m * m + conv(c, k, 1, 2 * m, 2 * m)
    return total + cfg["max_detections"] * per_box


def pointpillars_flops(cfg: dict) -> float:
    r, v = cfg["pc_range"], cfg["voxel_size"]
    nx, ny = int(round((r[3] - r[0]) / v[0])), int(round((r[4] - r[1]) / v[1]))
    total = 2.0 * cfg["max_pillars"] * cfg["max_points_per_pillar"] * 10 * cfg["pfn_channels"]
    cin, h, w = cfg["pfn_channels"], ny, nx
    for n, s, cout, up, cup in zip(cfg["backbone_layers"], cfg["backbone_strides"], cfg["backbone_channels"],
                                    cfg["fpn_upsample"], cfg["fpn_channels"]):
        h, w = _ceil(h, s), _ceil(w, s)
        total += conv(cin, cout, 3, h, w) + n * conv(cout, cout, 3, h, w)
        total += 2.0 * cout * cup * up * up * h * w       # the deblock, kernel = stride
        cin = cout
    feat = sum(cfg["fpn_channels"])
    h, w = _ceil(ny, cfg["backbone_strides"][0]), _ceil(nx, cfg["backbone_strides"][0])
    a = len(cfg["anchor_rotations"])
    return total + conv(feat, a * (1 + 7 + 2), 1, h, w)


def keyframe_flops(cfg_2d: dict, cfg_3d: dict, image_hw) -> float:
    """One keyframe's operations: Mask R-CNN on its image and PointPillars
    on its scan."""
    return maskrcnn_flops(cfg_2d, image_hw) + pointpillars_flops(cfg_3d)
