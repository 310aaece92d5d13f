"""Seeded random weights for the detectors, in the checkpoints' own layout.

The trained mmdet / mmdet3d weights are not in the repository, so the
detect cell writes state dicts with the keys and shapes of mmdetection
2.x's Mask R-CNN R50-FPN and mmdetection3d's PointPillars (the layers the
configuration names, at its widths) to benchmark/.cache/weights/, from the
run's seed, and both the port (`load_mmdet_checkpoint`,
`load_mmdet3d_checkpoint`) and the references read the same file.

Convolutions and linear layers are He-normal; BatchNorm statistics and
affines are seeded near the identity (gamma 1 +- 0.1, beta and the running
mean 0 +- 0.05, running variance 1 to 1.2), and the last BN of each
residual branch is scaled by 0.3, so activations stay O(1) through the 50
bf16 layers. The heads are drawn so that the selections do work: the
classifiers' logits spread by a few units around 0 (no focal prior), so
that the R-CNN finds 100 boxes above its 0.05 and PointPillars 46-50 above
its 0.1 (on the card, PERF.md); box deltas stay small.
"""

from __future__ import annotations

import os

import torch

from .common import cache_path


def _he(g, shape, fan_in, gain=2.0):
    return torch.randn(shape, generator=g) * (gain / fan_in) ** 0.5


def _bn(sd, g, key, c, gamma=1.0):
    sd[key + ".weight"] = gamma * (1.0 + 0.1 * torch.randn(c, generator=g))
    sd[key + ".bias"] = 0.05 * torch.randn(c, generator=g)
    sd[key + ".running_mean"] = 0.05 * torch.randn(c, generator=g)
    sd[key + ".running_var"] = 1.0 + 0.2 * torch.rand(c, generator=g)
    sd[key + ".num_batches_tracked"] = torch.tensor(0)


def maskrcnn_state_dict(cfg: dict, seed: int) -> dict:
    """mmdet 2.x Mask R-CNN R50-FPN keys at `cfg`'s widths (a detector_2d block)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    stem = cfg["stem_channels"]
    sd["backbone.conv1.weight"] = _he(g, (stem, 3, 7, 7), 3 * 49)
    _bn(sd, g, "backbone.bn1", stem)
    cin, width = stem, stem
    for s, n in enumerate(cfg["stage_blocks"], start=1):
        cout = width * 4
        for i in range(n):
            base = f"backbone.layer{s}.{i}"
            c0 = cin if i == 0 else cout
            sd[base + ".conv1.weight"] = _he(g, (width, c0, 1, 1), c0)
            _bn(sd, g, base + ".bn1", width)
            sd[base + ".conv2.weight"] = _he(g, (width, width, 3, 3), width * 9)
            _bn(sd, g, base + ".bn2", width)
            sd[base + ".conv3.weight"] = _he(g, (cout, width, 1, 1), width)
            _bn(sd, g, base + ".bn3", cout, gamma=0.3)
            if i == 0:
                sd[base + ".downsample.0.weight"] = _he(g, (cout, cin, 1, 1), cin, gain=1.0)
                _bn(sd, g, base + ".downsample.1", cout)
        cin, width = cout, width * 2
    c = cfg["fpn_channels"]
    for i in range(4):
        ch = stem * 4 * 2 ** i
        sd[f"neck.lateral_convs.{i}.conv.weight"] = _he(g, (c, ch, 1, 1), ch, gain=1.0)
        sd[f"neck.lateral_convs.{i}.conv.bias"] = 0.05 * torch.randn(c, generator=g)
        sd[f"neck.fpn_convs.{i}.conv.weight"] = _he(g, (c, c, 3, 3), c * 9)
        sd[f"neck.fpn_convs.{i}.conv.bias"] = 0.05 * torch.randn(c, generator=g)
    a = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    sd["rpn_head.rpn_conv.weight"] = _he(g, (c, c, 3, 3), c * 9)
    sd["rpn_head.rpn_conv.bias"] = 0.05 * torch.randn(c, generator=g)
    sd["rpn_head.rpn_cls.weight"] = _he(g, (a, c, 1, 1), c, gain=2.0)
    sd["rpn_head.rpn_cls.bias"] = torch.zeros(a)
    sd["rpn_head.rpn_reg.weight"] = _he(g, (4 * a, c, 1, 1), c, gain=0.02)
    sd["rpn_head.rpn_reg.bias"] = torch.zeros(4 * a)
    fc, k = cfg["fc_dim"], cfg["num_classes"]
    din = c * cfg["roi_size"] ** 2
    for i, n_in in enumerate((din, fc)):
        sd[f"roi_head.bbox_head.shared_fcs.{i}.weight"] = _he(g, (fc, n_in), n_in)
        sd[f"roi_head.bbox_head.shared_fcs.{i}.bias"] = 0.05 * torch.randn(fc, generator=g)
    sd["roi_head.bbox_head.fc_cls.weight"] = _he(g, (k + 1, fc), fc, gain=2.0)
    sd["roi_head.bbox_head.fc_cls.bias"] = torch.zeros(k + 1)
    sd["roi_head.bbox_head.fc_reg.weight"] = _he(g, (4 * k, fc), fc, gain=0.5)
    sd["roi_head.bbox_head.fc_reg.bias"] = torch.zeros(4 * k)
    for i in range(4):
        sd[f"roi_head.mask_head.convs.{i}.conv.weight"] = _he(g, (c, c, 3, 3), c * 9)
        sd[f"roi_head.mask_head.convs.{i}.conv.bias"] = 0.05 * torch.randn(c, generator=g)
    sd["roi_head.mask_head.upsample.weight"] = _he(g, (c, c, 2, 2), c)
    sd["roi_head.mask_head.upsample.bias"] = 0.05 * torch.randn(c, generator=g)
    sd["roi_head.mask_head.conv_logits.weight"] = _he(g, (k, c, 1, 1), c, gain=1.0)
    sd["roi_head.mask_head.conv_logits.bias"] = torch.zeros(k)
    return sd


def pointpillars_state_dict(cfg: dict, seed: int) -> dict:
    """mmdet3d PointPillars keys at `cfg`'s widths (a detector_3d block)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    c = cfg["pfn_channels"]
    sd["voxel_encoder.pfn_layers.0.linear.weight"] = _he(g, (c, 10), 10)
    _bn(sd, g, "voxel_encoder.pfn_layers.0.norm", c)
    cin = c
    for bi, (n, cout) in enumerate(zip(cfg["backbone_layers"], cfg["backbone_channels"])):
        for li in range(n + 1):
            c0 = cin if li == 0 else cout
            sd[f"backbone.blocks.{bi}.{li * 3}.weight"] = _he(g, (cout, c0, 3, 3), c0 * 9)
            _bn(sd, g, f"backbone.blocks.{bi}.{li * 3 + 1}", cout)
        cin = cout
    for di, (ci, co, k) in enumerate(zip(cfg["backbone_channels"], cfg["fpn_channels"], cfg["fpn_upsample"])):
        sd[f"neck.deblocks.{di}.0.weight"] = _he(g, (ci, co, k, k), ci)
        _bn(sd, g, f"neck.deblocks.{di}.1", co)
    feat = sum(cfg["fpn_channels"])
    a = len(cfg["anchor_rotations"])
    for key, n, gain in (("conv_cls", a, 0.2), ("conv_reg", 7 * a, 0.01), ("conv_dir_cls", 2 * a, 0.2)):
        sd[f"bbox_head.{key}.weight"] = _he(g, (n, feat, 1, 1), feat, gain=gain)
        sd[f"bbox_head.{key}.bias"] = torch.zeros(n)
    return sd


def write(kind: str, cfg: dict, seed: int) -> tuple[str, bool]:
    """The state dict of `kind` ("maskrcnn" or "pointpillars") for `cfg` and
    `seed` as a checkpoint under benchmark/.cache/weights/ -> (its path,
    whether it was there already)."""
    path = cache_path({"kind": kind, "cfg": cfg, "seed": int(seed), "generator": "detweights.py@1"},
                      kind="weights", ext=".pth")
    if os.path.exists(path):
        return path, True
    sd = (maskrcnn_state_dict if kind == "maskrcnn" else pointpillars_state_dict)(cfg, seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"state_dict": sd, "meta": {"seed": int(seed), "layout": kind}}, tmp)
    os.replace(tmp, path)
    return path, False
