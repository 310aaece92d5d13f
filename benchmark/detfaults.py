"""Planted faults and the precision control of the online detectors, for
the tests of `correct` (neither runs in a benchmark run; faults.py has the
SLAM layers').

A fault is named "<detector>.<stage>" and breaks one stage, so that one
number fails:
  det2d.feat    the FPN's P4 scaled by 1.2                 (det2d_feat_gap)
  det2d.head    the mask head's upsample resized instead of transposed:
                every phase of its kernel set to the first (a nearest 2x
                resize and a 1x1 convolution)             (det2d_head_gap)
  det2d.select  the RPN's NMS at IoU 0.8                  (det2d_select_miss)
  det3d.pillar  the z feature over the anchor plane 0.1 m off
                                                          (det3d_pillar_miss)
  det3d.net     SECONDFPN's deblocks resized instead of transposed, as
                det2d.head                                (det3d_net_gap)
  det3d.select  the NMS at an IoU threshold 0.3 higher    (det3d_select_miss)
The control (`det_lowp`): each stage one precision below the
configuration's, computed by the plain references: the bf16 backbones
(ResNet-50 + FPN; the whole PointPillars network) with 4 mantissa bits
where bfloat16 keeps 7, the float32 heads in TF32 (their products' operands
rounded to 10 bits). The SLAM layers' control is faults.py's `tf32`.
"""

from __future__ import annotations

import dataclasses

from .reference import maskrcnn as ref2d
from .reference import pointpillars as ref3d
from .reference.lowbits import BELOW_BF16, TF32

FAULTS = ("det2d.feat", "det2d.head", "det2d.select", "det3d.pillar", "det3d.net", "det3d.select")
CONTROL = "det_lowp"


def _phase_constant(params, key):
    """A copy of params whose transposed kernel(s) under `key` repeat their first phase."""
    def flat(p):
        return dict(p, w=p["w"][:, :, :1, :1].expand_as(p["w"]).contiguous())
    out = dict(params)
    out[key] = [flat(p) for p in params[key]] if isinstance(params[key], list) else flat(params[key])
    return out


def install(variant: str | None, mr, pp, sd2=None, sd3=None, cfg3d: dict | None = None):
    """Replace the stage functions of the modules `mr` (maskrcnn) and `pp`
    (pointpillars) for `variant`; returns the replaced originals for
    `restore`. `sd2`, `sd3` (the reference's state dicts) and `cfg3d` are
    the control's."""
    saved = {}

    def put(mod, name, fn):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, fn)

    if variant == CONTROL:
        put(mr, "resnet_fpn", lambda params, x, cfg: ref2d.backbone(sd2, x, BELOW_BF16))
        put(mr, "rpn_heads", lambda params, feats: ref2d.rpn_heads(sd2, feats, TF32))
        put(mr, "box_head", lambda params, feats, p, v, hw, cfg: ref2d.box_head(sd2, feats, p, v, hw, TF32))
        put(mr, "mask_head", lambda params, feats, b, lab, cfg: ref2d.mask_head(sd2, feats, b, lab, TF32))
        put(pp, "forward", lambda params, pil, cfg: ref3d.forward(sd3, pil, cfg3d, BELOW_BF16))
    elif variant == "det2d.feat":
        fn = mr.resnet_fpn
        put(mr, "resnet_fpn", lambda *a: [f * 1.2 if i == 2 else f for i, f in enumerate(fn(*a))])
    elif variant == "det2d.head":
        fn = mr.mask_head
        put(mr, "mask_head", lambda params, *a: fn(_phase_constant(params, "mask_deconv"), *a))
    elif variant == "det2d.select":
        fn = mr.rpn_select
        put(mr, "rpn_select", lambda lv, lhw, hw, cfg: fn(lv, lhw, hw, dataclasses.replace(cfg, rpn_nms_iou=0.8)))
    elif variant == "det3d.pillar":
        fn = pp.build_pillars_from_points

        def shifted(*a):
            out = dict(fn(*a))
            f = out["features"].clone()
            f[..., 9] += 0.1 * out["mask"]
            out["features"] = f
            return out
        put(pp, "build_pillars_from_points", shifted)
    elif variant == "det3d.net":
        fn = pp.forward
        put(pp, "forward", lambda params, *a: fn(_phase_constant(params, "deblocks"), *a))
    elif variant == "det3d.select":
        fn = pp.select_detections
        put(pp, "select_detections", lambda c, b, d, cfg: fn(c, b, d, dataclasses.replace(
            cfg, nms_iou_threshold=cfg.nms_iou_threshold + 0.3)))
    return saved


def restore(saved: dict):
    for (mod, name), fn in saved.items():
        setattr(mod, name, fn)
