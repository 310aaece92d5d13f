"""The online detectors followed stage by stage, from the program's own state.

`StageTap` wraps the stage functions of the port's detector modules
(`detect/maskrcnn.py`: resnet_fpn, rpn_heads, rpn_select, box_head,
select_boxes, mask_head; `detect/pointpillars.py`:
build_pillars_from_points, forward, select_detections) and, while a
keyframe is sampled, keeps each call's inputs and outputs. The plain
references (benchmark/reference/maskrcnn.py, pointpillars.py) then work
each stage out again from the same inputs: the raw image and scan for the
first stage, the program's own outputs of the stage before for the rest,
so that each number measures one stage.

  det2d_feat_gap     P2-P6 against the reference's ResNet-50 and FPN on its
                     own resize of the same image: ||prog - ref|| / ||ref||,
                     the worst level;
  det2d_head_gap     the RPN heads, the box head (class probabilities and
                     decoded boxes over the valid proposals) and the mask
                     head (over the kept boxes) run by the reference on the
                     program's features, proposals and kept boxes: the worst
                     relative norm;
  det2d_select_miss  picks that differ when the reference runs the RPN's
                     top-k, decode and per-level NMS on the program's own
                     scores and deltas, and the R-CNN's NMS on its own
                     boxes and scores (a proposal or a kept box more than
                     1e-3 px off at its place in the order, one more or
                     fewer, or another label), counted;
  det3d_pillar_miss  pillars built by the reference from the same scan that
                     differ from the program's (compared by BEV cell: a cell
                     on one side only, another point mask, or a feature more
                     than 1e-4 m off), counted;
  det3d_net_gap      the class, box and direction outputs of the reference
                     network on the program's own pillars: the worst
                     relative norm;
  det3d_select_miss  the program's picks that the definition of greedy NMS
                     does not allow, checked by the reference on the
                     program's own outputs (its decode, top-k and direction,
                     then float64 rotated overlaps known to within 1e-4 of
                     the threshold), plus picks it cannot find among the
                     candidates, counted.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import maskrcnn as ref2d
from .reference import pointpillars as ref3d

STAGES_2D = ("resnet_fpn", "rpn_heads", "rpn_select", "box_head", "select_boxes", "mask_head")
STAGES_3D = ("build_pillars_from_points", "forward", "select_detections")
BOX_TOL = 1e-3          # px (2D) or m (3D): a pick at the same place
FEATURE_TOL = 1e-4      # m: a pillar's point features (segment sums in another order)
IOU_BAND = 1e-4         # the float32 polygon clipping's overlaps against float64


class StageTap:
    """Wraps `names` of `module` in place. While `record` is a dict, each
    call appends (args, output) to record[name]; otherwise a call passes
    straight through. `remove()` puts the functions back."""

    def __init__(self, module, names):
        self.module, self.record = module, None
        self.original = {n: getattr(module, n) for n in names}
        for n, fn in self.original.items():
            setattr(module, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def tapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.record is not None:
                self.record.setdefault(name, []).append((args, out))
            return out
        return tapped

    def remove(self):
        for n, fn in self.original.items():
            setattr(self.module, n, fn)


def rel(prog, ref) -> float:
    prog, ref = prog.double(), ref.double().to(prog.device)
    return float(torch.linalg.vector_norm(prog - ref) / torch.clamp(torch.linalg.vector_norm(ref), min=1e-30))


def picks_differ(prog, ref) -> int:
    """Places in two ordered lists of boxes where they differ by more than
    BOX_TOL, plus the difference of their lengths."""
    n = min(len(prog), len(ref))
    off = (torch.abs(prog[:n] - ref[:n].to(prog.device)).amax(-1) > BOX_TOL).sum() if n else 0
    return int(off) + abs(len(prog) - len(ref))


def det2d_gaps(rec: dict, sd: dict, image, cfg: dict) -> dict:
    """The 2D numbers of one sampled keyframe (`rec`: the tap's record)."""
    (_, x_prog, _), feats = rec["resnet_fpn"][0][0], rec["resnet_fpn"][0][1]
    x_ref, _ = ref2d.prepare(image, cfg["test_scale"], cfg["size_divisor"], device=x_prog.device)
    out = {"det2d_input_gap": float(torch.abs(x_prog - x_ref).max())}
    feats_ref = ref2d.backbone(sd, x_ref)
    out["det2d_feat_gap"] = max(rel(p, r) for p, r in zip(feats, feats_ref))
    levels = rec["rpn_heads"][0][1]
    rpn = max(max(rel(s, rs), rel(d, rd)) for (s, d), (rs, rd) in zip(levels, ref2d.rpn_heads(sd, feats)))
    (_, _, props, valid, image_hw, _), (boxes, scores, classes, probs) = rec["box_head"][0]
    live = valid > 0
    r_boxes, _, _, r_probs = ref2d.box_head(sd, feats, props, valid, image_hw)
    box = max(rel(probs[live], r_probs[live]), rel(boxes[live], r_boxes[live]))
    (_, _, kept, labels, _), masks = rec["mask_head"][0]
    kept_valid = rec["select_boxes"][0][1][2] > 0
    mask = rel(masks[kept_valid], ref2d.mask_head(sd, feats, kept[kept_valid], labels[kept_valid])) \
        if kept_valid.any() else 0.0
    out.update(det2d_rpn_gap=rpn, det2d_box_gap=box, det2d_mask_gap=mask, det2d_head_gap=max(rpn, box, mask))
    (lv_out, level_hw, hw, _), (proposals, prop_valid) = rec["rpn_select"][0]
    ref_props = ref2d.rpn_select(lv_out, level_hw, hw, cfg["rpn_pre_nms"], cfg["rpn_post_nms"],
                                 cfg["rpn_nms_iou"], cfg["rpn_nms_across_levels"])
    rpn_miss = picks_differ(proposals[prop_valid > 0], ref_props)
    kb, ks, kv, kl = rec["select_boxes"][0][1]
    rk, _, rl = ref2d.select(boxes, scores, classes, cfg["nms_iou"], cfg["max_detections"])
    n = min(int((kv > 0).sum()), len(rk))
    rcnn_miss = picks_differ(kb[kv > 0], rk) + int((kl[kv > 0][:n] != rl[:n]).sum())
    out.update(det2d_rpn_miss=float(rpn_miss), det2d_rcnn_miss=float(rcnn_miss),
               det2d_select_miss=float(rpn_miss + rcnn_miss), det2d_proposals=float((prop_valid > 0).sum()),
               det2d_rcnn_picks=float((kv > 0).sum()))
    return out


def det3d_gaps(rec: dict, sd: dict, scan: np.ndarray, cfg: dict) -> dict:
    """The 3D numbers of one sampled keyframe (`rec`: the tap's record)."""
    pil = rec["build_pillars_from_points"][0][1]
    nx, _ = ref3d.grid_size(cfg)
    live = (pil["pillar_mask"] > 0).cpu().numpy()
    c = pil["coords"].cpu().numpy()[live].astype(np.int64)
    keys = c[:, 1] * nx + c[:, 0]
    order = np.argsort(keys)
    keys, feats, mask = keys[order], pil["features"].cpu().numpy()[live][order], pil["mask"].cpu().numpy()[live][order]
    ref = ref3d.pillars(scan, cfg)
    both, pi, ri = np.intersect1d(keys, ref["keys"], return_indices=True)
    m_p, m_r = mask[pi], ref["mask"][ri]
    f_off = np.abs((feats[pi] - ref["features"][ri]) * m_r[..., None]).max(axis=(1, 2), initial=0.0)
    miss = (len(keys) - len(both)) + (len(ref["keys"]) - len(both)) \
        + int(((m_p != m_r).any(1) | (f_off > FEATURE_TOL)).sum())
    out = {"det3d_pillar_miss": float(miss), "det3d_pillars": float(len(keys)),
           "det3d_feature_gap": float(f_off.max(initial=0.0))}
    (_, pil_args, _), (cls, deltas, dirs) = rec["forward"][0]
    r_cls, r_box, r_dir = ref3d.forward(sd, pil_args, cfg)
    out["det3d_net_gap"] = max(rel(cls, r_cls), rel(deltas, r_box), rel(dirs, r_dir))
    ny_half, nx_half = ref3d.grid_size(cfg)[1] // 2, nx // 2
    anchors = ref3d.anchors(cfg, (ny_half, nx_half), device=cls.device)
    cand, scores = ref3d.candidates(cls, ref3d.decode(deltas, anchors), dirs, cfg["nms_pre"])
    iou = ref3d.rotated_iou(cand.double().cpu().numpy())
    p_boxes, _, p_valid = rec["select_detections"][0][1]
    picks, unmatched = [], 0
    for b in p_boxes[p_valid > 0]:
        d = torch.abs(cand - b[None]).amax(-1)
        j = int(torch.argmin(d))
        if float(d[j]) > BOX_TOL:
            unmatched += 1
        else:
            picks.append(j)
    misses = ref3d.nms_misses(iou, scores.double().cpu().numpy(), picks, cfg["nms_iou_threshold"],
                              cfg["max_detections"], cfg["score_threshold"], IOU_BAND)
    out.update(det3d_select_miss=float(misses + unmatched), det3d_picks=float(len(picks) + unmatched))
    return out
