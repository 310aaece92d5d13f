"""Synthetic closed-loop PointPillars training.

Port of dspslam_tpu/detect/pointpillars_train.py. No pretrained detector
weights are in the repository, so the architecture cannot be validated
against KITTI. What can be shown is that the stack (pillarization, PFN, BEV
backbone, anchor heads, delta decoding and rotated NMS) is wired
consistently end to end: train briefly on generated scans with planted
car-sized boxes and check that the detector recovers them (the boxes-in,
cars-out contract of the reference's detector3d.py:59-67).

Target assignment is the SSD-style scheme PointPillars uses, reduced to
centre-distance gating: anchors near a ground-truth centre with the closer
rotation are positive, far anchors negative, the band between ignored; each
ground-truth box force-matches its nearest anchor. Scene generation,
assignment and box encoding are numpy copies of the JAX package's. The
trainers also regress the ignored band's boxes toward their nearest
ground-truth box (`regress_ignored`; ROADMAP R9): in the JAX trainer those
anchors score as high as the positives near them but regress nothing, so
their boxes land 1-3 m from the car, where greedy NMS keeps them. The
training forward builds pillars on the device with
`build_pillars_from_points` and runs the inference `forward` (its BEV net in
bf16, as JAX's trainer does); the BatchNorm trainer runs a float32 mirror
(`train_forward`) and folds its statistics into inference weights
(`fold_bn_state`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..slam.map import entry_device
from .layers import Trainer, conv2d_same, conv_transpose2d, leaves, trainable, tree_map
from .pointpillars import (
    PointPillarsConfig, _anchors, build_pillars_from_points, crop_quantize_points, forward, init_params,
)


def small_config() -> PointPillarsConfig:
    """A reduced config for closed-loop runs (a ~16x cheaper BEV backbone
    than the KITTI default). Generated scenes occupy ~3.5k pillars, mostly
    singletons: the cap holds them all, so the densest-first selection
    never breaks count ties."""
    return PointPillarsConfig(
        pc_range=(0.0, -15.36, -3.0, 30.72, 15.36, 1.0), voxel_size=(0.32, 0.32, 4.0), max_pillars=4096,
        backbone_layers=(2, 2, 2), backbone_channels=(32, 64, 128), fpn_channels=(64, 64, 64), nms_pre=64,
        max_detections=10, score_threshold=0.3,
    )


def head_anchors(cfg: PointPillarsConfig) -> np.ndarray:
    """The (A, 7) anchors of the head's output grid (half the BEV grid)."""
    return _anchors(cfg, (cfg.grid_size[1] // 2, cfg.grid_size[0] // 2))


# ---------------------------------------------------------------------------
# targets and scenes (numpy)


def encode_boxes(gt: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Inverse of decode_boxes (DeltaXYZWLHR)."""
    diag = np.sqrt(anchors[:, 3] ** 2 + anchors[:, 4] ** 2)
    out = np.zeros_like(gt)
    out[:, 0] = (gt[:, 0] - anchors[:, 0]) / diag
    out[:, 1] = (gt[:, 1] - anchors[:, 1]) / diag
    out[:, 2] = (gt[:, 2] - anchors[:, 2]) / anchors[:, 5]
    out[:, 3] = np.log(gt[:, 3] / anchors[:, 3])
    out[:, 4] = np.log(gt[:, 4] / anchors[:, 4])
    out[:, 5] = np.log(gt[:, 5] / anchors[:, 5])
    out[:, 6] = gt[:, 6] - anchors[:, 6]
    return out


def assign_targets(anchors: np.ndarray, gt_boxes: np.ndarray, pos_dist: float = 1.2, neg_dist: float = 2.5):
    """(A, 7) anchors + (N, 7) gt -> class targets (A,) in {1, 0, -1 =
    ignored}, box deltas (A, 7) at positives, direction classes (A,)."""
    A = len(anchors)
    cls_t = np.zeros(A, np.float32)
    reg_t = np.zeros((A, 7), np.float32)
    dir_t = np.zeros(A, np.int32)
    if len(gt_boxes) == 0:
        return cls_t, reg_t, dir_t
    d = np.linalg.norm(anchors[:, None, :2] - gt_boxes[None, :, :2], axis=-1)          # (A, N)
    # rotation compatibility: the anchor rotation nearer the gt yaw
    dyaw = np.abs(np.remainder(anchors[:, None, 6] - gt_boxes[None, :, 6] + np.pi / 2, np.pi) - np.pi / 2)
    d_eff = d + 10.0 * (dyaw > np.pi / 4)                                               # wrong-rotation penalty
    best_gt = np.argmin(d_eff, axis=1)
    best_d = d_eff[np.arange(A), best_gt]
    cls_t[:] = -1.0
    cls_t[best_d > neg_dist] = 0.0
    pos = best_d < pos_dist
    # force-match each gt to its nearest anchor
    for g in range(len(gt_boxes)):
        a = int(np.argmin(d_eff[:, g]))
        pos[a] = True
        best_gt[a] = g
    cls_t[pos] = 1.0
    idx = np.nonzero(pos)[0]
    reg_t[idx] = encode_boxes(gt_boxes[best_gt[idx]], anchors[idx])
    dir_t[idx] = (np.cos(gt_boxes[best_gt[idx], 6] - anchors[idx, 6]) < 0.0).astype(np.int32)
    return cls_t, reg_t, dir_t


# a class target: ignored by the class loss but given a box target
REGRESS_ONLY = -2.0


def regress_ignored(anchors: np.ndarray, gt_boxes: np.ndarray, targets: tuple) -> tuple:
    """assign_targets' output with each ignored anchor (class target -1)
    given the box and direction targets of its nearest ground-truth box
    (by assign_targets' rotation-penalized distance) and the class target
    REGRESS_ONLY; positives and negatives are unchanged."""
    cls_t, reg_t, dir_t = (t.copy() for t in targets)
    ign = np.nonzero(cls_t < 0)[0]
    if len(gt_boxes) == 0 or len(ign) == 0:
        return cls_t, reg_t, dir_t
    a = anchors[ign]
    d = np.linalg.norm(a[:, None, :2] - gt_boxes[None, :, :2], axis=-1)
    dyaw = np.abs(np.remainder(a[:, None, 6] - gt_boxes[None, :, 6] + np.pi / 2, np.pi) - np.pi / 2)
    best = np.argmin(d + 10.0 * (dyaw > np.pi / 4), axis=1)
    cls_t[ign] = REGRESS_ONLY
    reg_t[ign] = encode_boxes(gt_boxes[best], a)
    dir_t[ign] = (np.cos(gt_boxes[best, 6] - a[:, 6]) < 0.0).astype(np.int32)
    return cls_t, reg_t, dir_t


def make_box_scene(rng, cfg: PointPillarsConfig, n_boxes=3):
    """A velodyne-frame scan with planted car-sized boxes: ground plane, box
    shell surfaces and clutter. Returns (scan (V, 4), gt (N, 7))."""
    x0, y0, _, x1, y1, _ = cfg.pc_range
    gt = []
    for _ in range(n_boxes):
        for _attempt in range(20):
            x = rng.uniform(x0 + 4.0, x1 - 4.0)
            y = rng.uniform(y0 + 4.0, y1 - 4.0)
            if all(np.hypot(x - g[0], y - g[1]) > 6.0 for g in gt):
                break
        yaw = rng.choice([0.0, np.pi / 2]) + rng.normal(0, 0.12)
        w, l, h = cfg.anchor_size
        gt.append([x, y, cfg.anchor_z, w, l, h, yaw])
    gt = np.asarray(gt, np.float32)

    parts = [np.stack([rng.uniform(x0, x1, 4000), rng.uniform(y0, y1, 4000),
                       np.full(4000, -1.6) + rng.normal(0, 0.02, 4000)], -1)]
    for b in gt:
        x, y, z, w, l, h, yaw = b
        n = 400
        # shell: samples on the 4 vertical faces
        u = rng.uniform(-0.5, 0.5, n)
        face = rng.integers(0, 4, n)
        fx = np.where(face == 0, u * l, np.where(face == 1, u * l, u * 0 + 0.5 * l * np.sign(rng.normal(size=n))))
        fy = np.where(face < 2, 0.5 * w * np.where(face == 0, 1, -1), u * w)
        fz = rng.uniform(0.0, h, n)
        c, s = np.cos(yaw), np.sin(yaw)
        parts.append(np.stack([x + c * fx - s * fy, y + s * fx + c * fy, z + fz], -1))
    parts.append(np.stack([rng.uniform(x0, x1, 300), rng.uniform(y0, y1, 300), rng.uniform(-1.5, 0.5, 300)], -1))
    pts = np.concatenate(parts).astype(np.float32)
    refl = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
    return np.concatenate([pts, refl], -1), gt


def scene_tensors(scan, gt, anchors, cfg: PointPillarsConfig, device, regress_band: bool = True):
    """A scene's quantized points and training targets (assign_targets,
    then regress_ignored unless `regress_band` is False, which gives the JAX
    trainer's targets) as tensors on `device`."""
    sp = {k: torch.from_numpy(np.asarray(v)).to(device)
          for k, v in crop_quantize_points(scan, cfg, point_cap=16384).items()}
    targets = assign_targets(anchors, gt)
    if regress_band:
        targets = regress_ignored(anchors, gt, targets)
    return sp, tuple(torch.from_numpy(t).to(device) for t in targets)


# ---------------------------------------------------------------------------
# losses and the plain trainer


def _focal_loss(logits, labels, mask, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(logits)
    pt = torch.where(labels > 0, p, 1.0 - p)
    a = torch.where(labels > 0, alpha, 1.0 - alpha)
    ce = -torch.log(torch.clamp(pt, min=1e-6))
    return torch.sum(a * (1.0 - pt) ** gamma * ce * mask)


def _smooth_l1(x, beta=1.0 / 9.0):
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _head_loss(cls, deltas, dirs, cls_t, reg_t, dir_t):
    """Focal class loss over positives and negatives; box and direction
    losses over positives and REGRESS_ONLY anchors; all over the positive
    count (with assign_targets' targets alone: JAX's loss)."""
    valid = (cls_t >= 0.0).to(torch.float32)
    n_pos = torch.clamp(torch.sum(cls_t > 0).to(torch.float32), min=1.0)
    l_cls = _focal_loss(cls, cls_t, valid) / n_pos
    reg = ((cls_t > 0) | (cls_t == REGRESS_ONLY)).to(torch.float32)[:, None]
    l_reg = torch.sum(_smooth_l1(deltas - reg_t) * reg) / n_pos
    logp = F.log_softmax(dirs, dim=-1)
    l_dir = -torch.sum(torch.gather(logp, 1, dir_t.to(torch.int64)[:, None])[:, 0] * reg[:, 0]) / n_pos
    return l_cls + 2.0 * l_reg + 0.2 * l_dir


def loss_fn(params, pillars, cls_t, reg_t, dir_t, cfg: PointPillarsConfig):
    """Focal class loss, smooth-L1 box loss and direction CE through the
    inference forward."""
    cls, deltas, dirs = forward(params, pillars, cfg)
    return _head_loss(cls, deltas, dirs, cls_t, reg_t, dir_t)


def cosine_decay(init_value: float, decay_steps: int):
    """optax.cosine_decay_schedule(init_value, decay_steps) as a per-step
    learning rate: step 0 takes init_value, step >= decay_steps takes 0."""
    def lr(step: int) -> float:
        t = min(step, decay_steps) / decay_steps
        return init_value * 0.5 * (1.0 + math.cos(math.pi * t))
    return lr


def train_step(params, trainer: Trainer, sparse: dict, targets: tuple, cfg: PointPillarsConfig) -> torch.Tensor:
    """Pillars built on the device from the quantized points, then one Adam
    step. Returns the loss as a device scalar (no host sync)."""
    loss = loss_fn(params, build_pillars_from_points(sparse, cfg), *targets, cfg)
    trainer.step(loss)
    return loss.detach()


def fit_synthetic(cfg: PointPillarsConfig, steps: int = 250, seed: int = 0, lr: float = 2e-3, n_boxes=3,
                  n_scenes: int | None = None, device=None):
    """Train on generated scenes (fresh each step, or an n_scenes-sized set
    iterated in epochs) -> (params, the last 5 losses). The inference
    network has no normalization (BatchNorm is folded at load), so this
    generalizes across scenes only after thousands of steps;
    `fit_synthetic_bn` is the generalizing trainer, `overfit_scene` the
    wiring check."""
    device = entry_device(device, "pointpillars_train")
    rng = np.random.default_rng(seed)
    anchors = head_anchors(cfg)
    params = trainable(init_params(cfg, torch.Generator().manual_seed(seed)), device)
    trainer = Trainer(leaves(params), lr)
    scenes = [scene_tensors(*make_box_scene(rng, cfg, n_boxes=n_boxes), anchors, cfg, device)
              for _ in range(n_scenes or 0)]
    losses = []
    for i in range(steps):
        sp, targets = scenes[i % len(scenes)] if scenes else scene_tensors(
            *make_box_scene(rng, cfg, n_boxes=n_boxes), anchors, cfg, device)
        losses.append(train_step(params, trainer, sp, targets, cfg))
    return tree_map(lambda t: t.detach(), params), [float(x) for x in losses[-5:]]


def overfit_scene(cfg: PointPillarsConfig, steps: int = 640, seed: int = 0, device=None,
                  regress_band: bool = True):
    """Overfit one generated scene, the end-to-end wiring check: with
    consistent assignment, encoding, network, decoding and NMS, a few
    hundred steps make make_prediction recover the planted boxes. The rate
    decays as a cosine over 1.6 x steps from 3e-3 (a constant rate leaves
    the box sizes' error ~1.2 m at 320-480 steps, decayed ~0.5). SECONDFPN's
    transposed deblocks (one kernel per phase of each upsampled block) take
    640 steps where the JAX package's resize + 3 x 3 convolution takes 320:
    at 320 (and seed 3 at 480) five of seeds 0-6 missed a planted box or
    kept a detection 2.5 m or more from every one; at 640 none did.
    `regress_band` False trains on the JAX trainer's targets (ROADMAP R9).
    Returns (params, scan, gt_boxes)."""
    device = entry_device(device, "pointpillars_train")
    rng = np.random.default_rng(seed)
    scan, gt = make_box_scene(rng, cfg, n_boxes=3)
    sp, targets = scene_tensors(scan, gt, head_anchors(cfg), cfg, device, regress_band)
    params = trainable(init_params(cfg, torch.Generator().manual_seed(seed)), device)
    trainer = Trainer(leaves(params), 3e-3, cosine_decay(3e-3, int(steps * 1.6)))
    for _ in range(steps):
        train_step(params, trainer, sp, targets, cfg)
    return tree_map(lambda t: t.detach(), params), scan, gt


# ---------------------------------------------------------------------------
# The BatchNorm trainer
#
# The inference network (pointpillars.forward) has no normalization: mmdet3d
# checkpoints arrive with their BatchNorm folded into the convolutions
# (load_mmdet3d_checkpoint). Training that folded form from scratch fits a
# scene but generalizes across scenes only after thousands of steps. This
# restores what mmdet trains with, conv -> BN -> ReLU everywhere
# (hv_pointpillars_secfpn_kitti.py norm_cfg=BN), as a float32 `train_forward`
# that mirrors `forward` layer by layer; `fold_bn_state` bakes the learned
# scale and shift and the running statistics back into inference weights,
# so inference costs the same. Batch statistics use the population variance
# (jnp.var); the running statistics are an EMA outside the optimizer (JAX's
# Adam gives them zero updates). nn.BatchNorm2d normalizes alike but keeps
# the unbiased variance as its running one, so it is not used.

BN_EPS = 1e-3
BN_MOMENTUM = 0.9     # fast-converging running statistics for short schedules


def init_bn_state(cfg: PointPillarsConfig, device=None) -> dict:
    def mk(c):
        return {"gamma": torch.ones(c, device=device), "beta": torch.zeros(c, device=device),
                "mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}

    return {
        "pfn": mk(cfg.pfn_channels),
        "blocks": [[mk(cout) for _ in range(n + 1)] for n, cout in zip(cfg.backbone_layers, cfg.backbone_channels)],
        "deblocks": [mk(c) for c in cfg.fpn_channels],
    }


def bn_trainables(bn: dict) -> list:
    """The learned BN tensors (gamma, beta); mean and var are running
    statistics."""
    return [t for node in [bn["pfn"], *sum(bn["blocks"], []), *bn["deblocks"]] for t in (node["gamma"], node["beta"])]


def _bn_conv_train(x, bnp):
    """(N, C, H, W) batch-statistics BatchNorm -> (y, (mean, var))."""
    mu = torch.mean(x, dim=(0, 2, 3))
    var = torch.var(x, dim=(0, 2, 3), unbiased=False)
    xh = (x - mu[None, :, None, None]) * torch.rsqrt(var[None, :, None, None] + BN_EPS)
    return xh * bnp["gamma"][None, :, None, None] + bnp["beta"][None, :, None, None], (mu, var)


def train_forward(params, bn, pillars, cfg: PointPillarsConfig):
    """`forward` with conv -> BN -> ReLU, in float32 -> (cls, box, dir,
    batch statistics shaped like bn's (mean, var) pairs)."""
    f, m = pillars["features"], pillars["mask"]
    h = f @ params["pfn"]["w"]
    # masked point-wise BN over the valid points (mmdet's PFNLayer)
    w = (m[..., None] > 0).to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mu_p = torch.sum(h * w, dim=(0, 1)) / n
    var_p = torch.sum(((h - mu_p) ** 2) * w, dim=(0, 1)) / n
    h = (h - mu_p) * torch.rsqrt(var_p + BN_EPS) * bn["pfn"]["gamma"] + bn["pfn"]["beta"]
    h = torch.relu(h)
    h = torch.amax(torch.where(m[..., None] > 0, h, -1e9), dim=1)
    pm = pillars["pillar_mask"]
    h = h * pm[:, None]

    nx, ny = cfg.grid_size
    coords = pillars["coords"].to(torch.int64)
    # accumulate onto zeros, as forward's canvas does (live pillars are unique)
    canvas = torch.zeros(cfg.pfn_channels, ny * nx, device=f.device).index_add_(
        1, coords[:, 1] * nx + coords[:, 0], (h * pm[:, None]).T)
    x = canvas.view(1, cfg.pfn_channels, ny, nx)

    stats = {"pfn": (mu_p, var_p), "blocks": [], "deblocks": []}
    outs = []
    for block, bns, stride, dp, dbn in zip(params["blocks"], bn["blocks"], cfg.backbone_strides,
                                           params["deblocks"], bn["deblocks"]):
        bstats = []
        for li, (layer, lbn) in enumerate(zip(block, bns)):
            x, s = _bn_conv_train(conv2d_same(x, layer, stride if li == 0 else 1), lbn)
            bstats.append(s)
            x = torch.relu(x)
        stats["blocks"].append(bstats)
        y, s = _bn_conv_train(conv_transpose2d(x, dp), dbn)
        stats["deblocks"].append(s)
        outs.append(torch.relu(y))
    feat = torch.cat(outs, dim=1)

    cls = conv2d_same(feat, params["head_cls"])[0]
    box = conv2d_same(feat, params["head_box"])[0]
    direc = conv2d_same(feat, params["head_dir"])[0]
    n_rot = len(cfg.anchor_rotations)
    H, W = cls.shape[-2:]
    cls = cls.reshape(n_rot, H, W).permute(1, 2, 0).reshape(-1)
    box = box.reshape(n_rot, 7, H, W).permute(2, 3, 0, 1).reshape(-1, 7)
    direc = direc.reshape(n_rot, 2, H, W).permute(2, 3, 0, 1).reshape(-1, 2)
    return cls, box, direc, stats


def loss_fn_bn(params, bn, pillars, cls_t, reg_t, dir_t, cfg: PointPillarsConfig):
    """loss_fn through train_forward -> (loss, batch statistics)."""
    cls, deltas, dirs, stats = train_forward(params, bn, pillars, cfg)
    return _head_loss(cls, deltas, dirs, cls_t, reg_t, dir_t), stats


@torch.no_grad()
def update_running_stats(bn: dict, stats: dict):
    """Momentum EMA of the batch statistics into bn's mean and var."""
    def upd(bnp, s):
        mu, var = s
        bnp["mean"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mu)
        bnp["var"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)

    upd(bn["pfn"], stats["pfn"])
    for bns, bstats in zip(bn["blocks"], stats["blocks"]):
        for lbn, s in zip(bns, bstats):
            upd(lbn, s)
    for dbn, s in zip(bn["deblocks"], stats["deblocks"]):
        upd(dbn, s)


def train_step_bn(params, bn, trainer: Trainer, sparse: dict, targets: tuple, cfg: PointPillarsConfig):
    """One Adam step over params and BN scale / shift, then the running
    statistics' EMA. Returns the loss as a device scalar."""
    loss, stats = loss_fn_bn(params, bn, build_pillars_from_points(sparse, cfg), *targets, cfg)
    trainer.step(loss)
    update_running_stats(bn, stats)
    return loss.detach()


def _fold_one(p, bnp, conv: bool, transposed: bool = False):
    """BN folded into the layer before it: along a kernel's output axis
    (0 of a conv's OIHW, 1 of a transposed conv's IOHW, 1 of a linear's
    (in, out))."""
    scale = bnp["gamma"] / torch.sqrt(bnp["var"] + BN_EPS)
    w = p["w"] * (scale[None, :, None, None] if transposed else scale[:, None, None, None] if conv
                  else scale[None, :])
    return {"w": w, "b": (p["b"] - bnp["mean"]) * scale + bnp["beta"]}


@torch.no_grad()
def fold_bn_state(params, bn) -> dict:
    """BN (learned gamma / beta and running statistics) baked into
    inference weights that pointpillars.forward takes unchanged."""
    return {
        "pfn": _fold_one(params["pfn"], bn["pfn"], conv=False),
        "blocks": [[_fold_one(layer, lbn, conv=True) for layer, lbn in zip(block, bns)]
                   for block, bns in zip(params["blocks"], bn["blocks"])],
        "deblocks": [_fold_one(d, dbn, conv=True, transposed=True)
                     for d, dbn in zip(params["deblocks"], bn["deblocks"])],
        **{k: {"w": params[k]["w"].detach().clone(), "b": params[k]["b"].detach().clone()}
           for k in ("head_cls", "head_box", "head_dir")},
    }


def fit_synthetic_bn(cfg: PointPillarsConfig, steps: int = 400, seed: int = 0, lr: float = 2e-3, n_boxes=3,
                     device=None):
    """Cross-scene training with BatchNorm (a fresh scene per step) ->
    (folded inference params, the last 5 losses). The rate decays as a
    cosine over 3 x steps: a full decay within `steps` collapses the rate
    before the trunk learns."""
    device = entry_device(device, "pointpillars_train")
    rng = np.random.default_rng(seed)
    anchors = head_anchors(cfg)
    params = trainable(init_params(cfg, torch.Generator().manual_seed(seed)), device)
    bn = init_bn_state(cfg, device)
    for t in bn_trainables(bn):
        t.requires_grad_(True)
    trainer = Trainer(leaves(params) + bn_trainables(bn), lr, cosine_decay(lr, 3 * steps))
    losses = []
    for _ in range(steps):
        sp, targets = scene_tensors(*make_box_scene(rng, cfg, n_boxes=n_boxes), anchors, cfg, device)
        losses.append(train_step_bn(params, bn, trainer, sp, targets, cfg))
    return fold_bn_state(params, bn), [float(x) for x in losses[-5:]]


# ---------------------------------------------------------------------------
# the closed loops' checks (tests/test_detector_closed_loop.py)

def closed_loop_report(boxes: np.ndarray, gt_boxes: np.ndarray, cfg: PointPillarsConfig) -> dict:
    """What tests/test_detector_closed_loop.py's PointPillars case asserts
    on make_prediction's boxes for the planted scan: each planted box's
    distance to its nearest detection (`dists`, m), each detection's to its
    nearest planted box (`far`), the largest width and length errors
    against the anchor size; `found` (a detection per planted box, each
    within 1 m), `clean` (no detection 2.5 m or more from every planted
    box), `sizes` (width within 0.6 m, length within 1 m) and `ok` (all)."""
    boxes = np.asarray(boxes)
    n = len(boxes)
    dists = [float(np.hypot(boxes[:, 0] - g[0], boxes[:, 1] - g[1]).min()) if n else float("inf")
             for g in gt_boxes]
    far = [float(np.hypot(gt_boxes[:, 0] - b[0], gt_boxes[:, 1] - b[1]).min()) for b in boxes]
    w_err = float(np.abs(boxes[:, 3] - cfg.anchor_size[0]).max()) if n else float("inf")
    l_err = float(np.abs(boxes[:, 4] - cfg.anchor_size[1]).max()) if n else float("inf")
    found = n >= len(gt_boxes) and max(dists, default=0.0) < 1.0
    clean = max(far, default=0.0) < 2.5
    sizes = w_err < 0.6 and l_err < 1.0
    return {"detections": n, "dists": dists, "far": far, "w_err": w_err, "l_err": l_err,
            "found": bool(found), "clean": bool(clean), "sizes": bool(sizes), "ok": bool(found and clean and sizes)}


def cross_scene_report(predict, cfg: PointPillarsConfig, seed: int = 777, n_scenes: int = 4) -> dict:
    """tests/test_detector_closed_loop.py's BN case: `predict` (a scan ->
    boxes, e.g. Detector3D.make_prediction) on `n_scenes` unseen scenes of
    3 planted boxes drawn from `seed`; a planted box is recovered by a
    detection within 1.5 m, and `ok` needs three quarters of them."""
    rng = np.random.default_rng(seed)
    recovered, total = 0, 0
    for _ in range(n_scenes):
        scan, gt = make_box_scene(rng, cfg, n_boxes=3)
        boxes = np.asarray(predict(scan))
        total += len(gt)
        recovered += sum(1 for g in gt if len(boxes)
                         and np.min(np.linalg.norm(boxes[:, :2] - g[None, :2], axis=1)) < 1.5)
    need = int(0.75 * total)
    return {"recovered": recovered, "total": total, "need": need, "ok": recovered >= need}
