"""PointPillars 3D object detector, PyTorch inference.

Port of dspslam_tpu/detect/pointpillars.py, the reference's mmdet3d
VoxelNet wrapper (reconstruct/detector3d.py + configs/
config_pointpillars.py) rebuilt from scratch:

  crop + quantize (host) -> pillar assignment (device: sort, segment,
  densest-P top-k) -> PillarFeatureNet (linear + ReLU + max) -> scatter to
  the BEV canvas -> SECOND backbone (3 conv stages, bf16) -> SECONDFPN neck
  (transposed convolutions, kernel = stride, + concat) -> Anchor3DHead ->
  sigmoid scores + delta decoding -> exact rotated-IoU greedy NMS -> (N, 7)
  boxes

Fixed-cap pillar tensors (max_pillars x max_points_per_pillar), a fixed-K
NMS (kernels/greedy_nms.py) and no host sync between the point upload and
the pinned copies of the boxes, so `Detector3D.dispatch` returns while the
card works. Duplicate-index scatters are written so that their result has
no defined winner to depend on: only valid entries carry values, and the BEV canvas
is an accumulation onto zeros of unique live pillars. BatchNorm is folded
into the weights at load time (`load_mmdet3d_checkpoint`).

Defaults mirror config_pointpillars.py: range [-20,-39.68,-3, 49.12,
39.68, 1], voxel 0.16x0.16x4, car anchor (1.6, 3.9, 1.56) at z=-1.78
with rotations {0, pi/2}, score threshold 0.1, 50 boxes max. mmdet3d's
KITTI configs cap the pillars at max_voxels (16000, 40000) (train, test);
the default cap stays the JAX package's 12000.

The stage functions (`build_pillars_from_points`, `forward`,
`select_detections`) are module attributes that `Detector3D.run` calls
through the module: the benchmark's check taps them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels.greedy_nms import greedy_suppress
from ..ops.rotated_iou import rotated_iou_matrix
from ..slam.map import entry_device, to_torch
from ..slam.tracking import _host_result, _prefetch_to_host
from ..utils import timing
from .layers import conv2d_same, conv_transpose2d, he_normal, top_k, tree_map, true_div
from .layers import params_from_jax  # noqa: F401  (JAX numpy pytree -> tensors)


@dataclasses.dataclass(frozen=True)
class PointPillarsConfig:
    pc_range: tuple = (-20.0, -39.68, -3.0, 49.12, 39.68, 1.0)
    voxel_size: tuple = (0.16, 0.16, 4.0)
    max_points_per_pillar: int = 32
    max_pillars: int = 12000
    pfn_channels: int = 64
    backbone_layers: tuple = (3, 5, 5)
    backbone_strides: tuple = (2, 2, 2)
    backbone_channels: tuple = (64, 128, 256)
    fpn_upsample: tuple = (1, 2, 4)
    fpn_channels: tuple = (128, 128, 128)
    anchor_size: tuple = (1.6, 3.9, 1.56)     # (w, l, h)
    anchor_z: float = -1.78
    anchor_rotations: tuple = (0.0, 1.57)
    score_threshold: float = 0.1
    nms_iou_threshold: float = 0.5
    nms_pre: int = 100
    max_detections: int = 50

    @property
    def grid_size(self):
        nx = int(round((self.pc_range[3] - self.pc_range[0]) / self.voxel_size[0]))
        ny = int(round((self.pc_range[4] - self.pc_range[1]) / self.voxel_size[1]))
        return nx, ny   # 432, 496


# ---------------------------------------------------------------------------
# Pillarization on the host (numpy copies of the JAX package's)


def _crop(points: np.ndarray, cfg: PointPillarsConfig) -> np.ndarray:
    x0, y0, z0, x1, y1, z1 = cfg.pc_range
    keep = (
        (points[:, 0] >= x0) & (points[:, 0] < x1)
        & (points[:, 1] >= y0) & (points[:, 1] < y1)
        & (points[:, 2] >= z0) & (points[:, 2] < z1)
    )
    return points[keep]


def _host_slots(pts: np.ndarray, cfg: PointPillarsConfig):
    """Host pillar assignment: (uniq keys in slot order, slot of each
    point (-1 past the cap), per-point order by slot, in-slot ranks)."""
    x0, y0 = cfg.pc_range[:2]
    vx, vy, _ = cfg.voxel_size
    ix = ((pts[:, 0] - x0) / vx).astype(np.int64)
    iy = ((pts[:, 1] - y0) / vy).astype(np.int64)
    nx, _ = cfg.grid_size
    key = iy * nx + ix
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    order = np.argsort(-counts)[: cfg.max_pillars]     # densest pillars first
    slot_of = np.full(len(uniq), -1, np.int64)
    slot_of[order] = np.arange(len(order))
    slots = slot_of[inv]
    pt_order = np.argsort(slots, kind="stable")
    ss = slots[pt_order]
    ranks = np.arange(len(ss)) - np.searchsorted(ss, ss)
    return uniq[order], ss, pt_order, ranks


def pillarize(points: np.ndarray, cfg: PointPillarsConfig):
    """Raw scan (N, 4) -> fixed-cap pillar tensors: dict(features (P, M,
    10), mask (P, M), coords (P, 2) [ix, iy], pillar_mask (P,)). The 10
    per-point features follow PillarFeatureNet: x, y, z, r, offsets to the
    pillar centroid (3), offsets to the pillar center (2), z offset to the
    anchor plane."""
    x0, y0 = cfg.pc_range[:2]
    vx, vy, _ = cfg.voxel_size
    P, M = cfg.max_pillars, cfg.max_points_per_pillar
    nx, _ = cfg.grid_size
    pts = _crop(points, cfg)
    keys, ss, pt_order, ranks = _host_slots(pts, cfg)

    feats = np.zeros((P, M, 10), np.float32)
    mask = np.zeros((P, M), np.float32)
    coords = np.zeros((P, 2), np.int32)
    coords[: len(keys), 0] = (keys % nx).astype(np.int32)
    coords[: len(keys), 1] = (keys // nx).astype(np.int32)
    sel = (ss >= 0) & (ranks < M)
    s_idx = ss[sel]
    r_idx = ranks[sel]
    p_sel = pts[pt_order[sel]]
    feats[s_idx, r_idx, :4] = p_sel[:, :4]
    mask[s_idx, r_idx] = 1.0
    n_per = np.bincount(s_idx, minlength=P).astype(np.float32)
    pillar_mask = (n_per > 0).astype(np.float32)

    denom = np.maximum(n_per, 1.0)
    cent = np.stack(
        [np.bincount(s_idx, weights=p_sel[:, c], minlength=P) / denom for c in range(3)],
        axis=-1,
    ).astype(np.float32)                                       # (P, 3)
    feats[s_idx, r_idx, 4:7] = p_sel[:, :3] - cent[s_idx]
    cx = coords[:, 0] * vx + x0 + vx / 2.0
    cy = coords[:, 1] * vy + y0 + vy / 2.0
    feats[s_idx, r_idx, 7] = p_sel[:, 0] - cx[s_idx]
    feats[s_idx, r_idx, 8] = p_sel[:, 1] - cy[s_idx]
    feats[s_idx, r_idx, 9] = p_sel[:, 2] - cfg.anchor_z
    return {"features": feats, "mask": mask, "coords": coords, "pillar_mask": pillar_mask}


PT_QUANT = 0.002    # fixed-point resolution of the uploaded points (meters / unit)


def _point_cap(n: int) -> int:
    # the kept-point count rounded up to a multiple of 16384
    return max(16384, -(-n // 16384) * 16384)


def pillarize_sparse(points: np.ndarray, cfg: PointPillarsConfig, point_cap: int | None = None):
    """Host pillar ASSIGNMENT only -> fixed-cap sparse arrays that
    build_pillars_device scatters on the device: dict(pts_q (C, 4) i16 in
    2 mm units, s_idx (C,) u16, r_idx (C,) u8, n_pts () i32, coords (P, 2)
    i16, n_per (P,) u8) with C = point_cap (default the kept-point count
    rounded up to a multiple of 16384); points packed contiguously."""
    P, M = cfg.max_pillars, cfg.max_points_per_pillar
    assert P < 65536 and M < 256, "index dtypes too narrow"
    nx, _ = cfg.grid_size
    pts = _crop(points, cfg)
    C = point_cap or _point_cap(len(pts))
    keys, ss, pt_order, ranks = _host_slots(pts, cfg)
    coords = np.zeros((P, 2), np.int16)
    coords[: len(keys), 0] = (keys % nx).astype(np.int16)
    coords[: len(keys), 1] = (keys // nx).astype(np.int16)
    sel = (ss >= 0) & (ranks < M)
    s_idx = ss[sel][:C]
    r_idx = ranks[sel][:C]
    p_sel = pts[pt_order[sel]][:C]
    n = len(s_idx)
    out = {
        "s_idx": np.zeros(C, np.uint16),
        "r_idx": np.zeros(C, np.uint8),
        "pts_q": np.zeros((C, 4), np.int16),
        "n_pts": np.int32(n),
        "coords": coords,
        "n_per": np.bincount(s_idx, minlength=P).astype(np.uint8),
    }
    out["s_idx"][:n] = s_idx
    out["r_idx"][:n] = r_idx
    out["pts_q"][:n] = np.clip(np.round(p_sel[:, :4] / PT_QUANT), -32767, 32767).astype(np.int16)
    return out


def crop_quantize_points(points: np.ndarray, cfg: PointPillarsConfig, point_cap: int | None = None):
    """The host half of device pillar assignment: range crop and 2 mm
    fixed-point quantization -> dict(pts_q (C, 4) i16, n_pts () i32)."""
    pts = _crop(points, cfg)
    C = point_cap or _point_cap(len(pts))
    pts = pts[:C]
    out = {"pts_q": np.zeros((C, 4), np.int16), "n_pts": np.int32(len(pts))}
    out["pts_q"][: len(pts)] = np.clip(np.round(pts[:, :4] / PT_QUANT), -32767, 32767).astype(np.int16)
    return out


# ---------------------------------------------------------------------------
# Pillar build on the device


def _pillar_features(pts, s, r, sel, n_per, coords, cfg: PointPillarsConfig):
    """Dense PillarFeatureNet input from per-point slots: pts (C, 4) f32,
    slot s and rank r (C,) int64 (entries with sel 0 carry no value), kept
    points per slot n_per (P,), coords (P, 2) -> (features (P, M, 10), mask
    (P, M)). Centroids are segment sums over the kept points."""
    x0, y0 = cfg.pc_range[:2]
    vx, vy, _ = cfg.voxel_size
    P, M = cfg.max_pillars, cfg.max_points_per_pillar
    denom = torch.clamp(n_per, min=1.0)
    cent = torch.stack([
        torch.zeros(P, device=pts.device).index_add_(0, s, pts[:, c] * sel) / denom for c in range(3)
    ], dim=-1)                                                 # (P, 3) kept-point mean
    cx = coords[:, 0].to(torch.float32) * vx + x0 + vx / 2.0
    cy = coords[:, 1].to(torch.float32) * vy + y0 + vy / 2.0
    f10 = torch.cat([
        pts[:, :4],
        pts[:, :3] - cent.index_select(0, s),
        (pts[:, 0] - cx.index_select(0, s))[:, None],
        (pts[:, 1] - cy.index_select(0, s))[:, None],
        (pts[:, 2] - cfg.anchor_z)[:, None],
    ], dim=-1) * sel[:, None]
    # live entries own unique (slot, rank) cells; the rest add zeros
    flat = s * M + r
    feats = torch.zeros(P * M, 10, device=pts.device).index_add_(0, flat, f10).view(P, M, 10)
    mask = torch.zeros(P * M, device=pts.device).index_add_(0, flat, sel).view(P, M)
    return feats, torch.clamp(mask, max=1.0)


def build_pillars_from_points(sparse: dict, cfg: PointPillarsConfig) -> dict:
    """ON-DEVICE pillar assignment and dense pillar build: quantized points
    in (crop_quantize_points' dict as tensors), PillarFeatureNet input out.
    One stable sort over the flat pillar key, head-flag segmentation, a
    segment-sum histogram and a stable top-k for the densest P pillars
    (count ties: the lower pillar key first, as lax.top_k orders them).
    Keeps the first max_points_per_pillar points of a pillar in scan
    order."""
    x0, y0 = cfg.pc_range[:2]
    vx, vy, _ = cfg.voxel_size
    P, M = cfg.max_pillars, cfg.max_points_per_pillar
    nx, ny = cfg.grid_size
    pts_q = sparse["pts_q"]
    dev = pts_q.device
    C = pts_q.shape[0]

    idx = torch.arange(C, dtype=torch.int64, device=dev)
    live = idx < sparse["n_pts"]
    pts = pts_q.to(torch.float32) * PT_QUANT
    ix = torch.clamp(true_div(pts[:, 0] - x0, vx).to(torch.int64), 0, nx - 1)
    iy = torch.clamp(true_div(pts[:, 1] - y0, vy).to(torch.int64), 0, ny - 1)
    key = torch.where(live, iy * nx + ix, nx * ny)          # dead points sort last

    order = torch.argsort(key, stable=True)                 # scan order kept within a pillar
    k_s = key.index_select(0, order)
    pts_s = pts.index_select(0, order)
    live_s = live.index_select(0, order)
    head = live_s & ((idx == 0) | (k_s != torch.roll(k_s, 1)))
    g = torch.clamp(torch.cumsum(head.to(torch.int64), 0) - 1, min=0)     # group id
    seg_start = torch.cummax(torch.where(head, idx, 0), 0).values
    rank = idx - seg_start                                  # scan-order rank in pillar

    G = max(C, P)                                           # group slots (a short scan has fewer than P)
    counts = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(0, g, live_s.to(torch.int64))
    top_counts, top_g = top_k(counts, P)                   # densest pillars first
    slot_of_g = torch.full((G,), -1, dtype=torch.int64, device=dev).scatter_(
        0, top_g, torch.arange(P, dtype=torch.int64, device=dev))
    s = slot_of_g.index_select(0, g)                        # (C,) slot or -1
    sel_b = live_s & (s >= 0) & (rank < M)
    sel = sel_b.to(torch.float32)
    s_safe = torch.where(sel_b, s, P - 1)
    r_safe = torch.where(sel_b, rank, M - 1)

    key_by_g = torch.zeros(G, dtype=torch.int64, device=dev).scatter_reduce_(
        0, g, torch.where(live_s, k_s, 0), reduce="amax")
    key_of_slot = key_by_g.index_select(0, top_g)
    pillar_mask = (top_counts > 0).to(torch.float32)
    coords = torch.stack([key_of_slot % nx, key_of_slot // nx], dim=-1) * (top_counts > 0)[:, None]

    n_per = torch.zeros(P, device=dev).index_add_(0, s_safe, sel)
    feats, mask = _pillar_features(pts_s, s_safe, r_safe, sel, n_per, coords, cfg)
    return {"features": feats, "mask": mask, "coords": coords.to(torch.int32),
            "pillar_mask": pillar_mask}


def build_pillars_device(sparse: dict, cfg: PointPillarsConfig) -> dict:
    """Scatter pillarize_sparse's per-point arrays (as tensors) into the
    dense PillarFeatureNet input on the device."""
    P, M = cfg.max_pillars, cfg.max_points_per_pillar
    dev = sparse["pts_q"].device
    C = sparse["s_idx"].shape[0]
    live_b = torch.arange(C, device=dev) < sparse["n_pts"]
    live = live_b.to(torch.float32)
    s = torch.where(live_b, sparse["s_idx"].to(torch.int64), P - 1)
    r = torch.where(live_b, sparse["r_idx"].to(torch.int64), M - 1)
    pts = sparse["pts_q"].to(torch.float32) * PT_QUANT
    coords = sparse["coords"].to(torch.int32)
    feats, mask = _pillar_features(pts, s, r, live, sparse["n_per"].to(torch.float32), coords, cfg)
    return {"features": feats, "mask": mask, "coords": coords,
            "pillar_mask": (sparse["n_per"] > 0).to(torch.float32)}


# ---------------------------------------------------------------------------
# Network


def _conv_init(gen, cin, cout, k=3):
    return {"w": he_normal(gen, (cout, cin, k, k), cin * k * k), "b": torch.zeros(cout)}


def init_params(cfg: PointPillarsConfig, gen: torch.Generator | None = None, device=None) -> dict:
    """He-normal weights from a seeded generator (seed 0 when none is
    given), in the JAX package's tree layout; the classifier starts at the
    focal-loss prior P(object) = 0.01."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    params = {
        "pfn": {"w": he_normal(gen, (10, cfg.pfn_channels), 10), "b": torch.zeros(cfg.pfn_channels)},
        "blocks": [],
        "deblocks": [],
    }
    cin = cfg.pfn_channels
    for n_layers, cout in zip(cfg.backbone_layers, cfg.backbone_channels):
        block = [_conv_init(gen, cin, cout)]
        block += [_conv_init(gen, cout, cout) for _ in range(n_layers)]
        params["blocks"].append(block)
        cin = cout
    for cin_b, cout, k in zip(cfg.backbone_channels, cfg.fpn_channels, cfg.fpn_upsample):
        # a transposed convolution, kernel = stride: (in, out, k, k)
        params["deblocks"].append({"w": he_normal(gen, (cin_b, cout, k, k), cin_b), "b": torch.zeros(cout)})
    feat = sum(cfg.fpn_channels)
    n_anchor = len(cfg.anchor_rotations)
    params["head_cls"] = _conv_init(gen, feat, n_anchor, k=1)
    params["head_cls"]["b"] = torch.full((n_anchor,), -float(np.log(99.0)))
    params["head_box"] = _conv_init(gen, feat, n_anchor * 7, k=1)
    params["head_dir"] = _conv_init(gen, feat, n_anchor * 2, k=1)
    return tree_map(lambda t: t.to(device), params)


def forward(params: dict, pillars: dict, cfg: PointPillarsConfig):
    """Pillar tensors -> (cls (A,), boxes (A, 7), dirs (A, 2)) flattened
    over the BEV anchor grid. The PFN is f32; the BEV backbone, neck and
    heads run in bf16 (JAX's choice), the outputs come back as f32."""
    f = pillars["features"]                    # (P, M, 10)
    m = pillars["mask"]                        # (P, M)
    pm = pillars["pillar_mask"]
    h = torch.relu(f @ params["pfn"]["w"] + params["pfn"]["b"])        # (P, M, C)
    h = torch.amax(torch.where(m[..., None] > 0, h, -1e9), dim=1)
    h = h * pm[:, None]                                                 # (P, C)

    nx, ny = cfg.grid_size
    coords = pillars["coords"].to(torch.int64)
    # every empty pillar sits at cell (0, 0) with value 0: accumulating onto
    # zeros leaves a live pillar there intact (a set has no defined winner)
    canvas = torch.zeros(cfg.pfn_channels, ny * nx, device=f.device).index_add_(
        1, coords[:, 1] * nx + coords[:, 0], (h * pm[:, None]).T)
    x = canvas.view(1, cfg.pfn_channels, ny, nx).to(torch.bfloat16)

    outs = []
    for block, stride, dp in zip(params["blocks"], cfg.backbone_strides, params["deblocks"]):
        x = torch.relu(conv2d_same(x, block[0], stride))
        for layer in block[1:]:
            x = torch.relu(conv2d_same(x, layer))
        outs.append(torch.relu(conv_transpose2d(x, dp)))           # upsample by its kernel
    feat = torch.cat(outs, dim=1)                                       # (1, 384, H/2, W/2)

    cls = conv2d_same(feat, params["head_cls"])[0].to(torch.float32)
    box = conv2d_same(feat, params["head_box"])[0].to(torch.float32)
    direc = conv2d_same(feat, params["head_dir"])[0].to(torch.float32)
    n_rot = len(cfg.anchor_rotations)
    H, W = cls.shape[-2:]
    cls = cls.reshape(n_rot, H, W).permute(1, 2, 0).reshape(-1)
    box = box.reshape(n_rot, 7, H, W).permute(2, 3, 0, 1).reshape(-1, 7)
    direc = direc.reshape(n_rot, 2, H, W).permute(2, 3, 0, 1).reshape(-1, 2)
    return cls, box, direc


def _anchors(cfg: PointPillarsConfig, feat_hw) -> np.ndarray:
    """Flattened anchor boxes matching the head layout: (A, 7)."""
    H, W = feat_hw
    x0, y0 = cfg.pc_range[0], cfg.pc_range[1]
    sx = (cfg.pc_range[3] - x0) / W
    sy = (cfg.pc_range[4] - y0) / H
    xs = x0 + (np.arange(W) + 0.5) * sx
    ys = y0 + (np.arange(H) + 0.5) * sy
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    w, l, h = cfg.anchor_size
    out = []
    for r in cfg.anchor_rotations:
        a = np.zeros((H, W, 7), np.float32)
        a[..., 0] = gx
        a[..., 1] = gy
        a[..., 2] = cfg.anchor_z
        a[..., 3:6] = (w, l, h)
        a[..., 6] = r
        out.append(a)
    return np.stack(out, axis=2).reshape(-1, 7)   # (H*W*n_rot, 7)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """DeltaXYZWLHR decoding: (A, 7) deltas + anchors -> boxes
    [x, y, z, w, l, h, yaw]."""
    diag = torch.sqrt(anchors[:, 3] ** 2 + anchors[:, 4] ** 2)
    x = deltas[:, 0] * diag + anchors[:, 0]
    y = deltas[:, 1] * diag + anchors[:, 1]
    z = deltas[:, 2] * anchors[:, 5] + anchors[:, 2]
    w = torch.exp(deltas[:, 3]) * anchors[:, 3]
    l = torch.exp(deltas[:, 4]) * anchors[:, 4]
    h = torch.exp(deltas[:, 5]) * anchors[:, 5]
    yaw = deltas[:, 6] + anchors[:, 6]
    return torch.stack([x, y, z, w, l, h, yaw], dim=-1)


def select_detections(cls_logits, boxes, dir_logits, cfg: PointPillarsConfig):
    """Scores -> top-k pre-NMS -> exact BEV rotated-IoU greedy NMS (fixed
    shape). Returns (boxes (K, 7), scores (K,), valid (K,)) with K =
    max_detections; the direction classifier flips yaw by pi."""
    scores = torch.sigmoid(cls_logits)
    top_scores, idx = top_k(scores, cfg.nms_pre)
    cand = boxes.index_select(0, idx)
    d = dir_logits.index_select(0, idx)
    flip = (d[:, 1] > d[:, 0]).to(torch.float32)
    cand = torch.cat([cand[:, :6], (cand[:, 6] + flip * math.pi)[:, None]], dim=1)
    iou = rotated_iou_matrix(cand, cand)                  # (nms_pre, nms_pre)
    j, s, ok = greedy_suppress(iou, top_scores, cfg.max_detections, cfg.nms_iou_threshold, -1.0,
                               cfg.score_threshold, keep_inclusive=True)
    keep_boxes = torch.where(ok[:, None], cand.index_select(0, j), 0.0)
    return keep_boxes, torch.where(ok, s, 0.0), ok.to(torch.float32)


class Detector3D:
    """Online 3D detector (the reference detector3d.py API). `device` None
    means cuda; cuda without a card raises.

    device_assign=True (default) uploads the cropped, quantized points and
    assigns pillars on the device (build_pillars_from_points);
    device_assign=False assigns them on the host (pillarize_sparse) and
    scatters on the device."""

    def __init__(self, params=None, cfg: PointPillarsConfig = PointPillarsConfig(),
                 device_assign: bool = True, device=None):
        self.device = entry_device(device, "Detector3D")
        self.cfg = cfg
        self.device_assign = device_assign
        params = params if params is not None else init_params(cfg)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.anchors = to_torch(_anchors(cfg, (cfg.grid_size[1] // 2, cfg.grid_size[0] // 2)), self.device)
        self.dispatches = 0

    def run(self, sparse: dict):
        """The network on uploaded tensors -> (boxes, scores, valid)."""
        build = build_pillars_from_points if self.device_assign else build_pillars_device
        cls, deltas, dirs = forward(self.params, build(sparse, self.cfg), self.cfg)
        return select_detections(cls, decode_boxes(deltas, self.anchors), dirs, self.cfg)

    def upload(self, velo_points: np.ndarray) -> dict:
        """Host half: crop + quantize (or assign pillars), pinned uploads."""
        if self.device_assign:
            sp = crop_quantize_points(velo_points, self.cfg)
        else:
            sp = pillarize_sparse(velo_points, self.cfg)
            sp["s_idx"] = sp["s_idx"].astype(np.int32)    # torch has few uint16 ops
        timing.count("det3d_points", int(sp["n_pts"]))
        return {k: to_torch(v, self.device) for k, v in sp.items()}

    def dispatch(self, velo_points: np.ndarray):
        """Async half of make_prediction: upload, enqueue the network and
        start pinned copies of the boxes, without waiting for the device.
        Returns a handle for collect()."""
        with timing.span("det3d_dispatch"):
            out_boxes, _, valid = self.run(self.upload(velo_points))
            self.dispatches += 1
            return _prefetch_to_host({"out": {"boxes": out_boxes, "valid": valid}})

    @staticmethod
    def collect(handle) -> np.ndarray:
        out = _host_result(*handle)["out"]
        boxes = out["boxes"][out["valid"] > 0]
        timing.count("det3d_kept", len(boxes))
        return boxes

    def make_prediction(self, velo_points: np.ndarray) -> np.ndarray:
        """(N, 4) scan -> (K, 7) [x, y, z, w, l, h, yaw] car boxes."""
        return self.collect(self.dispatch(velo_points))


# ---------------------------------------------------------------------------
# mmdet3d checkpoint ingestion


def _fold_bn(w, b, bn_w, bn_b, bn_mean, bn_var, eps=1e-3):
    """Fold BatchNorm into the preceding conv/linear (inference)."""
    scale = bn_w / np.sqrt(bn_var + eps)
    if w.ndim == 4:
        w = w * scale[:, None, None, None]
    else:
        w = w * scale[:, None]
    b = (b - bn_mean) * scale + bn_b
    return w, b


def load_mmdet3d_checkpoint(path: str, cfg: PointPillarsConfig = PointPillarsConfig()) -> dict:
    """Ingest an mmdet3d PointPillars .pth (the key conventions of the
    reference's configs/config_pointpillars.py model) -> a parameter tree
    of CPU f32 tensors."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    sd = saved.get("state_dict", saved)
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def conv_bn(w, bn):
        wf, bf = _fold_bn(w, np.zeros(w.shape[0]), sd[bn + ".weight"], sd[bn + ".bias"],
                          sd[bn + ".running_mean"], sd[bn + ".running_var"])
        return wf, bf

    params = init_params(cfg)
    # PFN: linear + BN1d folded
    pfn = "voxel_encoder.pfn_layers.0"
    wf, bf = conv_bn(sd[pfn + ".linear.weight"], pfn + ".norm")      # (64, 10)
    params["pfn"] = {"w": t(wf.T), "b": t(bf)}
    # backbone blocks: conv (no bias) + BN pairs
    for bi in range(len(cfg.backbone_layers)):
        for li in range(cfg.backbone_layers[bi] + 1):
            wf, bf = conv_bn(sd[f"backbone.blocks.{bi}.{li * 3}.weight"], f"backbone.blocks.{bi}.{li * 3 + 1}")
            params["blocks"][bi][li] = {"w": t(wf), "b": t(bf)}
    # neck deblocks (ConvTranspose2d, kernel = stride, + BN): the (in, out,
    # k, k) kernel as it is, BN folded along its output axis
    for di in range(len(cfg.fpn_channels)):
        w = sd[f"neck.deblocks.{di}.0.weight"]
        wf, bf = conv_bn(w.transpose(1, 0, 2, 3), f"neck.deblocks.{di}.1")
        params["deblocks"][di] = {"w": t(wf.transpose(1, 0, 2, 3)), "b": t(bf)}
    for name, key in (("head_cls", "bbox_head.conv_cls"), ("head_box", "bbox_head.conv_reg"),
                      ("head_dir", "bbox_head.conv_dir_cls")):
        params[name] = {"w": t(sd[key + ".weight"]), "b": t(sd[key + ".bias"])}
    return params
