"""Plain PointPillars inference in float32, for the check of the port's 3D
detector (benchmark/detcheck.py) and the CPU tests.

Written from the published description (Lang et al., CVPR 2019;
mmdetection3d's hv_pointpillars_secfpn_6x8_160e_kitti-3d-car.py and the
modules it names) over an mmdet3d state dict as the checkpoint stores it:
PillarFeatureNet (a bias-free linear layer, BatchNorm1d, ReLU, the max over
a pillar's points), the scatter onto the BEV canvas, the SECOND backbone
(conv, BatchNorm, ReLU; the first conv of a block strided), SECONDFPN
(transposed convolutions whose kernel equals their stride, written as
their own sum, BatchNorm, ReLU; concatenated), the Anchor3DHead's 1x1
heads, and the rotated-box NMS with its overlaps in float64 polygon
clipping. It imports nothing of the port and nothing of JAX.

Where the port departs from mmdet3d's test path, the reference follows the
port, so that a gap measures the computation and not a convention. The
departures, as the port has them:
  - the cropped scan is quantized to 2 mm (int16) before the pillars are
    built, as the port uploads it;
  - the cap keeps the densest pillars (the lower BEV cell first among equal
    counts) where hard voxelization keeps the first ones in scan order
    (the same pillars while a scan has fewer than the cap);
  - the tenth point feature is z over the anchor plane (mmdet3d 0.x has 9
    features; 1.x's tenth is z over the voxel's centre);
  - a pillar's max skips its empty slots (mmdet3d zeroes their features
    first, so they take part);
  - stride-2 convolutions pad as XLA's SAME (mmdet3d pads 1 on every side);
  - anchors sit at cell centres with z their centre, deltas decode with z
    at the centre, and the direction classifier turns a box by pi where
    its second logit is the larger (mmdet3d: anchor ranges' linspace,
    bottom-centre z, dir_offset and limit_period);
  - a box's BEV rectangle has l along its heading and w across it.
Box decoding runs in the port's order of operations on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lowbits import F32
from .maskrcnn import conv, transposed_conv

BN_EPS = 1e-3
PT_QUANT = 0.002


def load(path: str, device=None) -> dict:
    """An mmdet3d checkpoint's state dict as float32 tensors on `device`."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    sd = saved.get("state_dict", saved)
    return {k: torch.as_tensor(v).to(device, torch.float32) for k, v in sd.items()}


def grid_size(cfg: dict) -> tuple:
    r, v = cfg["pc_range"], cfg["voxel_size"]
    return int(round((r[3] - r[0]) / v[0])), int(round((r[4] - r[1]) / v[1]))


# ---------------------------------------------------------------------------
# pillars


def pillars(scan: np.ndarray, cfg: dict) -> dict:
    """A raw scan (N, 4) -> the pillars in BEV-cell order: keys (n,) =
    iy nx + ix, features (n, M, 10) (x, y, z, r; offsets to the mean of
    the pillar's kept points; x, y offsets to the pillar's centre; z over
    the anchor plane), mask (n, M). A pillar keeps its first M points in
    scan order."""
    x0, y0, z0, x1, y1, z1 = cfg["pc_range"]
    vx, vy, _ = cfg["voxel_size"]
    M, P = cfg["max_points_per_pillar"], cfg["max_pillars"]
    nx, ny = grid_size(cfg)
    s = np.asarray(scan, np.float32)
    s = s[(s[:, 0] >= x0) & (s[:, 0] < x1) & (s[:, 1] >= y0) & (s[:, 1] < y1) & (s[:, 2] >= z0) & (s[:, 2] < z1)]
    q = np.clip(np.round(s[:, :4] / PT_QUANT), -32767, 32767).astype(np.int16)
    p = q.astype(np.float32) * np.float32(PT_QUANT)
    ix = np.clip(((p[:, 0] - np.float32(x0)) / np.float32(vx)).astype(np.int64), 0, nx - 1)
    iy = np.clip(((p[:, 1] - np.float32(y0)) / np.float32(vy)).astype(np.int64), 0, ny - 1)
    key = iy * nx + ix
    cells, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    keep = np.lexsort((cells, -counts))[:P]          # the densest P, the lower cell first
    keep.sort()
    n = len(keep)
    feats = np.zeros((n, M, 10), np.float64)
    mask = np.zeros((n, M), np.float32)
    slot = np.full(len(cells), -1)
    slot[keep] = np.arange(n)
    order = np.argsort(inverse, kind="stable")       # scan order within each pillar
    rank = np.empty(len(p), np.int64)
    rank[order] = np.arange(len(p)) - np.searchsorted(inverse[order], inverse[order])
    sel = (slot[inverse] >= 0) & (rank < M)
    si, ri, pp = slot[inverse[sel]], rank[sel], p[sel].astype(np.float64)
    mask[si, ri] = 1.0
    n_kept = np.bincount(si, minlength=n)
    mean = np.stack([np.bincount(si, pp[:, c], minlength=n) for c in range(3)], -1) / np.maximum(n_kept, 1)[:, None]
    kx, ky = cells[keep] % nx, cells[keep] // nx
    feats[si, ri, :4] = pp
    feats[si, ri, 4:7] = pp[:, :3] - mean[si]
    feats[si, ri, 7] = pp[:, 0] - (kx[si] * vx + x0 + vx / 2)
    feats[si, ri, 8] = pp[:, 1] - (ky[si] * vy + y0 + vy / 2)
    feats[si, ri, 9] = pp[:, 2] - cfg["anchor_z"]
    return {"keys": cells[keep], "features": feats.astype(np.float32), "mask": mask}


# ---------------------------------------------------------------------------
# network


def _bn(x, sd, key):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - sd[key + ".running_mean"].view(shape)) / torch.sqrt(sd[key + ".running_var"] + BN_EPS).view(shape) \
        * sd[key + ".weight"].view(shape) + sd[key + ".bias"].view(shape)


def forward(sd: dict, pil: dict, cfg: dict, prec=F32):
    """The network on pillar tensors (features (P, M, 10), mask (P, M),
    coords (P, 2) [ix, iy], pillar_mask (P,)) -> (class logits (A,), box
    deltas (A, 7), direction logits (A, 2)), A over (y, x, rotation)."""
    f, m, pm = pil["features"].float(), pil["mask"].float(), pil["pillar_mask"].float()
    pfn = "voxel_encoder.pfn_layers.0"
    h = prec.result(prec.operand(f) @ prec.operand(sd[pfn + ".linear.weight"]).T)        # (P, M, C)
    h = torch.relu(_bn(h.reshape(-1, h.shape[-1]), sd, pfn + ".norm")).reshape(h.shape)
    h = torch.where(m[..., None] > 0, h, torch.full_like(h, -float("inf"))).amax(1)
    h = torch.where(pm[:, None] > 0, h, torch.zeros_like(h))
    nx, ny = grid_size(cfg)
    c = h.shape[1]
    canvas = torch.zeros(c, ny, nx, device=f.device)
    live = pm > 0
    xy = pil["coords"].long()[live]
    canvas[:, xy[:, 1], xy[:, 0]] = h[live].T
    x = canvas[None]
    outs = []
    for bi, (n, stride) in enumerate(zip(cfg["backbone_layers"], cfg["backbone_strides"])):
        for li in range(n + 1):
            key = f"backbone.blocks.{bi}.{li * 3}"
            x = torch.relu(_bn(conv(x, sd[key + ".weight"], stride=stride if li == 0 else 1, prec=prec), sd,
                               f"backbone.blocks.{bi}.{li * 3 + 1}"))
        w = sd[f"neck.deblocks.{bi}.0.weight"]
        up = transposed_conv(x, w, torch.zeros(w.shape[1], device=w.device), prec=prec)
        outs.append(torch.relu(_bn(up, sd, f"neck.deblocks.{bi}.1")))
    feat = torch.cat(outs, 1)
    n_rot = len(cfg["anchor_rotations"])
    out = []
    for k in ("conv_cls", "conv_reg", "conv_dir_cls"):
        t = conv(feat, sd[f"bbox_head.{k}.weight"], sd[f"bbox_head.{k}.bias"], prec=prec)[0]
        H, W = t.shape[-2:]
        out.append(t.reshape(n_rot, -1, H, W).permute(2, 3, 0, 1).reshape(H * W * n_rot, -1))  # (y, x, rot, k)
    return out[0][:, 0], out[1], out[2]


def anchors(cfg: dict, feat_hw, device=None):
    """(H W R, 7) anchors [x, y, z, w, l, h, yaw] at the feature cells'
    centres, (y, x, rotation) order, worked out in float64."""
    H, W = feat_hw
    r = cfg["pc_range"]
    gy, gx = np.meshgrid(r[1] + (np.arange(H) + 0.5) * ((r[4] - r[1]) / H),
                         r[0] + (np.arange(W) + 0.5) * ((r[3] - r[0]) / W), indexing="ij")
    out = np.zeros((H, W, len(cfg["anchor_rotations"]), 7))
    out[..., 0], out[..., 1], out[..., 2] = gx[..., None], gy[..., None], cfg["anchor_z"]
    out[..., 3:6] = cfg["anchor_size"]
    out[..., 6] = np.asarray(cfg["anchor_rotations"])
    return torch.tensor(out.reshape(-1, 7), dtype=torch.float32, device=device)


def decode(d, a):
    """Box deltas on anchors: x, y over the anchor's BEV diagonal, z over
    its height, sizes as log ratios, yaw added."""
    diag = torch.sqrt(a[:, 3] ** 2 + a[:, 4] ** 2)
    return torch.stack([d[:, 0] * diag + a[:, 0], d[:, 1] * diag + a[:, 1], d[:, 2] * a[:, 5] + a[:, 2],
                        torch.exp(d[:, 3]) * a[:, 3], torch.exp(d[:, 4]) * a[:, 4], torch.exp(d[:, 5]) * a[:, 5],
                        d[:, 6] + a[:, 6]], dim=-1)


def candidates(cls, boxes, dirs, nms_pre: int):
    """The NMS's candidates: sigmoid scores, the best nms_pre (the lower
    index first among equal scores), yaw turned by pi where the direction
    says -> (boxes (n, 7), scores (n,))."""
    s = torch.sigmoid(cls)
    top, idx = torch.sort(s, descending=True, stable=True)
    top, idx = top[:nms_pre], idx[:nms_pre]
    b, d = boxes[idx], dirs[idx]
    flip = (d[:, 1] > d[:, 0]).to(torch.float32)
    return torch.cat([b[:, :6], (b[:, 6] + flip * math.pi)[:, None]], 1), top


# ---------------------------------------------------------------------------
# rotated overlaps


def corners(b: np.ndarray) -> np.ndarray:
    """(n, 7) boxes -> (n, 4, 2) BEV corners, counter-clockwise."""
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    lx = np.array([0.5, -0.5, -0.5, 0.5])[None] * b[:, 4:5]
    wy = np.array([0.5, 0.5, -0.5, -0.5])[None] * b[:, 3:4]
    return np.stack([b[:, 0:1] + lx * c[:, None] - wy * s[:, None], b[:, 1:2] + lx * s[:, None] + wy * c[:, None]], -1)


def _area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = np.asarray(poly).T
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _clip(poly, a, b):
    """Sutherland-Hodgman: the part of `poly` left of the edge a -> b."""
    def side(p):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])

    out = []
    for i in range(len(poly)):
        p, q = poly[i], poly[(i + 1) % len(poly)]
        sp, sq = side(p), side(q)
        if sp >= 0:
            out.append(p)
        if (sp >= 0) != (sq >= 0):
            t = sp / (sp - sq)
            out.append((p[0] + t * (q[0] - p[0]), p[1] + t * (q[1] - p[1])))
    return out


def rotated_iou(boxes: np.ndarray) -> np.ndarray:
    """(n, n) BEV IoU of rotated boxes, by polygon clipping in float64."""
    b = np.asarray(boxes, np.float64)
    cs = corners(b)
    area = b[:, 3] * b[:, 4]
    n = len(b)
    out = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            if np.hypot(*(b[i, :2] - b[j, :2])) > 0.5 * (np.hypot(b[i, 3], b[i, 4]) + np.hypot(b[j, 3], b[j, 4])):
                continue
            poly = [tuple(p) for p in cs[i]]
            for k in range(4):
                poly = _clip(poly, cs[j][k], cs[j][(k + 1) % 4])
                if not poly:
                    break
            inter = _area(poly)
            u = area[i] + area[j] - inter
            out[i, j] = out[j, i] = inter / u if u > 0 else 0.0
    np.fill_diagonal(out, np.where(area > 0, 1.0, 0.0))
    return out


def nms_misses(iou: np.ndarray, scores: np.ndarray, picks: list[int], thresh: float, k: int,
               score_thresh: float, band: float) -> int:
    """Picks of a greedy NMS (`picks`, indices in the order made) that the
    definition does not allow, with the overlaps known to within `band`:
    each pick must be the best candidate (the lower index first among
    equal scores) that no earlier pick overlaps above thresh + band, above
    score_thresh; and while fewer than k are picked, no candidate above
    score_thresh may be left that every pick overlaps below thresh - band.
    Counts one miss for each pick that breaks either, and one for a
    missing pick."""
    n = len(scores)
    rank = np.empty(n, np.int64)
    rank[np.argsort(-scores, kind="stable")] = np.arange(n)
    worst = np.full(n, -np.inf)                      # each candidate's largest overlap with a pick so far
    picked = np.zeros(n, bool)
    misses = 0
    for p in picks:
        free = ~picked & (worst <= thresh - band) & (scores >= score_thresh)
        if worst[p] > thresh + band or scores[p] < score_thresh or (free & (rank < rank[p])).any():
            misses += 1
        picked[p] = True
        worst = np.maximum(worst, iou[p])
    free = ~picked & (worst <= thresh - band) & (scores >= score_thresh)
    if len(picks) < k and free.any():
        misses += 1
    return misses
