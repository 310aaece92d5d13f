"""The plain reference of DSP-SLAM's monocular detection and object seed.

Plain numpy and PyTorch, importing nothing of the port: the semantics of
the reference's reconstruct/mono_sequence.py (the largest instance mask,
eroded by a k x k box as `cv2.erode` does, background pixels on a strided
grid of the margin-expanded box outside the mask, their rays through K^-1)
and of MapObject.cc's PCA cuboid (mean-distance outliers, principal axes
mapped to x right / y up / z back, 5-95 percentile extents, the pose
[0.40 l R | centre]) with the mono path's scale floor and 180-degree flip
(LocalMapping_util.cc:396-407), written out again from those definitions.
The PCA runs in its points' own precision, float32 for the map's points,
the configuration's precision of geometry: against float64 a cloud whose
principal extents are nearly equal, as the cell's round parked object
gives, turns float32's rounding into a gap of the axes that says nothing
of the port. `operand` rounds the PCA's inputs (the precision control's
TF32; the reference itself leaves them as they are).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def erode(mask: np.ndarray, k: int) -> np.ndarray:
    """(H, W) bool eroded by a k x k box, the anchor at (k // 2, k // 2);
    pixels beyond the border count as set (cv2.erode's border value)."""
    if k <= 0:
        return mask.astype(bool)
    a = k // 2
    holes = torch.from_numpy((~mask.astype(bool)).astype(np.float32))[None, None]
    holes = F.pad(holes, (a, k - 1 - a, a, k - 1 - a))
    return (F.max_pool2d(holes, k, stride=1)[0, 0] == 0).numpy()


def background_pixels(bbox, mask: np.ndarray, stride: float, max_pixels: int, margin: int = 5) -> np.ndarray:
    """(M, 2) [u, v] pixels outside the mask on a grid of about `stride`
    pixels over the box grown by `margin`, at most `max_pixels` of them
    spread evenly over the grid's row-major order."""
    h, w = mask.shape
    l, t, r, b = (int(x) for x in np.asarray(bbox, np.float32)[:4])
    l, t, r, b = max(l - margin, 0), max(t - margin, 0), min(r + margin, w - 1), min(b + margin, h - 1)
    rows = np.linspace(t, b, max(int((b - t + 1) / stride), 1)).astype(np.int64)
    cols = np.linspace(l, r, max(int((r - l + 1) / stride), 1)).astype(np.int64)
    px = [(u, v) for v in rows for u in cols if not mask[v, u]]
    px = np.asarray(px, np.int64).reshape(-1, 2)
    if len(px) > max_pixels:
        px = px[np.linspace(0, len(px) - 1, max_pixels).astype(np.int64)]
    return px


def rays(px: np.ndarray, invK: np.ndarray) -> np.ndarray:
    hom = np.concatenate([px, np.ones((len(px), 1))], axis=-1)
    return (hom @ np.asarray(invK).T).astype(np.float32)


def mono_detection(masks: np.ndarray, boxes: np.ndarray, invK: np.ndarray, min_mask_area: float,
                   stride: float, max_rays: int, erosion: int) -> dict | None:
    """The frame's one detection: dict(pick, mask, bbox, rays), or None
    when there is no mask or the largest is below `min_mask_area`."""
    if masks is None or len(masks) == 0:
        return None
    areas = [int(m.sum()) for m in masks]
    pick = max(range(len(areas)), key=lambda i: (areas[i], -i))       # the first of the largest
    if areas[pick] < min_mask_area:
        return None
    mask = erode(masks[pick], erosion)
    bbox = np.asarray(boxes[pick][:4])
    px = background_pixels(bbox, mask, stride, max_rays)
    return {"pick": pick, "mask": mask, "bbox": bbox, "rays": rays(px, invK) if len(px) else None}


def _inliers_simple(pts: np.ndarray, thresh: float = 1.0) -> np.ndarray:
    d = np.linalg.norm(pts - pts.mean(0), axis=-1)
    return d <= d.mean() + thresh


def cuboid_pca(points_w: np.ndarray, operand=None) -> dict | None:
    """dict(T_wo_sim3 (4, 4) float32, inliers (N,) bool), or None below
    three inliers."""
    pts_all = np.asarray(points_w)
    pts_all = pts_all.astype(np.result_type(pts_all.dtype, np.float32), copy=False)
    if operand is not None:
        pts_all = operand(torch.from_numpy(pts_all).float()).numpy()
    keep = _inliers_simple(pts_all) if len(pts_all) else np.zeros(0, bool)
    pts = pts_all[keep]
    if len(pts) < 3:
        return None
    mean = pts.mean(0)
    val, vec = np.linalg.eigh((pts - mean).T @ (pts - mean))
    R = np.stack([vec[:, 1], vec[:, 0], -vec[:, 2]], axis=1)
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    if R[1, 1] > 0:                     # y points up: the camera's -y
        R[:, :2] *= -1
    x = pts @ R
    lo_i, hi_i = int(0.05 * len(pts)), min(int(0.95 * len(pts)), len(pts) - 1)
    srt = np.sort(x, axis=0)
    lo, hi = srt[lo_i], srt[hi_i]
    whl = hi - lo
    center = R @ ((hi + lo) / 2.0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = 0.40 * whl[2] * R
    T[:3, 3] = center
    inliers = np.zeros(len(pts_all), bool)
    inliers[np.nonzero(keep)[0]] = np.all(np.abs((pts - center) @ R) <= 1.2 * whl / 2.0, axis=-1)
    return {"T_wo_sim3": T, "inliers": inliers}


def floor_scale(T_wo: np.ndarray, points_w: np.ndarray, max_radius: float = 1.25) -> np.ndarray:
    """The seed's scale raised until 95% of the points lie within
    `max_radius` of its origin in object units."""
    if len(points_w) == 0:
        return T_wo
    s = float(np.linalg.det(T_wo[:3, :3])) ** (1.0 / 3.0)
    r = np.linalg.norm(np.asarray(points_w) - T_wo[:3, 3], axis=-1)
    need = (float(np.quantile(r, 0.95)) if len(r) >= 5 else float(r.max())) / max_radius
    if s >= need or need <= 0:
        return T_wo
    out = np.array(T_wo, copy=True)
    out[:3, :3] = T_wo[:3, :3] * (need / s)
    return out


def flip(T_wo: np.ndarray) -> np.ndarray:
    """The seed turned 180 degrees about its own y axis."""
    out = np.array(T_wo, copy=True)
    out[:3, 0] *= -1
    out[:3, 2] *= -1
    return out


def pick(losses, finite) -> int | None:
    """The candidate a first reconstruction keeps: the lowest loss among
    the finite results, the first on a tie; None if none is finite."""
    best = None
    for i, (loss, ok) in enumerate(zip(losses, finite)):
        if ok and (best is None or loss < losses[best]):
            best = i
    return best
