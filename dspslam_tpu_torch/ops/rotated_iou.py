"""Exact rotated-rectangle IoU in the BEV plane, fixed-shape PyTorch.

Port of dspslam_tpu/ops/rotated_iou.py: the intersection of two convex
quads by Sutherland-Hodgman clipping, with fixed-size vertex buffers and
validity counts. JAX maps one pair at a time with a nested vmap
(rotated_iou.py:98-100); here every (N, M) pair is one row of a batch, so
the whole matrix is a few dozen batched ops with no host sync.

A 4-gon clipped by a 4-gon has at most 8 vertices; buffers are padded to
16 for slack. Degenerate (zero-area) inputs yield IoU 0.
"""

from __future__ import annotations

import torch

_V = 16          # vertex buffer size (>= 8 needed)


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """Boxes (..., 7) [x, y, z, w, l, h, yaw] -> BEV corners (..., 4, 2),
    counter-clockwise (l along the heading, w across it: mmdet3d's LiDAR
    box convention)."""
    x, y = boxes[..., 0], boxes[..., 1]
    w, l, yaw = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    dx = torch.stack([l, -l, -l, l], dim=-1) * 0.5
    dy = torch.stack([w, w, -w, -w], dim=-1) * 0.5
    cx = x[..., None] + dx * c[..., None] - dy * s[..., None]
    cy = y[..., None] + dx * s[..., None] + dy * c[..., None]
    return torch.stack([cx, cy], dim=-1)


def _next_index(n: torch.Tensor) -> torch.Tensor:
    """(B, V) index of each vertex's successor in a ring of n (0 if n is 0)."""
    idx = torch.arange(_V, device=n.device)
    nxt = torch.remainder(idx[None, :] + 1, torch.clamp(n, min=1)[:, None])
    return torch.where(n[:, None] > 0, nxt, 0)


def _polygon_area(poly: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the first n[b] vertices of poly[b] (B, V, 2)."""
    nxt = torch.gather(poly, 1, _next_index(n)[..., None].expand(-1, -1, 2))
    valid = (torch.arange(_V, device=n.device)[None, :] < n[:, None]).to(poly.dtype)
    cross = poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]
    return 0.5 * torch.abs(torch.sum(cross * valid, dim=1))


def _clip_halfplane(poly, n, a, b):
    """Clip each polygon (first n[b] of (B, V, 2)) against the half-plane to
    the LEFT of its directed edge a[b] -> b[b] (B, 2). Returns (poly', n')."""
    B = poly.shape[0]
    idx = torch.arange(_V, device=poly.device)
    cur = poly
    nxt = torch.gather(poly, 1, _next_index(n)[..., None].expand(-1, -1, 2))
    e = b - a
    side_cur = e[:, None, 0] * (cur[..., 1] - a[:, None, 1]) - e[:, None, 1] * (cur[..., 0] - a[:, None, 0])
    side_nxt = e[:, None, 0] * (nxt[..., 1] - a[:, None, 1]) - e[:, None, 1] * (nxt[..., 0] - a[:, None, 0])
    in_cur = side_cur >= 0
    in_nxt = side_nxt >= 0
    denom = side_cur - side_nxt
    t = side_cur / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    inter = cur + t[..., None] * (nxt - cur)

    live = idx[None, :] < n[:, None]
    emit_cur = in_cur & live
    emit_int = (in_cur != in_nxt) & live
    # interleave: slot 2i = cur_i, slot 2i+1 = intersection_i
    pts = torch.stack([cur, inter], dim=2).reshape(B, 2 * _V, 2)
    val = torch.stack([emit_cur, emit_int], dim=2).reshape(B, 2 * _V)
    # stable compaction of the valid points to the front: each valid point
    # goes to its own slot, every invalid one to a spare slot past the end
    # (JAX lets them collide on slot V-1, which the count masks)
    pos = torch.cumsum(val.to(torch.int32), dim=1) - 1
    write = torch.where(val, torch.clamp(pos, max=_V - 1), _V).to(torch.int64)
    out = torch.zeros(B, _V + 1, 2, dtype=poly.dtype, device=poly.device)
    out.scatter_(1, write[..., None].expand(-1, -1, 2), torch.where(val[..., None], pts, 0.0))
    n_new = torch.clamp(torch.sum(val.to(torch.int32), dim=1), max=_V)
    return out[:, :_V], n_new


def _pair_intersection_area(corners_a: torch.Tensor, corners_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of B pairs of convex quads, (B, 4, 2) each."""
    B = corners_a.shape[0]
    poly = torch.zeros(B, _V, 2, dtype=corners_a.dtype, device=corners_a.device)
    poly[:, :4] = corners_a
    n = torch.full((B,), 4, dtype=torch.int32, device=corners_a.device)
    for i in range(4):
        poly, n = _clip_halfplane(poly, n, corners_b[:, i], corners_b[:, (i + 1) % 4])
    return _polygon_area(poly, n)


def rotated_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) exact BEV rotated IoU."""
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    ca = box_corners_bev(boxes_a)                       # (N, 4, 2), CCW
    cb = box_corners_bev(boxes_b)                       # (M, 4, 2)
    inter = _pair_intersection_area(
        ca[:, None].expand(N, M, 4, 2).reshape(N * M, 4, 2),
        cb[None].expand(N, M, 4, 2).reshape(N * M, 4, 2),
    ).reshape(N, M)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 1e-9, inter / torch.clamp(union, min=1e-9), 0.0)
