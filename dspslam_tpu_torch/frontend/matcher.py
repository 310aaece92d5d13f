"""Batched ORB descriptor matching.

Port of dspslam_tpu/frontend/matcher.py: one (N, M) Hamming-distance
matrix (the JAX package's XOR + population count, computed as a matrix
product of descriptor bits) over which the search modes are candidate
masks, best / second-best ratio and mutual checks, and the 30-bin
rotation-consistency histogram. Descriptors are (N, 8) int32, the bit view
of uint32 words. Thresholds TH_HIGH=100 / TH_LOW=50 and the 0.9 ratio
follow the reference (ORBmatcher.cc:35-40).

Every function is fixed-shape and free of host syncs: no `.item()`, no
boolean-mask indexing. `argmin` returns the first minimum, as JAX's does.
"""

from __future__ import annotations

import math

import torch

TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30
BIG = 1 << 20


def _bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 descriptor words -> (..., 256) f32 bits (bit i of word
    j at column 32 j + i)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    return ((desc[..., None] >> shifts) & 1).reshape(*desc.shape[:-1], 256).to(torch.float32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) packed int32 descriptors -> (N, M) int32 distances.

    popcount(a XOR b) = |a| + |b| - 2 a.b over the 256 bits: one f32 matrix
    product of 0/1 bit vectors, whose entries are integers <= 256 and so
    exact in any summation order (TF32 included). It equals the JAX
    package's XOR + population count, without the (N, M, 32) byte
    intermediate that takes 512 MB at 4000 x 4000."""
    a, b = _bits(desc_a), _bits(desc_b)
    d = (a @ b.t()).mul_(-2.0)              # in place: one (N, M) f32 buffer
    d += a.sum(1)[:, None]
    d += b.sum(1)[None, :]
    return d.to(torch.int32)


def masked_match(dist: torch.Tensor, cand_mask: torch.Tensor, max_dist: int = TH_LOW,
                 ratio: float | None = 0.9, mutual: bool = True):
    """Best-candidate matching over a masked (N, M) distance matrix.
    Returns (match_idx (N,) int32 into M, -1 for unmatched; match_dist (N,))."""
    d = torch.where(cand_mask, dist, BIG)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    ok = best <= max_dist
    rows = torch.arange(d.shape[0], device=d.device)
    if ratio is not None:
        second = torch.amin(d.scatter(1, best_idx[:, None], BIG), dim=1)
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    if mutual:
        rev_best = torch.argmin(d, dim=0)                 # (M,)
        ok = ok & (rev_best[best_idx] == rows)
    return torch.where(ok, best_idx, -1).to(torch.int32), best


def window_mask(xy_a, xy_b, radius: float, valid_a, valid_b,
                level_a=None, level_b=None, level_slack: int = 1) -> torch.Tensor:
    """(N, M) candidate mask: b within `radius` px of a, both valid, with an
    optional pyramid-level gate."""
    d2 = torch.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, dim=-1)
    mask = (d2 <= radius * radius) & (valid_a[:, None] > 0) & (valid_b[None, :] > 0)
    if level_a is not None and level_b is not None:
        mask = mask & (torch.abs(level_a[:, None] - level_b[None, :]) <= level_slack)
    return mask


def rotation_consistency(angles_a, angles_b, match_idx) -> torch.Tensor:
    """Keep matches whose orientation delta falls in the 3 dominant
    30-bin histogram bins (ORBmatcher.cc:1601-1645). Returns filtered idx."""
    matched = match_idx >= 0
    safe_idx = torch.clamp(match_idx, min=0).to(torch.int64)
    delta = torch.remainder(angles_a - angles_b[safe_idx], 2 * math.pi)
    bins = torch.clamp((delta / (2 * math.pi) * HISTO_BINS).to(torch.int64), 0, HISTO_BINS - 1)
    hist = torch.zeros((HISTO_BINS,), dtype=torch.int32, device=match_idx.device)
    hist = hist.scatter_add(0, bins, matched.to(torch.int32))
    third = torch.sort(hist, descending=True).values[2]
    keep_bin = hist >= torch.clamp(third, min=1)
    return torch.where(matched & keep_bin[bins], match_idx, -1)


def match_features(feats_a: dict, feats_b: dict, max_dist: int = TH_LOW, ratio: float = 0.9):
    """Full-frame brute-force matching with mutual-best + rotation check.
    Returns (idx (N,) int32 into feats_b, -1 for unmatched; dist (N,))."""
    dist = hamming_matrix(feats_a["desc"], feats_b["desc"])
    cand = (feats_a["valid"][:, None] > 0) & (feats_b["valid"][None, :] > 0)
    idx, d = masked_match(dist, cand, max_dist, ratio, mutual=True)
    return rotation_consistency(feats_a["angle"], feats_b["angle"], idx), d


def match_in_windows(feats_a: dict, feats_b: dict, radius: float, max_dist: int = TH_LOW,
                     ratio: float = 0.9):
    """Window-constrained matching (monocular initialization,
    ORBmatcher.cc:405-520): candidates within `radius` px and one pyramid
    level, mutual best, ratio and rotation checks. Returns (idx (N,) int32
    into feats_b, -1 for unmatched; dist (N,))."""
    dist = hamming_matrix(feats_a["desc"], feats_b["desc"])
    cand = window_mask(feats_a["xy"], feats_b["xy"], radius, feats_a["valid"], feats_b["valid"],
                       feats_a["level"], feats_b["level"])
    idx, d = masked_match(dist, cand, max_dist, ratio, mutual=True)
    return rotation_consistency(feats_a["angle"], feats_b["angle"], idx), d


def match_by_projection(proj_xy, proj_valid, proj_desc, proj_level, feats: dict,
                        radius: float, max_dist: int = TH_HIGH,
                        ratio: float | None = 0.9, level_slack: int | None = None):
    """Map-point -> frame projection search (ORBmatcher.cc:45-157): each
    projected point matches the closest descriptor among frame keypoints
    inside its radius; the octave gate is off unless `level_slack` is
    given. Returns (idx (N,) int32, dist (N,) int32)."""
    dist = hamming_matrix(proj_desc, feats["desc"])
    gated = level_slack is not None
    cand = window_mask(
        proj_xy, feats["xy"], radius, proj_valid, feats["valid"],
        proj_level if gated else None, feats["level"] if gated else None,
        level_slack=level_slack or 1,
    )
    return masked_match(dist, cand, max_dist, ratio, mutual=False)
