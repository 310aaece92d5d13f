"""Stereo keypoint matching along epipolar rows.

Port of dspslam_tpu/frontend/stereo.py (Frame::ComputeStereoMatches,
Frame.cc:467-643): candidates gated by row band and disparity range,
scored by descriptor Hamming distance, refined to sub-pixel with an 11x11
SAD parabola fit under three row slants, culled by a median-SAD gate, all
as one fixed-shape program with no host sync. Depth = bf / disparity;
RGB-D input instead synthesizes the virtual right coordinate
uR = u - bf / depth (Frame.cc:644-668).
"""

from __future__ import annotations

import numpy as np
import torch

from .matcher import BIG, TH_HIGH, TH_LOW, hamming_matrix

_SAD_HALF = 5          # 11x11 window
_SHIFTS = 5            # +/- shift range for subpixel refinement
_SLANTS = (-0.4, 0.0, 0.4)   # row-slant hypotheses (px/row) for the SAD
_SLANT_PAD = 2         # max |round(slant * dy)| over the window


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor, averaging the two
    middle values for an even count (`jnp.nanmedian`); NaN when all are
    NaN. Fixed shapes: sort with NaN last, gather by the valid count."""
    valid = ~torch.isnan(x)
    n = valid.sum()
    s = torch.sort(torch.where(valid, x, torch.inf)).values
    mid = torch.stack([torch.clamp((n - 1) // 2, min=0), torch.clamp(n // 2, max=x.shape[0] - 1)])
    lo, hi = torch.gather(s, 0, mid)
    return torch.where(n > 0, (lo + hi) * 0.5, torch.nan)


def stereo_match(feats_l: dict, feats_r: dict, img_l: torch.Tensor, img_r: torch.Tensor,
                 bf, max_disparity, row_slack: float = 2.0) -> dict:
    """Per-left-keypoint disparity / depth. Returns dict(u_right (N,),
    depth (N,), valid (N,)) with -1 sentinels. The row band scales with
    the right keypoint's pyramid level (Frame.cc:481-500)."""
    img_l = img_l.to(torch.float32)
    img_r = img_r.to(torch.float32)
    xl, yl = feats_l["xy"][:, 0], feats_l["xy"][:, 1]
    xr, yr = feats_r["xy"][:, 0], feats_r["xy"][:, 1]

    dist = hamming_matrix(feats_l["desc"], feats_r["desc"])   # (N, M)
    band = row_slack * torch.sqrt(feats_r["sigma2"])[None, :]
    disp = xl[:, None] - xr[None, :]
    cand = (
        (torch.abs(yl[:, None] - yr[None, :]) <= band)
        & (disp >= -1.0)
        & (disp <= max_disparity)
        & (feats_l["valid"][:, None] > 0)
        & (feats_r["valid"][None, :] > 0)
        & (torch.abs(feats_l["level"][:, None] - feats_r["level"][None, :]) <= 1)
    )
    d = torch.where(cand, dist, BIG)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    # absolute descriptor gate thOrbDist = (TH_HIGH + TH_LOW) / 2
    # (Frame.cc:520), no ratio test
    ok = best <= (TH_HIGH + TH_LOW) // 2

    # subpixel SAD refinement around the matched column (Frame.cc:540-610)
    # on the level-0 image, with taps dilated by the keypoint's octave scale
    H, W = img_l.shape
    size = 2 * _SAD_HALF + 1                                  # 11
    pad = _SHIFTS + _SLANT_PAD
    dev = img_l.device
    s_oct = torch.sqrt(feats_l["sigma2"]).to(torch.float32)   # (N,)
    reach = torch.ceil((_SAD_HALF + pad) * s_oct).to(torch.int64)
    yl_i = torch.clamp(yl.to(torch.int64), reach, H - reach - 1)
    xl_i = torch.clamp(xl.to(torch.int64), reach, W - reach - 1)
    xr_best = xr[best_idx]
    xr_i = torch.clamp(xr_best.to(torch.int64), reach, W - reach - 1)
    dy = torch.arange(-_SAD_HALF, _SAD_HALF + 1, device=dev)
    dxw = torch.arange(-_SAD_HALF - pad, _SAD_HALF + pad + 1, device=dev)
    dy_d = torch.round(dy[None, :] * s_oct[:, None]).to(torch.int64)    # (N, 11)
    dxw_d = torch.round(dxw[None, :] * s_oct[:, None]).to(torch.int64)
    rows = yl_i[:, None, None] + dy_d[:, :, None]             # (N, 11, 1)
    patch_l = img_l[rows, xl_i[:, None, None] + dy_d[:, None, :]]      # (N, 11, 11)
    patch_r = img_r[rows, xr_i[:, None, None] + dxw_d[:, None, :]]     # (N, 11, 11+2*pad)
    n_j = 2 * pad + 1
    rowsad = torch.stack(
        [torch.sum(torch.abs(patch_l - patch_r[:, :, j: j + size]), dim=2) for j in range(n_j)],
        dim=-1,
    )                                                          # (N, 11, n_j)
    dy_np = np.arange(-_SAD_HALF, _SAD_HALF + 1)
    sads = None
    for slope in _SLANTS:
        offs = np.clip(np.round(slope * dy_np).astype(np.int64), -_SLANT_PAD, _SLANT_PAD)
        s = torch.stack(
            [
                sum(rowsad[:, r, k + _SLANT_PAD + int(offs[r])] for r in range(size))
                for k in range(2 * _SHIFTS + 1)
            ],
            dim=-1,
        )
        sads = s if sads is None else torch.minimum(sads, s)  # (N, 11)
    k = torch.argmin(sads, dim=-1)
    # a minimum at the search boundary is rejected (Frame.cc:592-594)
    ok = ok & (k > 0) & (k < 2 * _SHIFTS)
    k_in = torch.clamp(k, 1, 2 * _SHIFTS - 1)
    sm1, s0, sp1 = (torch.gather(sads, 1, (k_in + off)[:, None])[:, 0] for off in (-1, 0, 1))
    denom = sm1 + sp1 - 2.0 * s0
    delta = torch.where(torch.abs(denom) > 1e-6, (sm1 - sp1) / (2.0 * denom), 0.0)
    # |delta| > 1: the parabola disagrees with the argmin (Frame.cc:602-604)
    ok = ok & (torch.abs(delta) <= 1.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    # median-SAD outlier culling (Frame.cc:614-640)
    med = nanmedian(torch.where(ok, s0, torch.nan))
    ok = ok & (s0 <= 1.5 * 1.4 * torch.where(torch.isnan(med), torch.inf, med))
    # shift and subpixel delta are in octave pixels (Frame.cc:606-610)
    u_right = xr_best + ((k_in - _SHIFTS).to(torch.float32) + delta) * s_oct
    disparity = xl - u_right
    ok = ok & (disparity > 0.01) & (disparity <= max_disparity)
    depth = torch.where(ok, bf / torch.clamp(disparity, min=0.01), -1.0)
    u_right = torch.where(ok, u_right, -1.0)
    return {"u_right": u_right, "depth": depth, "valid": ok.to(torch.float32)}


def depth_to_virtual_right(u: torch.Tensor, depth: torch.Tensor, bf: float):
    """RGB-D: virtual right coordinate from measured depth (Frame.cc:644-668)."""
    valid = depth > 0
    u_right = torch.where(valid, u - bf / torch.clamp(depth, min=1e-6), -1.0)
    return u_right, valid.to(torch.float32)
