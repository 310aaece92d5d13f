"""Robust (Huber) reweighting of residual vectors, mask-aware.

Port of dspslam_tpu/ops/robust.py. The Huber norm is
``rho(|r|) = |r|^2 if |r| <= b else 2 b |r| - b^2`` and the IRLS weight
``w = sqrt(rho(|r|)) / |r|``, applied as ``r_robust = w * r``; the loss is
the mean of ``r_robust^2`` over live (mask 1) entries. Objects ride in
leading dimensions, so the mean is taken over the LAST dimension only.
"""

from __future__ import annotations

import torch


def huber_weights(res_norm: torch.Tensor, b: float) -> torch.Tensor:
    """IRLS weight per residual: 1 in the quadratic zone, sqrt decay out."""
    res_norm = torch.abs(res_norm)
    rho = torch.where(res_norm <= b, res_norm**2, 2.0 * b * res_norm - b * b)
    zero = res_norm == 0.0
    safe = torch.where(zero, torch.ones_like(res_norm), res_norm)
    return torch.where(
        zero, torch.ones_like(res_norm), torch.sqrt(torch.clamp(rho, min=0.0)) / safe
    )


def robust_residuals(res: torch.Tensor, b: float, mask: torch.Tensor | None = None):
    """Huber-reweight residuals (..., N); returns (robust_res, loss (...,),
    weights). With a mask, the loss averages over live entries only."""
    w = huber_weights(res, b)
    if mask is not None:
        w = w * mask
    robust = w * res
    if mask is None:
        loss = torch.mean(robust**2, dim=-1)
    else:
        loss = torch.sum(robust**2, dim=-1) / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return robust, loss, w
