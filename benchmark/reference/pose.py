"""The plain reference of the tracker's motion-only pose optimisation.

A frozen copy of dspslam_tpu_torch/slam/pose_opt.py at commit d92c068
(plain PyTorch, no kernel of the port), itself a port of
dspslam_tpu/slam/pose_opt.py (the reference's Optimizer::PoseOptimization,
Optimizer.cc:239-451): T_cw refined from matched 3D map points and keypoint
observations by 4 rounds of 10 Gauss-Newton iterations, outliers
re-classified between rounds at chi2 5.991 (mono) / 7.815 (stereo), with
Huber weights of the same deltas. Mono and stereo observations share a
3-residual layout (the third masked off for mono).

`operand` rounds the operands of every product (the control's TF32; the
reference keeps them).
"""

from __future__ import annotations

import torch

from . import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _same(t):
    return t


def _residuals_and_jac(T_cw, pts_w, obs, stereo_mask, fx, fy, cx, cy, bf, operand=_same):
    """Per-observation residual (N, 3) and Jacobian wrt se(3) (N, 3, 6),
    left perturbation T <- exp(dx) T, dx = [v, w]."""
    pc = operand(pts_w) @ operand(T_cw[:3, :3]).t() + T_cw[:3, 3]
    x, y = pc[:, 0], pc[:, 1]
    inv_z = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
    inv_z2 = inv_z * inv_z
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    res = torch.stack([u - obs[:, 0], v - obs[:, 1], (ur - obs[:, 2]) * stereo_mask], dim=-1)
    zero = torch.zeros_like(x)
    du = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * inv_z2], dim=-1)
    dpix_dpc = torch.stack([du, dv, dur * stereo_mask[:, None]], dim=-2)
    J = operand(dpix_dpc) @ operand(lie.points_to_pose_jacobian_se3(pc))
    return res, J


def optimize_pose(T_cw_init, pts_w, obs, inv_sigma2, valid, stereo_mask, intrinsics,
                  damping: float = 1e-3, rounds_iters: tuple = (4, 10),
                  chi2_anneal: tuple = (1.0, 1.0, 1.0, 1.0), operand=_same):
    """Returns (T_cw, inlier_mask (N,), n_inliers), as the port's
    `optimize_pose` takes and returns them."""
    fx, fy, cx, cy, bf = (intrinsics[i] for i in range(5))
    rounds, iters = rounds_iters
    anneal = tuple(chi2_anneal) + (1.0,) * max(0, rounds - len(chi2_anneal))
    chi2_base = torch.where(stereo_mask > 0, CHI2_STEREO, CHI2_MONO)
    damp = damping * torch.eye(6, dtype=pts_w.dtype, device=pts_w.device)
    T = T_cw_init
    inlier = valid
    for r in range(rounds):
        chi2_th = chi2_base * anneal[r]
        for _ in range(iters):
            res, J = _residuals_and_jac(T, pts_w, obs, stereo_mask, fx, fy, cx, cy, bf, operand)
            chi2 = torch.sum(res * res, dim=-1) * inv_sigma2
            hub = torch.where(chi2 <= chi2_th, 1.0, torch.sqrt(chi2_th / torch.clamp(chi2, min=1e-12)))
            w = inlier * valid * inv_sigma2 * hub
            Jw = (J * w[:, None, None]).reshape(-1, 6)
            H = operand(Jw).t() @ operand(J.reshape(-1, 6)) + damp
            b = -(operand(Jw).t() @ operand(res.reshape(-1)))
            dx = torch.linalg.solve_ex(H, b).result
            T = lie.exp_se3(dx) @ T
        res, _ = _residuals_and_jac(T, pts_w, obs, stereo_mask, fx, fy, cx, cy, bf, operand)
        chi2 = torch.sum(res * res, dim=-1) * inv_sigma2
        inlier = (chi2 <= chi2_th).to(torch.float32) * valid
    return T, inlier, torch.sum(inlier)
