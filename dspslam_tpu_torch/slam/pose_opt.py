"""Motion-only pose optimization (frame-to-map reprojection GN).

Port of dspslam_tpu/slam/pose_opt.py (Optimizer::PoseOptimization,
Optimizer.cc:239-451): refine T_cw from matched 3D map points and keypoint
observations with 4 rounds of 10 Gauss-Newton iterations, re-classifying
outliers between rounds at chi2 5.991 (mono) / 7.815 (stereo), with Huber
weights of the same deltas. Mono and stereo observations share a
3-residual layout (the third masked off for mono).

The rounds and iterations are Python loops of a fixed count, and the 6x6
systems are solved without an error check (`torch.linalg.solve_ex` on the
CPU, an elementwise Cholesky on a device), so the whole solve is queued on
the device without a host sync. On a CUDA device the 4 x 10 loop replays
as one CUDA graph per shape (`ops/graphs.py`): eagerly it is ~4,000 small
launches, whose enqueue, not the device, set the pace.
Matrix products run in full f32 (callers keep TF32 off).
"""

from __future__ import annotations

import torch

from ..ops import graphs, lie
from ..ops.linalg import cholesky_solve_spd
from ..utils import timing

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def project_stereo(T_cw, pts_w, fx, fy, cx, cy, bf) -> torch.Tensor:
    """World points -> (u, v, u_right) pixel triplets. (N, 3)."""
    pc = lie.transform_points(T_cw, pts_w)
    zs = torch.clamp(pc[:, 2], min=1e-6)
    u = fx * pc[:, 0] / zs + cx
    v = fy * pc[:, 1] / zs + cy
    return torch.stack([u, v, u - bf / zs], dim=-1)


def _residuals_and_jac(T_cw, pts_w, obs, stereo_mask, fx, fy, cx, cy, bf):
    """Per-observation residual (N, 3) and Jacobian wrt se(3) (N, 3, 6),
    left perturbation T <- exp(dx) T, dx = [v, w]."""
    pc = lie.transform_points(T_cw, pts_w)                # (N, 3)
    x, y = pc[:, 0], pc[:, 1]
    inv_z = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
    inv_z2 = inv_z * inv_z

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    res = torch.stack(
        [u - obs[:, 0], v - obs[:, 1], (ur - obs[:, 2]) * stereo_mask], dim=-1
    )

    zero = torch.zeros_like(x)
    du = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * inv_z2], dim=-1)
    dpix_dpc = torch.stack([du, dv, dur * stereo_mask[:, None]], dim=-2)   # (N, 3, 3)
    J = dpix_dpc @ lie.points_to_pose_jacobian_se3(pc)    # (N, 3, 6)
    return res, J


def _solve(H, b):
    """dx = H^-1 b for the damped 6 x 6 normal equations: `solve_ex` on the
    CPU, `cholesky_solve_spd` on a device (H is J^T W J + damping I)."""
    if H.is_cpu:
        return torch.linalg.solve_ex(H, b).result
    return cholesky_solve_spd(H, b)


def _gauss_newton(T_cw_init, pts_w, obs, inv_sigma2, valid, stereo_mask, intrinsics,
                  damping, rounds_iters, chi2_anneal):
    """The GN of `optimize_pose`; no host sync, so a CUDA graph can hold it."""
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
            res, J = _residuals_and_jac(T, pts_w, obs, stereo_mask, fx, fy, cx, cy, bf)
            chi2 = torch.sum(res * res, dim=-1) * inv_sigma2
            hub = torch.where(
                chi2 <= chi2_th, 1.0, torch.sqrt(chi2_th / torch.clamp(chi2, min=1e-12))
            )
            w = inlier * valid * inv_sigma2 * hub
            Jw = (J * w[:, None, None]).reshape(-1, 6)
            H = Jw.t() @ J.reshape(-1, 6) + damp
            b = -(Jw.t() @ res.reshape(-1))
            T = lie.exp_se3(_solve(H, b)) @ T
        res, _ = _residuals_and_jac(T, pts_w, obs, stereo_mask, fx, fy, cx, cy, bf)
        chi2 = torch.sum(res * res, dim=-1) * inv_sigma2
        inlier = (chi2 <= chi2_th).to(torch.float32) * valid
    return T, inlier, torch.sum(inlier)


CUDA_GRAPHS = graphs.Entry("pose", lambda *settings: (lambda inputs, _: _gauss_newton(*inputs, *settings),))


def optimize_pose(T_cw_init, pts_w, obs, inv_sigma2, valid, stereo_mask, intrinsics,
                  damping: float = 1e-3, rounds_iters: tuple = (4, 10),
                  chi2_anneal: tuple = (1.0, 1.0, 1.0, 1.0)):
    """Returns (T_cw, inlier_mask (N,), n_inliers). T_cw_init (4, 4),
    pts_w (N, 3), obs (N, 3) [u, v, u_right], inv_sigma2 / valid /
    stereo_mask (N,), intrinsics (5,) [fx, fy, cx, cy, bf]. chi2_anneal
    scales the chi2 threshold per round (the default keeps it constant)."""
    with timing.span("pose_opt"):
        inputs = (T_cw_init, pts_w, obs, inv_sigma2, valid, stereo_mask, intrinsics)
        settings = (float(damping), tuple(rounds_iters), tuple(float(a) for a in chi2_anneal))
        if graphs.eager(pts_w):
            return _gauss_newton(*inputs, *settings)
        cuda = CUDA_GRAPHS(inputs, *settings)
        cuda.graphs[0].replay()
        return cuda.outputs()
