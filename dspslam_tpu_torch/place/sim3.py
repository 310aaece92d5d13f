"""Closed-form Sim(3) estimation between 3D point sets (Horn) + RANSAC, and
the mutual-reprojection Sim(3) refinement.

Port of dspslam_tpu/place/sim3.py (the reference's Sim3Solver.cc and
OptimizeSim3, Optimizer.cc:1045-1180). `horn_sim3`, `sim3_to_mat` and
`ransac_sim3` are host numpy copies with the same seeded RNG, so the same
seed draws the same minimal sets. `refine_sim3_reproj` is a fixed-length
Gauss-Newton on the device with closed-form Jacobians of the two mutual
reprojections (the JAX package takes them from `jax.jacfwd`); it runs
without a host sync until its result is read.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie


def horn_sim3(p1: np.ndarray, p2: np.ndarray, fix_scale: bool = False):
    """Closed-form similarity p1 ~ S * p2: returns (s, R, t) with
    p1 = s R p2 + t (Horn 1987 absolute orientation, quaternion form)."""
    c1 = p1.mean(axis=0)
    c2 = p2.mean(axis=0)
    q1 = p1 - c1
    q2 = p2 - c2
    M = q2.T @ q1                             # (3, 3)
    N = np.array(
        [
            [M[0, 0] + M[1, 1] + M[2, 2], M[1, 2] - M[2, 1], M[2, 0] - M[0, 2], M[0, 1] - M[1, 0]],
            [M[1, 2] - M[2, 1], M[0, 0] - M[1, 1] - M[2, 2], M[0, 1] + M[1, 0], M[2, 0] + M[0, 2]],
            [M[2, 0] - M[0, 2], M[0, 1] + M[1, 0], -M[0, 0] + M[1, 1] - M[2, 2], M[1, 2] + M[2, 1]],
            [M[0, 1] - M[1, 0], M[2, 0] + M[0, 2], M[1, 2] + M[2, 1], -M[0, 0] - M[1, 1] + M[2, 2]],
        ]
    )
    _, v = np.linalg.eigh(N)
    w0, x, y, z = v[:, -1]                    # unit quaternion w, x, y, z
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w0 * z), 2 * (x * z + w0 * y)],
            [2 * (x * y + w0 * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w0 * x)],
            [2 * (x * z - w0 * y), 2 * (y * z + w0 * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    if fix_scale:
        s = 1.0
    else:
        num = np.sum(q1 * (q2 @ R.T))
        den = np.sum(q2 * q2)
        s = float(num / max(den, 1e-12))
    t = c1 - s * (R @ c2)
    return s, R, t


def sim3_to_mat(s, R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


def ransac_sim3(
    p1: np.ndarray,
    p2: np.ndarray,
    fix_scale: bool = False,
    iterations: int = 200,
    inlier_thresh: float = 0.3,
    min_inliers: int = 12,
    seed: int = 0,
):
    """RANSAC over 3-point minimal sets; refined on the inlier set.

    Returns (T_12 (4, 4) Sim(3) or None, inlier_mask).
    """
    n = len(p1)
    if n < max(3, min_inliers):
        return None, np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    best_inliers = None
    best_count = 0
    for _ in range(iterations):
        idx = rng.choice(n, 3, replace=False)
        try:
            s, R, t = horn_sim3(p1[idx], p2[idx], fix_scale)
        except np.linalg.LinAlgError:
            continue
        if not np.isfinite(s) or s <= 1e-3 or s > 1e3:
            continue
        pred = (p2 @ (s * R).T) + t
        err = np.linalg.norm(pred - p1, axis=-1)
        inliers = err < inlier_thresh
        if inliers.sum() > best_count:
            best_count = int(inliers.sum())
            best_inliers = inliers
    if best_inliers is None or best_count < min_inliers:
        return None, np.zeros(n, bool)
    s, R, t = horn_sim3(p1[best_inliers], p2[best_inliers], fix_scale)
    pred = (p2 @ (s * R).T) + t
    inliers = np.linalg.norm(pred - p1, axis=-1) < inlier_thresh
    s, R, t = horn_sim3(p1[inliers], p2[inliers], fix_scale)
    return sim3_to_mat(s, R, t), inliers


# ---------------------------------------------------------------------------
# Sim(3) reprojection refinement (OptimizeSim3): after the Horn RANSAC
# hypothesis, Gauss-Newton over MUTUAL reprojection residuals (keyframe 2's
# point projected into keyframe 1 through S12, keyframe 1's point into
# keyframe 2 through S12^-1) with Huber weights and a both-directions chi2
# inlier count. A perceptually aliased candidate whose local structure
# matches but whose viewing geometry does not loses its inliers here.

SIM3_REFINE_CAP = 256      # match slots per refinement program
SIM3_CHI2_TH = 10.0        # reference th2 (Optimizer.cc:1122) in px^2
# The inlier gate adapts to the consensus residual scale:
# th = clip(5.991 * sigma^2_robust, TH, MAX). Tight maps keep the
# reference gate, sloppy-but-consistent maps scale it, and garbage
# hypotheses (residuals of 1e4+ px^2) stay rejected by the hard cap.
SIM3_CHI2_MAX = 900.0      # 30 px: beyond this nothing is a match


def _project(p, intr):
    """Pinhole projection (C, 3) -> (C, 2) and its Jacobian (C, 2, 3); the
    depth clamp at 1e-6 passes no derivative, as `jnp.maximum` does not."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z_raw = p[:, 2]
    live = z_raw > 1e-6
    z = torch.clamp(z_raw, min=1e-6)
    inv_z = 1.0 / z
    u = fx * p[:, 0] * inv_z + cx
    v = fy * p[:, 1] * inv_z + cy
    zero = torch.zeros_like(z)
    du_dz = torch.where(live, -fx * p[:, 0] * inv_z * inv_z, zero)
    dv_dz = torch.where(live, -fy * p[:, 1] * inv_z * inv_z, zero)
    J = torch.stack([torch.stack([fx * inv_z, zero, du_dz], -1),
                     torch.stack([zero, fy * inv_z, dv_dz], -1)], -2)
    return torch.stack([u, v], -1), J


def _mutual_residuals(S, x1, x2, uv1, uv2, intr):
    """Residuals r1 (C, 2), r2 (C, 2) and their Jacobians (C, 2, 7) with
    respect to a left perturbation exp(d) S: d(exp(d) y) = [I | -[y]x | y] d,
    and (exp(d) S)^-1 x = S^-1 exp(-d) x moves by -(sR)^-1 [I | -[x]x | x] d."""
    y2 = lie.transform_points(S, x2)
    p1, Jp1 = _project(y2, intr)
    r1 = p1 - uv1
    J1 = Jp1 @ lie.points_to_pose_jacobian_sim3(y2)
    S_inv = lie.inverse_sim3(S)
    y1 = lie.transform_points(S_inv, x1)
    p2, Jp2 = _project(y1, intr)
    r2 = p2 - uv2
    J2 = -(Jp2 @ S_inv[:3, :3]) @ lie.points_to_pose_jacobian_sim3(x1)
    return r1, r2, J1, J2


def refine_sim3(S12, x1, x2, uv1, uv2, valid, intrinsics, fix_scale: bool = True, iters: int = 10):
    """Device GN. S12: (4, 4) Sim(3) cam1 <- cam2. x1 / x2: (C, 3) matched
    points in each camera frame; uv1 / uv2: (C, 2) observed pixels; valid:
    (C,). Returns (S12_refined, inlier mask (C,), n_inliers, chi2_th) as
    tensors, with no host sync."""
    dev, dt = S12.device, S12.dtype
    eye7 = torch.eye(7, dtype=dt, device=dev)
    # fixed scale: identity row and column for the scale dimension
    keep = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        keep = torch.cat([keep[:6], torch.zeros(1, dtype=dt, device=dev)])
    clamp = keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)

    S = S12
    for _ in range(iters):
        r1, r2, J1, J2 = _mutual_residuals(S, x1, x2, uv1, uv2, intrinsics)
        c1, c2 = torch.sum(r1 * r1, -1), torch.sum(r2 * r2, -1)
        # Huber IRLS weight per edge (delta^2 = chi2 threshold)
        w1 = valid * torch.clamp(SIM3_CHI2_TH / torch.clamp(c1, min=1e-9), max=1.0)
        w2 = valid * torch.clamp(SIM3_CHI2_TH / torch.clamp(c2, min=1e-9), max=1.0)
        H = (torch.einsum("cid,c,cie->de", J1, w1, J1)
             + torch.einsum("cid,c,cie->de", J2, w2, J2))
        g = (torch.einsum("cid,c,ci->d", J1, w1, r1)
             + torch.einsum("cid,c,ci->d", J2, w2, r2))
        H = H * clamp + 1e-6 * eye7
        g = g * keep
        dx = -torch.linalg.solve_ex(H, g)[0]
        S = lie.exp_sim3(dx) @ S
    r1, r2, _, _ = _mutual_residuals(S, x1, x2, uv1, uv2, intrinsics)
    c1, c2 = torch.sum(r1 * r1, -1), torch.sum(r2 * r2, -1)
    k = torch.clamp(torch.sum(valid).to(torch.int64) // 2, min=0)

    def masked_median(c):
        s = torch.sort(torch.where(valid > 0.5, c, torch.inf)).values
        return torch.clamp(s.gather(0, k[None])[0], max=1e9)

    # robust sigma^2 from the median of a chi2(2 dof) sample
    # (median = 1.386 sigma^2); gate at the 95% quantile 5.991
    sigma2 = 0.5 * (masked_median(c1) + masked_median(c2)) / 1.386
    th = torch.clamp(5.991 * sigma2, SIM3_CHI2_TH, SIM3_CHI2_MAX)
    inlier = (valid > 0.5) & (c1 < th) & (c2 < th)
    return S, inlier, torch.sum(inlier), th


def refine_sim3_reproj(S12, x1, x2, uv1, uv2, fix_scale=True, iters=10,
                       intrinsics=(718.856, 718.856, 607.1928, 185.2157), device="cpu"):
    """Host wrapper: pads the match set to SIM3_REFINE_CAP, runs the device
    GN on `device`, returns (S12 (4, 4) np, inliers (N,) bool, n_inliers
    int, chi2_th float: the adaptive gate actually applied, which callers
    reuse to size consistency-tolerant search radii)."""
    n = len(x1)
    C = SIM3_REFINE_CAP
    if n > C:
        x1, x2, uv1, uv2 = x1[:C], x2[:C], uv1[:C], uv2[:C]
        n = C

    def pad(a):
        a = np.asarray(a, np.float32)
        out = np.zeros((C,) + a.shape[1:], np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    valid = np.zeros(C, np.float32)
    valid[:n] = 1.0
    S_ref, inlier, n_in, th = refine_sim3(
        torch.from_numpy(np.asarray(S12, np.float32)).to(device), pad(x1), pad(x2), pad(uv1),
        pad(uv2), torch.from_numpy(valid).to(device),
        torch.from_numpy(np.asarray(intrinsics, np.float32)[:4].copy()).to(device),
        fix_scale=bool(fix_scale), iters=int(iters),
    )
    return (
        S_ref.cpu().numpy().astype(np.float32),
        inlier.cpu().numpy()[: len(x1)],
        int(n_in),
        float(th),
    )
