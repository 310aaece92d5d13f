"""RANSAC PnP for relocalization, the PnPsolver replacement.

A host numpy copy of dspslam_tpu/slam/pnp.py; `ransac_pnp` keeps its
seeded RNG, so both packages draw the same samples. The reference uses
EPnP + RANSAC inside a legacy-OpenCV solver (reference
src/PnPsolver.cc). Here a 6-point DLT pose hypothesis (linear camera
resection, orthogonalized) is scored under RANSAC; the
winner's inliers are polished by the robust GN pose optimizer
(slam.pose_opt). DLT needs >= 6 points vs EPnP's 4, which is irrelevant
at relocalization match counts (tens), and the linear solve is
batched-SVD friendly.
"""

from __future__ import annotations

import numpy as np


def pnp_dlt(pts_w: np.ndarray, uv: np.ndarray, K: np.ndarray):
    """Linear resection from n >= 6 2D-3D pairs -> T_cw (4, 4) or None."""
    n = len(pts_w)
    if n < 6:
        return None
    invK = np.linalg.inv(K)
    x_norm = (np.concatenate([uv, np.ones((n, 1))], -1) @ invK.T)[:, :2]
    A = np.zeros((2 * n, 12))
    X_h = np.concatenate([pts_w, np.ones((n, 1))], -1)
    A[0::2, 0:4] = X_h
    A[0::2, 8:12] = -x_norm[:, 0:1] * X_h
    A[1::2, 4:8] = X_h
    A[1::2, 8:12] = -x_norm[:, 1:2] * X_h
    try:
        _, _, vt = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        return None
    P = vt[-1].reshape(3, 4)
    # cheirality: the mean point should be in front
    if np.mean(X_h @ P[2]) < 0:
        P = -P
    R_raw = P[:, :3]
    # orthogonalize via SVD; recover scale from singular values
    u, s, vt2 = np.linalg.svd(R_raw)
    scale = s.mean()
    if scale < 1e-12:
        return None
    R = u @ vt2
    if np.linalg.det(R) < 0:
        R = -R
        P = -P
        scale = -scale  # keep t consistent with the flipped P
    t = P[:, 3] / scale
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def reprojection_errors(T_cw, pts_w, uv, K):
    pc = pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    proj = (pc @ K.T)
    proj = proj[:, :2] / np.maximum(proj[:, 2:3], 1e-9)
    err = np.linalg.norm(proj - uv, axis=-1)
    err[z <= 0.05] = np.inf
    return err


def ransac_pnp(
    pts_w: np.ndarray,
    uv: np.ndarray,
    K: np.ndarray,
    iterations: int = 100,
    inlier_px: float = 5.0,
    min_inliers: int = 12,
    seed: int = 0,
):
    """Returns (T_cw or None, inlier_mask). Refit on the inlier set."""
    n = len(pts_w)
    if n < max(6, min_inliers):
        return None, np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    best_T, best_count, best_mask = None, 0, None
    for _ in range(iterations):
        idx = rng.choice(n, 6, replace=False)
        T = pnp_dlt(pts_w[idx], uv[idx], K)
        if T is None:
            continue
        err = reprojection_errors(T, pts_w, uv, K)
        mask = err < inlier_px
        if mask.sum() > best_count:
            best_T, best_count, best_mask = T, int(mask.sum()), mask
    if best_T is None or best_count < min_inliers:
        return None, np.zeros(n, bool)
    refined = pnp_dlt(pts_w[best_mask], uv[best_mask], K)
    if refined is not None:
        err = reprojection_errors(refined, pts_w, uv, K)
        mask = err < inlier_px
        if mask.sum() >= best_count:
            return refined, mask
    return best_T, best_mask
