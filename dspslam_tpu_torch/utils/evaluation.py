"""Trajectory evaluation: ATE RMSE after Umeyama / Horn alignment.

Host numpy copies of `align_trajectories` and `ate_rmse` from
dspslam_tpu/utils/evaluation.py and of the `horn_sim3` they need from
dspslam_tpu/place/sim3.py.
"""

from __future__ import annotations

import numpy as np


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


def align_trajectories(est_t: np.ndarray, gt_t: np.ndarray, scale: bool):
    """Umeyama alignment of estimated positions onto ground truth.
    Returns aligned estimated positions."""
    s, R, t = horn_sim3(gt_t, est_t, fix_scale=not scale)
    return est_t @ (s * R).T + t


def ate_rmse(
    est: np.ndarray, gt: np.ndarray, align: bool = True, scale: bool = False
) -> dict:
    """Absolute trajectory error between (N, 4, 4) pose arrays (T_wc).

    scale=True enables Sim(3) alignment (monocular). Returns dict with
    rmse / mean / median / max in meters.
    """
    est_t = est[:, :3, 3].astype(np.float64)
    gt_t = gt[:, :3, 3].astype(np.float64)
    n = min(len(est_t), len(gt_t))
    est_t, gt_t = est_t[:n], gt_t[:n]
    if align and n >= 3:
        est_t = align_trajectories(est_t, gt_t, scale)
    err = np.linalg.norm(est_t - gt_t, axis=-1)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "n": int(n),
    }
