"""Trajectory and mesh evaluation: ATE RMSE after Umeyama / Horn
alignment, RPE, chamfer distance, KITTI trajectory files.

A host numpy copy of dspslam_tpu/utils/evaluation.py.
"""

from __future__ import annotations

import numpy as np

from ..place.sim3 import horn_sim3


def load_kitti_trajectory(path: str) -> np.ndarray:
    """Cameras.txt-style rows of 3x4 T_wc -> (N, 4, 4)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4, dtype=np.float64), (len(rows), 1, 1))
    out[:, :3, :] = rows
    return out


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


def chamfer_distance(a: np.ndarray, b: np.ndarray,
                     chunk: int = 4096) -> float:
    """Symmetric chamfer distance between two point sets (N,3)/(M,3):
    mean nearest-neighbour distance in both directions, in the input
    unit. The reference evaluates reconstructed meshes against GT
    surfaces this way (standard DeepSDF protocol; optimizer.py:214-223
    is the mesh-producing path being scored)."""
    a = np.asarray(a, np.float64).reshape(-1, 3)
    b = np.asarray(b, np.float64).reshape(-1, 3)
    if len(a) == 0 or len(b) == 0:
        return float("nan")

    def one_way(src, dst):
        mins = np.empty(len(src))
        for i in range(0, len(src), chunk):
            d2 = ((src[i:i + chunk, None, :] - dst[None, :, :]) ** 2).sum(-1)
            mins[i:i + chunk] = np.sqrt(d2.min(axis=1))
        return mins.mean()

    return float(0.5 * (one_way(a, b) + one_way(b, a)))


def sample_sphere(center, radius: float, n: int = 500) -> np.ndarray:
    """Fibonacci-spiral samples of a sphere surface (GT for chamfer)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    d = np.stack([np.sin(phi) * np.cos(theta),
                  np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
    return np.asarray(center, np.float64) + radius * d


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> dict:
    """Relative pose error over `delta`-frame intervals: translational
    RMSE (m) and rotational RMSE (deg)."""
    n = min(len(est), len(gt)) - delta
    terr, rerr = [], []
    for i in range(n):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(cos)))
    terr, rerr = np.asarray(terr), np.asarray(rerr)
    return {
        "trans_rmse": float(np.sqrt(np.mean(terr**2))),
        "rot_rmse_deg": float(np.sqrt(np.mean(rerr**2))),
        "n": int(n),
    }
