"""Host-side (numpy) SE(3) exp/log for tiny per-frame pose algebra.

A copy of dspslam_tpu/ops/lie_np.py. Host orchestration code (the
tracker's velocity model) works on 4x4 numpy matrices and would pay a
device round trip per call with the tensor versions (ops.lie). Same
conventions as ops.lie: tangent order [translation, rotation], left
perturbation.
"""

from __future__ import annotations

import numpy as np


def _hat(w):
    return np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float64
    )


def exp_se3(x: np.ndarray) -> np.ndarray:
    """Tangent [rho (3), w (3)] -> 4x4 SE(3)."""
    rho, w = np.asarray(x[:3], np.float64), np.asarray(x[3:], np.float64)
    theta = np.linalg.norm(w)
    wx = _hat(w)
    if theta < 1e-8:
        R = np.eye(3) + wx
        V = np.eye(3) + 0.5 * wx
    else:
        a, b = np.sin(theta) / theta, (1 - np.cos(theta)) / theta**2
        c = (theta - np.sin(theta)) / theta**3
        R = np.eye(3) + a * wx + b * (wx @ wx)
        V = np.eye(3) + b * wx + c * (wx @ wx)
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T.astype(np.float32)


def log_se3(T: np.ndarray) -> np.ndarray:
    """4x4 SE(3) -> tangent [rho (3), w (3)]."""
    R = np.asarray(T[:3, :3], np.float64)
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(cos_t))
    if theta < 1e-8:
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        w *= 0.5
        Vinv = np.eye(3) - 0.5 * _hat(w)
    elif theta > np.pi - 1e-4:
        a2 = np.clip((np.diag(R) + 1.0) / 2.0, 0.0, 1.0)
        w = theta * np.sqrt(a2)
        # fix signs from off-diagonals
        if R[0, 1] + R[1, 0] < 0:
            w[1] = -w[1]
        if R[0, 2] + R[2, 0] < 0:
            w[2] = -w[2]
        wx = _hat(w)
        half = theta / 2.0
        k = (1.0 - half / np.tan(half)) / theta**2
        Vinv = np.eye(3) - 0.5 * wx + k * (wx @ wx)
    else:
        wx_full = (R - R.T) * (theta / (2.0 * np.sin(theta)))
        w = np.array([wx_full[2, 1], wx_full[0, 2], wx_full[1, 0]])
        wx = _hat(w)
        half = theta / 2.0
        k = (1.0 - half / np.tan(half)) / theta**2
        Vinv = np.eye(3) - 0.5 * wx + k * (wx @ wx)
    rho = Vinv @ np.asarray(T[:3, 3], np.float64)
    return np.concatenate([rho, w]).astype(np.float32)


def interp_se3(T_from: np.ndarray, T_to: np.ndarray, alpha: float) -> np.ndarray:
    """Geodesic interpolation: exp(alpha * log(T_to @ T_from^-1)) @ T_from."""
    delta = log_se3(T_to @ np.linalg.inv(T_from))
    return (exp_se3(alpha * delta) @ T_from).astype(np.float32)
