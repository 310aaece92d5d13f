"""SE(3) / Sim(3) Lie-group operations on tensors with leading batch dims.

Port of dspslam_tpu/ops/lie.py. Tangent vectors are ordered
``[translation(3), rotation(3)]`` for se(3) and ``[translation(3),
rotation(3), log-scale(1)]`` for sim(3), applied as a *left*
perturbation ``T <- exp(dx) @ T``.

The small-angle branches keep the reference's thresholds exactly: the
closed forms cancel catastrophically in f32 well before underflow, so
`_sinc_coeffs` switches to its Taylor series at theta^2 < 0.01 and
`sim3_w_matrix` to its matrix series at theta^2 + s^2 < 0.01. Both
branches are evaluated on sanitized inputs and selected by `torch.where`,
so neither can inject a NaN.
"""

from __future__ import annotations

import torch


def _eye3(like: torch.Tensor, batch_shape) -> torch.Tensor:
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return eye.expand(*batch_shape, 3, 3)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), Taylor series
    below theta^2 = 0.01 (see the module docstring)."""
    small = theta_sq < 0.01
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    a_big = torch.sin(theta) / theta
    b_big = (1.0 - torch.cos(theta)) / safe_sq
    c_big = (theta - torch.sin(theta)) / (safe_sq * theta)
    t2 = theta_sq
    t4 = theta_sq * theta_sq
    a_small = 1.0 - t2 / 6.0 + t4 / 120.0
    b_small = 0.5 - t2 / 24.0 + t4 / 720.0
    c_small = 1.0 / 6.0 - t2 / 120.0 + t4 / 5040.0
    return (
        torch.where(small, a_small, a_big),
        torch.where(small, b_small, b_big),
        torch.where(small, c_small, c_big),
    )


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) rotation vector -> (..., 3, 3)."""
    A, B, _ = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye3(w, w.shape[:-1]) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J of SO(3): exp_se3 translation is J @ v."""
    _, B, C = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye3(w, w.shape[:-1]) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def exp_se3(x: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3). x is (..., 6) ordered [v, w]; returns (..., 4, 4)."""
    v, w = x[..., :3], x[..., 3:6]
    t = (so3_left_jacobian(w) @ v[..., None])[..., 0]
    return rt_to_mat44(exp_so3(w), t)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) -> rotation vector, accurate away from theta == pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    small = torch.abs(sin_theta) < 1e-6
    factor = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / torch.where(small, torch.ones_like(sin_theta), 2.0 * sin_theta),
    )
    return factor[..., None] * vee(R - R.transpose(-1, -2))


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(w * w, dim=-1)
    # series below theta = 0.5: (1 - x cot x) cancels in f32 for small x
    small = theta_sq < 0.25
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    half = 0.5 * torch.sqrt(safe_sq)
    cot_term_big = (1.0 - half * torch.cos(half) / torch.sin(half)) / safe_sq
    cot_series = 1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0
    cot_term = torch.where(small, cot_series, cot_term_big)
    W = hat(w)
    return _eye3(w, w.shape[:-1]) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) -> (..., 6) tangent [v, w] with exp_se3(log_se3(T)) == T."""
    w = log_so3(T[..., :3, :3])
    v = (_so3_left_jacobian_inv(w) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], dim=-1)


def sim3_w_matrix(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The Sim(3) 'W' matrix coupling translation with rotation and scale:
    exp_sim3 translation = W @ v."""
    theta_sq = torch.sum(w * w, dim=-1)
    small_t = theta_sq < 1e-8
    safe_sq = torch.where(small_t, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    es = torch.exp(s)
    small_s = torch.abs(s) < 1e-6
    safe_s = torch.where(small_s, torch.ones_like(s), s)
    # C = (e^s - 1)/s, Taylor: 1 + s/2 + s^2/6
    C = torch.where(small_s, 1.0 + s / 2.0 + s * s / 6.0, (es - 1.0) / safe_s)

    a = es * torch.sin(theta)
    b = es * torch.cos(theta)
    denom = s * s + safe_sq
    k1_big = (a * s + (1.0 - b) * theta) / (denom * theta)
    k2_big = (C - ((b - 1.0) * s + a * theta) / denom) / safe_sq
    # theta -> 0 limits, keeping the s dependence
    k1_small = torch.where(
        small_s, 0.5 + s / 3.0, (s * es - es + 1.0) / (safe_s * safe_s)
    )
    k2_small = torch.where(
        small_s,
        1.0 / 6.0 + s / 8.0,
        (es - 1.0 - safe_s * es + safe_s * safe_s * es * 0.5) / (safe_s**3),
    )
    k1 = torch.where(small_t, k1_small, k1_big)
    k2 = torch.where(small_t, k2_small, k2_big)

    W = hat(w)
    W2 = W @ W
    eye = _eye3(w, w.shape[:-1])
    W_exact = C[..., None, None] * eye + k1[..., None, None] * W + k2[..., None, None] * W2

    # small-generator region: the defining series sum_n M^n/(n+1)! with
    # M = s I + hat(w); matrix products of O(0.1) entries do not cancel
    M = s[..., None, None] * eye + W
    M2 = M @ M
    M3 = M2 @ M
    M4 = M2 @ M2
    M5 = M4 @ M
    W_series = eye + M / 2.0 + M2 / 6.0 + M3 / 24.0 + M4 / 120.0 + M5 / 720.0
    use_series = (theta_sq + s * s) < 0.01
    return torch.where(use_series[..., None, None], W_series, W_exact)


def exp_sim3(x: torch.Tensor) -> torch.Tensor:
    """sim(3) (..., 7) [v, w, s] -> Sim(3) 4x4 with sR upper-left."""
    v, w, s = x[..., :3], x[..., 3:6], x[..., 6]
    sR = torch.exp(s)[..., None, None] * exp_so3(w)
    t = (sim3_w_matrix(w, s) @ v[..., None])[..., 0]
    return rt_to_mat44(sR, t)


def log_sim3(T: torch.Tensor) -> torch.Tensor:
    """Sim(3) 4x4 (sR upper-left) -> (..., 7) tangent [v, w, s]."""
    s, R, t = split_sim3(T)
    log_s = torch.log(s)
    w = log_so3(R)
    v = (torch.linalg.inv(sim3_w_matrix(w, log_s)) @ t[..., None])[..., 0]
    return torch.cat([v, w, log_s[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# 4x4 helpers


def rt_to_mat44(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4) homogeneous."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(*batch, 4, 4, dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def inverse_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of an SE(3) 4x4 (R orthonormal)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat44(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def inverse_sim3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a Sim(3) 4x4 with sR upper-left block."""
    s, R, t = split_sim3(T)
    inv_sR = R.transpose(-1, -2) / s[..., None, None]
    return rt_to_mat44(inv_sR, -(inv_sR @ t[..., None])[..., 0])


def split_sim3(T: torch.Tensor):
    """Factor a Sim(3) 4x4 into (scale, R, t); scale = det(sR)^(1/3)."""
    sR = T[..., :3, :3]
    s = _det3(sR) ** (1.0 / 3.0)
    return s, sR / s[..., None, None], T[..., :3, 3]


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) -> (..., N, 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def points_to_pose_jacobian_sim3(points: torch.Tensor) -> torch.Tensor:
    """d(exp(dx) y)/d dx at dx=0 for transformed points y:
    (..., N, 3) -> (..., N, 3, 7) with columns [I | -hat(y) | y]."""
    eye = _eye3(points, points.shape[:-1])
    return torch.cat([eye, -hat(points), points[..., None]], dim=-1)
