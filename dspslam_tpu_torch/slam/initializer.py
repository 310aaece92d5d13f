"""Monocular two-view initialization.

A copy of dspslam_tpu/slam/initializer.py (host numpy). Re-derivation of
the reference Initializer (Initializer.cc): RANSAC-score a fundamental
matrix AND a homography in parallel on the same correspondences, pick the
model by the reference's score ratio RH = SH / (SH + SF) (> 0.40 ->
homography, Initializer.cc:44-120), decompose the winner into (R, t),
and accept the hypothesis with the best triangulated support (cheirality
+ parallax + reprojection gates). Map scale is fixed by normalizing the
median triangulated depth.

All heavy lifting is batched numpy SVD on a few hundred matches — this
runs once per sequence, so it stays host-side by design.
"""

from __future__ import annotations

import numpy as np

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_GAMMA = 5.991


def _normalize(pts):
    mean = pts.mean(axis=0)
    d = np.abs(pts - mean).mean(axis=0) + 1e-12
    T = np.array(
        [[1 / d[0], 0, -mean[0] / d[0]], [0, 1 / d[1], -mean[1] / d[1]], [0, 0, 1]]
    )
    return (pts - mean) / d, T


def _fundamental_8pt(p1, p2):
    n1, T1 = _normalize(p1)
    n2, T2 = _normalize(p2)
    A = np.stack(
        [
            n2[:, 0] * n1[:, 0], n2[:, 0] * n1[:, 1], n2[:, 0],
            n2[:, 1] * n1[:, 0], n2[:, 1] * n1[:, 1], n2[:, 1],
            n1[:, 0], n1[:, 1], np.ones(len(p1)),
        ],
        axis=-1,
    )
    _, _, vt = np.linalg.svd(A)
    F = vt[-1].reshape(3, 3)
    u, s, vt2 = np.linalg.svd(F)
    F = u @ np.diag([s[0], s[1], 0.0]) @ vt2
    return T2.T @ F @ T1


def _homography_dlt(p1, p2):
    n1, T1 = _normalize(p1)
    n2, T2 = _normalize(p2)
    rows = []
    for (x1, y1), (x2, y2) in zip(n1, n2):
        rows.append([0, 0, 0, -x1, -y1, -1, y2 * x1, y2 * y1, y2])
        rows.append([x1, y1, 1, 0, 0, 0, -x2 * x1, -x2 * y1, -x2])
    _, _, vt = np.linalg.svd(np.asarray(rows))
    H = vt[-1].reshape(3, 3)
    return np.linalg.inv(T2) @ H @ T1


def _sym_transfer_err_H(H, p1, p2):
    def fwd(H, a):
        h = np.concatenate([a, np.ones((len(a), 1))], axis=-1) @ H.T
        return h[:, :2] / h[:, 2:3]

    e12 = np.sum((fwd(H, p1) - p2) ** 2, axis=-1)
    e21 = np.sum((fwd(np.linalg.inv(H), p2) - p1) ** 2, axis=-1)
    return e12, e21


def _epipolar_err_F(F, p1, p2):
    h1 = np.concatenate([p1, np.ones((len(p1), 1))], axis=-1)
    h2 = np.concatenate([p2, np.ones((len(p2), 1))], axis=-1)
    Fx1 = h1 @ F.T           # lines in image 2
    Ftx2 = h2 @ F            # lines in image 1
    x2Fx1 = np.sum(h2 * Fx1, axis=-1)
    e2 = x2Fx1**2 / (Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + 1e-12)
    e1 = x2Fx1**2 / (Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2 + 1e-12)
    return e1, e2


def _ransac_model(p1, p2, solver, scorer, sample_size, iters, rng):
    best_score, best_M, best_inliers = -np.inf, None, None
    n = len(p1)
    for _ in range(iters):
        idx = rng.choice(n, sample_size, replace=False)
        try:
            M = solver(p1[idx], p2[idx])
        except np.linalg.LinAlgError:
            continue
        e1, e2 = scorer(M, p1, p2)
        th = CHI2_H if sample_size == 4 else CHI2_F
        inl = (e1 < th) & (e2 < th)
        score = float(
            np.sum(np.maximum(SCORE_GAMMA - e1, 0) * inl)
            + np.sum(np.maximum(SCORE_GAMMA - e2, 0) * inl)
        )
        if score > best_score:
            best_score, best_M, best_inliers = score, M, inl
    return best_M, best_score, best_inliers


def _triangulate(P1, P2, p1, p2):
    """Linear DLT triangulation -> (N, 3) in camera-1 frame."""
    out = np.zeros((len(p1), 3))
    for i, ((x1, y1), (x2, y2)) in enumerate(zip(p1, p2)):
        A = np.stack(
            [
                x1 * P1[2] - P1[0],
                y1 * P1[2] - P1[1],
                x2 * P2[2] - P2[0],
                y2 * P2[2] - P2[1],
            ]
        )
        _, _, vt = np.linalg.svd(A)
        X = vt[-1]
        out[i] = X[:3] / (X[3] if abs(X[3]) > 1e-12 else 1e-12)
    return out


def _check_rt(R, t, p1n, p2n, max_reproj=4.0 / 500.0):
    """Triangulate in normalized coords; count cheirality+parallax inliers."""
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, t.reshape(3, 1)])
    X = _triangulate(P1, P2, p1n, p2n)
    z1 = X[:, 2]
    X2 = X @ R.T + t
    z2 = X2[:, 2]
    # parallax between the two rays
    c2 = -R.T @ t
    r1 = X / (np.linalg.norm(X, axis=-1, keepdims=True) + 1e-12)
    r2 = (X - c2) / (np.linalg.norm(X - c2, axis=-1, keepdims=True) + 1e-12)
    cos_par = np.sum(r1 * r2, axis=-1)
    pr1 = X[:, :2] / np.maximum(z1[:, None], 1e-9)
    pr2 = X2[:, :2] / np.maximum(z2[:, None], 1e-9)
    e1 = np.sum((pr1 - p1n) ** 2, axis=-1)
    e2 = np.sum((pr2 - p2n) ** 2, axis=-1)
    good = (
        (z1 > 0) & (z2 > 0) & (cos_par < 0.99998)
        & (e1 < max_reproj**2) & (e2 < max_reproj**2)
    )
    return int(good.sum()), X, good


def _decompose_E(E):
    u, _, vt = np.linalg.svd(E)
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1, R2 = u @ W @ vt, u @ W.T @ vt
    t = u[:, 2]
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def _decompose_H(Hn):
    """Faugeras SVD decomposition of a calibrated homography -> (R, t) list."""
    U, S, Vt = np.linalg.svd(Hn)
    d1, d2, d3 = S
    if d1 / d2 < 1.0001 or d2 / d3 < 1.0001:
        return []   # degenerate (pure rotation)
    s = np.linalg.det(U) * np.linalg.det(Vt)
    out = []
    x1 = np.sqrt((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3))
    x3 = np.sqrt((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3))
    sin_t = np.sqrt((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / ((d1 + d3) * d2)
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    for e1 in (1, -1):
        for e3 in (1, -1):
            Rp = np.array(
                [
                    [cos_t, 0, -e1 * e3 * sin_t],
                    [0, 1, 0],
                    [e1 * e3 * sin_t, 0, cos_t],
                ]
            )
            tp = (d1 - d3) * np.array([e1 * x1, 0, -e3 * x3])
            R = s * U @ Rp @ Vt
            t = U @ tp
            out.append((R, t / (np.linalg.norm(t) + 1e-12)))
    sin_phi = np.sqrt((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / ((d1 - d3) * d2)
    cos_phi = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    for e1 in (1, -1):
        for e3 in (1, -1):
            Rp = np.array(
                [
                    [cos_phi, 0, e1 * e3 * sin_phi],
                    [0, -1, 0],
                    [e1 * e3 * sin_phi, 0, -cos_phi],
                ]
            )
            tp = (d1 + d3) * np.array([e1 * x1, 0, e3 * x3])
            R = s * U @ Rp @ Vt
            t = U @ tp
            out.append((R, t / (np.linalg.norm(t) + 1e-12)))
    return out


def initialize_two_view(
    p1: np.ndarray, p2: np.ndarray, K: np.ndarray,
    iters: int = 200, seed: int = 0, min_inliers: int = 40,
    min_triangulated_frac: float = 0.5,
):
    """Matched pixels (N, 2) x2 -> dict(R, t, points3d (N, 3) in cam-1,
    good_mask, model) or None. t has unit norm; depth scale is free."""
    if len(p1) < 12:
        return None
    rng = np.random.default_rng(seed)
    F, sF, inl_F = _ransac_model(
        p1, p2, _fundamental_8pt, _epipolar_err_F, 8, iters, rng
    )
    H, sH, inl_H = _ransac_model(
        p1, p2, _homography_dlt, _sym_transfer_err_H, 4, iters, rng
    )
    if F is None and H is None:
        return None
    rh = sH / max(sH + sF, 1e-12)
    invK = np.linalg.inv(K)

    def to_norm(p):
        h = np.concatenate([p, np.ones((len(p), 1))], axis=-1)
        return (h @ invK.T)[:, :2]

    p1n, p2n = to_norm(p1), to_norm(p2)

    if rh > 0.40:
        model = "H"
        Hn = invK @ H @ K
        Hn /= np.linalg.svd(Hn, compute_uv=False)[1]  # normalize by sigma_2
        candidates = _decompose_H(Hn)
        inliers = inl_H
    else:
        model = "F"
        E = K.T @ F @ K
        candidates = _decompose_E(E)
        inliers = inl_F

    if inliers is None or inliers.sum() < min_inliers or not candidates:
        return None

    p1i, p2i = p1n[inliers], p2n[inliers]
    best = None
    counts = []
    for R, t in candidates:
        n_good, X, good = _check_rt(R, t, p1i, p2i)
        counts.append(n_good)
        if best is None or n_good > best[0]:
            best = (n_good, R, t, X, good)
    counts.sort(reverse=True)
    n_good, R, t, X, good = best
    if n_good < min_inliers * min_triangulated_frac:
        return None
    if len(counts) > 1 and counts[1] > 0.9 * counts[0]:
        return None   # ambiguous winner (Initializer.cc's clear-winner rule)

    # normalize scale: median depth of good points = 1
    med = np.median(X[good][:, 2])
    if med <= 0:
        return None
    X = X / med
    t = t / med
    points3d = np.full((len(p1), 3), np.nan, np.float32)
    good_full = np.zeros(len(p1), bool)
    idx = np.nonzero(inliers)[0]
    points3d[idx] = X
    good_full[idx[good]] = True
    return {
        "R": R.astype(np.float32),
        "t": t.astype(np.float32),
        "points3d": points3d,
        "good_mask": good_full,
        "model": model,
        "n_good": n_good,
    }
