"""PCA cuboid initialization + object-point outlier removal (mono path).

A copy of dspslam_tpu/objects/cuboid.py (host numpy). Re-expression of
MapObject::ComputeCuboidPCA / RemoveOutliers* (MapObject.cc:244-435): in
monocular mode an object has no LiDAR, so its Sim(3) pose is seeded from
the PCA of its member map points — principal axes mapped to the ShapeNet
convention (x right, y up, z back), 5-95 percentile extents, pose
T = [0.40 * l * R | center].
"""

from __future__ import annotations

import numpy as np


def remove_outliers_simple(points_w: np.ndarray, thresh: float = 1.0):
    """Flag points farther than `thresh` from the mean-distance ball
    (RemoveOutliersSimple, MapObject.cc:244-276). Returns inlier mask."""
    if len(points_w) == 0:
        return np.zeros(0, bool)
    center = points_w.mean(axis=0)
    d = np.linalg.norm(points_w - center, axis=-1)
    return d <= d.mean() + thresh


def remove_outliers_box(points_w, R, center_w, whl, margin: float = 1.2):
    """Outliers outside the margin-scaled PCA box (MapObject.cc:404-423)."""
    w, h, l = whl
    x_o = (points_w - center_w) @ R           # R^-1 x = x @ R (orthonormal)
    half = margin * np.array([w, h, l]) / 2.0
    return np.all(np.abs(x_o) <= half, axis=-1)


def compute_cuboid_pca(points_w: np.ndarray):
    """PCA cuboid fit -> dict(R, center, whl, T_wo_sim3, inlier_mask).

    Axis order follows the reference's assumption (eigenvalues ascending:
    y, x, -z), with det and upward-y fixes; scale = 0.40 * l.
    """
    keep = remove_outliers_simple(points_w)
    pts = points_w[keep]
    n = len(pts)
    if n < 3:
        return None
    mean = pts.mean(axis=0)
    cov = (pts - mean).T @ (pts - mean)
    eigval, eigvec = np.linalg.eigh(cov)      # ascending
    R = np.stack([eigvec[:, 1], eigvec[:, 0], -eigvec[:, 2]], axis=1)
    if np.linalg.det(R) < 0:
        R[:, 0] = -R[:, 0]
    # y axis should point up (camera -y)
    if np.dot(np.array([0.0, -1.0, 0.0]), R[:, 1]) < 0:
        R[:, 0] = -R[:, 0]
        R[:, 1] = -R[:, 1]

    x_o = pts @ R                              # (n, 3) object-frame coords
    lo, hi = int(0.05 * n), min(int(0.95 * n), n - 1)
    mins, maxs = [], []
    for k in range(3):
        s = np.sort(x_o[:, k])
        mins.append(s[lo])
        maxs.append(s[hi])
    mins, maxs = np.asarray(mins), np.asarray(maxs)
    whl = maxs - mins
    center_o = (maxs + mins) / 2.0
    center_w = R @ center_o

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = 0.40 * whl[2] * R
    T[:3, 3] = center_w
    inlier = np.zeros(len(points_w), bool)
    inlier[np.nonzero(keep)[0]] = remove_outliers_box(pts, R, center_w, whl)
    return {
        "R": R, "center": center_w, "whl": whl,
        "T_wo_sim3": T, "inlier_mask": inlier,
    }


def remove_outliers_model(
    points_w: np.ndarray, T_wo_sim3: np.ndarray,
    vertices_obj: np.ndarray, margin: float = 0.3,
):
    """Flag object member points outside the reconstructed mesh's bbox
    (margin-expanded, object units) — RemoveOutliersModel
    (MapObject.cc:278-322). Returns inlier mask over points_w."""
    if len(points_w) == 0 or vertices_obj is None or len(vertices_obj) == 0:
        return np.ones(len(points_w), bool)
    sR = T_wo_sim3[:3, :3]
    s = float(np.linalg.det(sR)) ** (1.0 / 3.0)
    R = sR / s
    t = T_wo_sim3[:3, 3]
    x_o = ((points_w - t) @ R) / s
    lo = vertices_obj.min(axis=0) - margin
    hi = vertices_obj.max(axis=0) + margin
    return np.all((x_o >= lo) & (x_o <= hi), axis=-1)


def floor_scale_to_domain(
    T_wo_sim3: np.ndarray, points_w: np.ndarray, max_radius: float = 1.25
) -> np.ndarray:
    """Raise the Sim(3) scale so the evidence points land within
    `max_radius` of the object frame's origin (canonical units).

    The reference's 0.40 * l prior is tuned for ShapeNet cars and dense
    LiDAR; on sparse mono point clouds the percentile extents
    underestimate badly enough that member points can fall far outside
    the decoder's trained domain (DeepSDF is only valid near the unit
    ball), leaving the GN without usable SDF values or gradients.
    max_radius 1.25 tolerates the same mild extrapolation the
    reference's own car scaling implies."""
    if len(points_w) == 0:
        return T_wo_sim3
    sR = T_wo_sim3[:3, :3]
    s = float(np.linalg.det(sR)) ** (1.0 / 3.0)
    r = np.linalg.norm(points_w - T_wo_sim3[:3, 3], axis=-1)
    r95 = float(np.quantile(r, 0.95)) if len(r) >= 5 else float(r.max())
    s_min = r95 / max_radius
    if s >= s_min or s_min <= 0:
        return T_wo_sim3
    out = T_wo_sim3.copy()
    out[:3, :3] = sR * (s_min / s)
    return out


def flipped_pose(T_wo_sim3: np.ndarray) -> np.ndarray:
    """180-degree yaw flip about the object's y axis — the mono
    orientation-ambiguity alternative initialization
    (LocalMapping_util.cc:396-407)."""
    flip = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    out = T_wo_sim3.copy()
    out[:3, :3] = T_wo_sim3[:3, :3] @ flip[:3, :3]
    return out
