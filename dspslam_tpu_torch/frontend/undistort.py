"""Radial/tangential lens (un)distortion for keypoints and rays.

A copy of dspslam_tpu/frontend/undistort.py (host numpy).

The reference undistorts every extracted keypoint once per frame
(Frame::UndistortKeyPoints, reference src/Frame.cc:405-434, via
cv::undistortPoints) and undistorts the mono background-ray pixels
(reference reconstruct/mono_sequence.py:106-107). All downstream
geometry (projection matching, triangulation, pose GN) then lives in the
ideal pinhole model. The rebuild mirrors that contract: raw pixel
coordinates exist only (a) for image sampling (stereo SAD, RGBD depth
lookup) and (b) inside the extractor; everything geometric consumes
undistorted coordinates.

Model: OpenCV plumb-bob (k1, k2, p1, p2, k3). The inverse has no closed
form; cv::undistortPoints runs a fixed-point iteration on the normalized
coordinates — we do the same, vectorized (host numpy: ~2k points x 10
iterations is microseconds; stereo KITTI is rectified so the fused device
path never needs this).
"""

from __future__ import annotations

import numpy as np


def has_distortion(dist) -> bool:
    return dist is not None and any(abs(float(d)) > 1e-12 for d in dist)


def distort_normalized(xn: np.ndarray, dist) -> np.ndarray:
    """Forward plumb-bob model on normalized coordinates (N, 2)."""
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def distort_points(xy: np.ndarray, K: np.ndarray, dist) -> np.ndarray:
    """Ideal pixel coordinates (N, 2) -> raw (distorted) pixels (N, 2)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xn = np.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy], -1)
    xd = distort_normalized(xn, dist)
    return np.stack(
        [xd[..., 0] * fx + cx, xd[..., 1] * fy + cy], -1
    ).astype(np.float32)


def undistort_normalized(xd: np.ndarray, dist, iterations: int = 10):
    """Invert the plumb-bob model by fixed-point iteration on normalized
    coordinates (the cv::undistortPoints scheme): start at the distorted
    point and repeatedly divide out the radial term / subtract the
    tangential term evaluated at the current estimate."""
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    x = xd[..., 0].astype(np.float64).copy()
    y = xd[..., 1].astype(np.float64).copy()
    x0, y0 = x.copy(), y.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return np.stack([x, y], axis=-1)


def undistort_points(xy: np.ndarray, K: np.ndarray, dist,
                     iterations: int = 10) -> np.ndarray:
    """Raw (distorted) pixel coordinates (N, 2) -> ideal pixels (N, 2).

    Matches Frame::UndistortKeyPoints semantics: the returned coordinates
    project through the pinhole K with zero distortion.
    """
    if not has_distortion(dist):
        return np.asarray(xy, np.float32)
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xd = np.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy], -1)
    xn = undistort_normalized(xd, dist, iterations)
    return np.stack(
        [xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], -1
    ).astype(np.float32)


def undistorted_bounds(width: int, height: int, K: np.ndarray, dist):
    """Image bounds after undistortion (Frame::ComputeImageBounds,
    reference src/Frame.cc:436-465): undistort the four corners and
    take the enclosing min/max. Used to gate in-image tests on sequences
    with real lenses."""
    corners = np.array(
        [[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]],
        np.float32,
    )
    if not has_distortion(dist):
        return 0.0, float(width), 0.0, float(height)
    un = undistort_points(corners, K, dist)
    return (
        float(min(un[0, 0], un[2, 0])),
        float(max(un[1, 0], un[3, 0])),
        float(min(un[0, 1], un[1, 1])),
        float(max(un[2, 1], un[3, 1])),
    )
