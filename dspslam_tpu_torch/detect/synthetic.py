"""Synthetic scene generator: deterministic end-to-end fixtures.

Builds a KITTI-like frame (velodyne scan + 2D instance masks + 3D boxes)
from analytic spherical objects that exactly match the analytic sphere
decoder (models.deepsdf.sphere_decoder_fn), so the full measurement ->
reconstruction -> mesh pipeline is testable (and benchmarkable) without
detector weights or dataset downloads. Plays the role the reference
assigns to cached offline detections (SURVEY.md §4.4).

Frames use KITTI conventions: velodyne x forward / y left / z up; camera
x right / y down / z forward.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# canonical KITTI cam2 intrinsics / velodyne extrinsics (approximate)
DEFAULT_K = np.array(
    [[707.09, 0.0, 601.89], [0.0, 707.09, 183.11], [0.0, 0.0, 1.0]], np.float32
)
DEFAULT_T_CAM_VELO = np.array(
    [
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, -0.08],
        [1.0, 0.0, 0.0, -0.27],
        [0.0, 0.0, 0.0, 1.0],
    ],
    np.float32,
)
IMAGE_HW = (376, 1241)


@dataclasses.dataclass
class SyntheticScene:
    velo_pts: np.ndarray        # (V, 4)
    boxes_3d: np.ndarray        # (N, 7) [x, y, z, w, l, h, yaw] velodyne
    boxes_2d: np.ndarray        # (N, 4) [l, t, r, b]
    masks_2d: np.ndarray        # (N, H, W) bool
    centers_velo: np.ndarray    # (N, 3) true sphere centers
    radius: float               # true sphere radius (world units)
    K: np.ndarray
    invK: np.ndarray
    T_cam_velo: np.ndarray
    image_hw: tuple


def make_sphere_scene(
    # lifted off the z=-1.6 ground plane so the (oversized) 3D boxes never
    # swallow ground returns in the LiDAR crop
    centers=((8.0, 0.5, 0.8), (14.0, -3.0, 1.0)),
    radius: float = 1.0,
    n_surface: int = 400,
    n_ground: int = 2000,
    seed: int = 0,
    K: np.ndarray = DEFAULT_K,
    T_cam_velo: np.ndarray = DEFAULT_T_CAM_VELO,
    image_hw=IMAGE_HW,
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    centers = np.asarray(centers, np.float32)
    h, w = image_hw
    invK = np.linalg.inv(K).astype(np.float32)

    # LiDAR: front-hemisphere surface samples per sphere + ground clutter
    clouds = []
    for c in centers:
        d = rng.normal(size=(n_surface, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        # keep points facing the sensor at the origin
        to_sensor = -c / np.linalg.norm(c)
        d = d[(d @ to_sensor) > 0.05]
        clouds.append(c + radius * d)
    ground = np.stack(
        [
            rng.uniform(2, 30, n_ground),
            rng.uniform(-10, 10, n_ground),
            np.full(n_ground, -1.6) + rng.normal(0, 0.02, n_ground),
        ],
        axis=-1,
    )
    pts = np.concatenate(clouds + [ground]).astype(np.float32)
    velo = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=-1)

    # 3D boxes: sized so the baked scale (1.1 * l/2) times the decoder's
    # canonical radius 0.5 reproduces the true world radius
    box_len = 4.0 * radius / 1.1
    boxes_3d = np.stack(
        [
            np.array(
                [c[0], c[1], c[2] - box_len / 2.0, box_len, box_len, box_len, 0.0]
            )
            for c in centers
        ]
    ).astype(np.float32)

    # 2D masks: pixels whose rays pass within `radius` of the center
    vv, uu = np.mgrid[0:h, 0:w]
    pix = np.stack([uu.ravel(), vv.ravel(), np.ones(h * w)], axis=-1)
    rays = (pix @ invK.T).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    masks, boxes_2d = [], []
    for c in centers:
        c_cam = T_cam_velo[:3, :3] @ c + T_cam_velo[:3, 3]
        closest = rays * (rays @ c_cam)[:, None]
        dist = np.linalg.norm(closest - c_cam, axis=-1)
        m = ((dist < radius) & ((rays @ c_cam) > 0)).reshape(h, w)
        masks.append(m)
        ys, xs = np.nonzero(m)
        if len(xs):
            boxes_2d.append([xs.min(), ys.min(), xs.max(), ys.max()])
        else:
            boxes_2d.append([0, 0, 0, 0])
    return SyntheticScene(
        velo_pts=velo,
        boxes_3d=boxes_3d,
        boxes_2d=np.asarray(boxes_2d, np.float32),
        masks_2d=np.stack(masks),
        centers_velo=centers,
        radius=radius,
        K=K,
        invK=invK,
        T_cam_velo=T_cam_velo,
        image_hw=image_hw,
    )
