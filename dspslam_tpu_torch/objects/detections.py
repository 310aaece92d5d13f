"""Detection measurement preprocessing: 3D boxes + LiDAR + 2D masks ->
padded, fixed-shape observation batches for the device-side optimizer.

Host-side numpy re-expression of the reference's FrameWithLiDAR
(reference reconstruct/kitti_sequence.py:27-217):

* a KITTI 3D detection [x, y, z, w, l, h, yaw] (velodyne frame) becomes a
  Sim(3) object pose with the ShapeNet axis convention (object +y up) and
  scale = 1.1 * l/2 folded into the rotation block;
* LiDAR points are cropped per box (3 m centroid radius, then the
  1.1x-expanded box test in the object frame) and evenly subsampled to a
  cap;
* each 3D instance is associated to the 2D mask containing >50% of its
  projected surface points; foreground rays are those projections,
  background rays are strided non-mask pixels from the expanded bbox;
* occlusion masks accumulate in depth order.

The output of `pad_detections` is a dict of (B, ...) arrays + masks
with static caps, which `shape.gn.batched_reconstruct` consumes as one
device program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Detection:
    """One object measurement in a frame (camera coordinates)."""

    T_cam_obj: np.ndarray                  # (4, 4) Sim(3): scale baked in
    scale: float                           # the baked-in scale
    box_size: np.ndarray                   # (3,) [w, l, h] full extents
    surface_points: np.ndarray             # (N, 3) camera frame
    rays: Optional[np.ndarray] = None      # (M, 3) fg then bg directions
    depth: Optional[np.ndarray] = None     # (Nf,) fg depths
    num_foreground: int = 0
    mask: Optional[np.ndarray] = None      # (H, W) bool
    bbox: Optional[np.ndarray] = None      # (4,) [l, t, r, b]
    occlusion_mask: Optional[np.ndarray] = None

    @property
    def is_front(self) -> bool:
        return float(self.T_cam_obj[2, 3]) > 0.0

    @property
    def num_surface_points(self) -> int:
        return int(self.surface_points.shape[0])


def kitti_box_to_pose_velo(det3d: np.ndarray) -> np.ndarray:
    """[x, y, z, w, l, h, yaw] -> T_velo_obj with object +y pointing up.

    The object frame follows ShapeNet (y up, z forward); the box center
    is lifted by h/2 since KITTI boxes sit on the ground
    (kitti_sequence.py:118-121 convention).
    """
    x, y, z = det3d[0:3]
    h = det3d[5]
    theta = det3d[6]
    c, s = np.cos(theta), np.sin(theta)
    T = np.array(
        [
            [c, 0.0, -s, x],
            [-s, 0.0, -c, y],
            [0.0, 1.0, 0.0, z + h / 2.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )
    return T


def crop_lidar_for_box(
    velo_pts: np.ndarray, det3d: np.ndarray, max_points: int = 250
) -> np.ndarray:
    """Surface LiDAR points for a 3D box, velodyne frame (N<=max, 4)."""
    center = det3d[:3]
    size = det3d[3:6]
    r = 3.0
    near = np.all(np.abs(velo_pts[:, :3] - center) < r, axis=-1)
    pts_near = velo_pts[near]
    T_obj_velo = np.linalg.inv(kitti_box_to_pose_velo(det3d))
    pts_obj = pts_near[:, :3] @ T_obj_velo[:3, :3].T + T_obj_velo[:3, 3]
    half_w, half_l, half_h = size / 2.0
    half_w *= 1.1
    half_l *= 1.1
    inside = (
        (np.abs(pts_obj[:, 0]) < half_w)
        & (np.abs(pts_obj[:, 1]) < half_h)
        & (np.abs(pts_obj[:, 2]) < half_l)
    )
    pts = pts_near[inside]
    if len(pts) > max_points:
        keep = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts = pts[keep]
    return pts


def transform(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def project(K: np.ndarray, pts_cam: np.ndarray):
    """(N, 3) camera points -> (uv (N, 2), valid depth mask)."""
    hom = pts_cam @ K.T
    z = hom[:, 2]
    uv = hom[:, :2] / np.where(z == 0, 1e-9, z)[:, None]
    return uv, z > 0


def pixel_rays(uv: np.ndarray, invK: np.ndarray) -> np.ndarray:
    """Pixel coordinates (N, 2) [u, v] -> ray directions (N, 3)."""
    hom = np.concatenate([uv, np.ones((len(uv), 1))], axis=-1)
    return (hom @ invK.T).astype(np.float32)


def sample_background_pixels(
    bbox: np.ndarray,
    mask: np.ndarray,
    stride: float = 4.0,
    max_pixels: int = 200,
    margin: int = 5,
) -> np.ndarray:
    """Strided non-mask pixels inside the margin-expanded bbox -> (M, 2) [u, v]."""
    h, w = mask.shape
    l, t, r, b = bbox.astype(np.int64)
    l = max(l - margin, 0)
    t = max(t - margin, 0)
    r = min(r + margin, w - 1)
    b = min(b + margin, h - 1)
    vv = np.linspace(t, b, max(int((b - t + 1) / stride), 1)).astype(np.int64)
    uu = np.linspace(l, r, max(int((r - l + 1) / stride), 1)).astype(np.int64)
    grid_v, grid_u = np.meshgrid(vv, uu, indexing="ij")
    flat_u, flat_v = grid_u.reshape(-1), grid_v.reshape(-1)
    keep = ~mask[flat_v, flat_u]
    px = np.stack([flat_u[keep], flat_v[keep]], axis=-1)
    if len(px) > max_pixels:
        idx = np.linspace(0, len(px) - 1, max_pixels).astype(np.int64)
        px = px[idx]
    return px


def build_frame_detections(
    detections_3d: np.ndarray,       # (N, 7) velodyne-frame boxes
    masks_2d: Optional[np.ndarray],  # (M, H, W) bool
    boxes_2d: Optional[np.ndarray],  # (M, 4)
    velo_pts: np.ndarray,            # (V, 4)
    K: np.ndarray,
    invK: np.ndarray,
    T_cam_velo: np.ndarray,
    image_hw: tuple[int, int],
    max_lidar_points: int = 250,
    min_mask_area: float = 1000.0,
    bg_stride: float = 4.0,
    max_bg_rays: int = 200,
) -> list[Detection]:
    """Full per-frame measurement build (detections sorted near-to-far)."""
    h, w = image_hw
    order = np.argsort(detections_3d[:, 0]) if len(detections_3d) else []
    out: list[Detection] = []
    occ = np.zeros((h, w), bool)
    from .. import native

    for n in order:
        det3d = detections_3d[n]
        pts_velo = native.crop_lidar_box(velo_pts, det3d, max_lidar_points)
        pts_cam = transform(T_cam_velo, pts_velo[:, :3]).astype(np.float32)
        T_cam_obj = (T_cam_velo @ kitti_box_to_pose_velo(det3d)).astype(np.float32)
        scale = 1.1 * det3d[4] / 2.0
        T_scaled = T_cam_obj.copy()
        T_scaled[:3, :3] *= scale
        det = Detection(
            T_cam_obj=T_scaled,
            scale=float(scale),
            box_size=det3d[3:6].copy(),
            surface_points=pts_cam,
        )
        out.append(det)
        if not det.is_front or masks_2d is None or len(masks_2d) == 0:
            continue
        uv, front = project(K, pts_cam)
        in_fov = (
            front
            & (uv[:, 0] > 0) & (uv[:, 0] < w)
            & (uv[:, 1] > 0) & (uv[:, 1] < h)
        )
        px = uv[in_fov]
        if len(px) == 0:
            continue
        pi = px.astype(np.int64)
        hits = masks_2d[:, pi[:, 1], pi[:, 0]].sum(axis=-1)
        best = int(np.argmax(hits))
        if hits[best] <= 0.5 * len(px):
            continue
        det.mask = masks_2d[best]
        det.bbox = np.asarray(boxes_2d[best][:4])
        # occlusion mask: union of all NEARER detections' masks (the
        # build iterates near-to-far). Pixels under it belong to the
        # occluder, so they are excluded from BOTH foreground rays (their
        # LiDAR depth is the occluder's surface) and background rays
        # (they do not see free space behind this object).
        det.occlusion_mask = occ.copy()
        if det.mask.sum() > min_mask_area:
            vis = ~occ[pi[:, 1], pi[:, 0]]
            px_vis = px[vis]
            bg_px = sample_background_pixels(
                det.bbox, det.mask, bg_stride, max_bg_rays
            )
            if len(bg_px):
                bi = np.clip(
                    bg_px.astype(np.int64), 0,
                    [[w - 1, h - 1]],
                )
                bg_px = bg_px[~occ[bi[:, 1], bi[:, 0]]]
            all_px = np.concatenate([px_vis, bg_px], axis=0)
            det.rays = pixel_rays(all_px, invK)
            det.depth = pts_cam[in_fov][:, 2][vis].astype(np.float32)
            det.num_foreground = len(px_vis)
        occ |= det.mask
    return out


def pad_detections(
    dets: list[Detection],
    max_detections: int = 8,
    max_surface_points: int = 256,
    max_rays: int = 512,
) -> dict:
    """Pack Detections into fixed-shape batched arrays for the device.

    Only detections with rays (i.e. mask-associated) get live ray slots;
    all get surface-point slots. Returns a dict of (B, ...) numpy arrays:
    t_cam_obj, pts, pts_mask, rays, ray_mask, depth, fg_mask, valid (B,).
    """
    B = max_detections
    P, R = max_surface_points, max_rays
    batch = {
        "t_cam_obj": np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
        "pts": np.zeros((B, P, 3), np.float32),
        "pts_mask": np.zeros((B, P), np.float32),
        "rays": np.zeros((B, R, 3), np.float32),
        "ray_mask": np.zeros((B, R), np.float32),
        "depth": np.zeros((B, R), np.float32),
        "fg_mask": np.zeros((B, R), np.float32),
        "valid": np.zeros((B,), np.float32),
    }
    for i, det in enumerate(dets[:B]):
        batch["valid"][i] = 1.0
        batch["t_cam_obj"][i] = det.T_cam_obj
        n = min(det.num_surface_points, P)
        batch["pts"][i, :n] = det.surface_points[:n]
        batch["pts_mask"][i, :n] = 1.0
        if det.rays is not None:
            m = min(len(det.rays), R)
            batch["rays"][i, :m] = det.rays[:m]
            batch["ray_mask"][i, :m] = 1.0
            nf = min(det.num_foreground, m)
            batch["fg_mask"][i, :nf] = 1.0
            batch["depth"][i, :nf] = det.depth[:nf]
    return batch
