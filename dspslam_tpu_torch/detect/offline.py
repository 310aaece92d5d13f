"""Offline detection playback — the deterministic detector backend.

Mirrors the reference's `detect_online=false` path (README.md:168-174,
kitti_sequence.py:104-107, 162-165): pre-stored per-frame label files
replace the MaskRCNN / PointPillars networks. Formats supported:

* reference `.lbl` files (torch.save pickles: 3D = (N, 7) array of
  [x, y, z, w, l, h, yaw]; 2D = dict with 'pred_boxes' (M, 4+) and
  'pred_masks' (M, H, W));
* native `.npz` files with the same keys — no torch required.

This is the key test fixture mechanism: cached detections make the whole
object pipeline reproducible without detector weights (SURVEY.md §4).
"""

from __future__ import annotations

import os

import numpy as np


def _load_any(path: str):
    if path.endswith(".npz"):
        return dict(np.load(path, allow_pickle=True))
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def load_labels_3d(label_dir: str, frame_id: int) -> np.ndarray:
    """(N, 7) [x, y, z, w, l, h, yaw] velodyne-frame boxes."""
    for ext in (".npz", ".lbl"):
        path = os.path.join(label_dir, f"{frame_id:06d}{ext}")
        if os.path.exists(path):
            data = _load_any(path)
            if isinstance(data, dict):
                arr = data["boxes_3d"] if "boxes_3d" in data else data["arr_0"]
            else:
                arr = data
            arr = np.asarray(arr, np.float32)
            return arr.reshape(-1, 7)
    raise FileNotFoundError(f"no 3D labels for frame {frame_id} in {label_dir}")


def load_labels_2d(label_dir: str, frame_id: int):
    """(boxes (M, 4+), masks (M, H, W) bool)."""
    for ext in (".npz", ".lbl"):
        path = os.path.join(label_dir, f"{frame_id:06d}{ext}")
        if os.path.exists(path):
            data = _load_any(path)
            boxes = np.asarray(data["pred_boxes"], np.float32)
            masks = np.asarray(data["pred_masks"]).astype(bool)
            return boxes, masks
    raise FileNotFoundError(f"no 2D labels for frame {frame_id} in {label_dir}")


def save_labels_npz(
    label_dir_2d: str,
    label_dir_3d: str,
    frame_id: int,
    boxes_3d: np.ndarray,
    boxes_2d: np.ndarray,
    masks_2d: np.ndarray,
):
    """Write native-format label fixtures (mirrors get_labels_and_save)."""
    os.makedirs(label_dir_2d, exist_ok=True)
    os.makedirs(label_dir_3d, exist_ok=True)
    np.savez_compressed(
        os.path.join(label_dir_3d, f"{frame_id:06d}.npz"), boxes_3d=boxes_3d
    )
    np.savez_compressed(
        os.path.join(label_dir_2d, f"{frame_id:06d}.npz"),
        pred_boxes=boxes_2d,
        pred_masks=masks_2d,
    )
