"""2D tracking overlay, the FrameDrawer equivalent.

Port of dspslam_tpu/viz/frame_drawer.py (a host numpy copy). Replaces the
reference's OpenCV debug window (src/FrameDrawer.cc): draws tracked
keypoints (green squares for map-point matches, blue for unmatched
features), detection masks and a status bar onto the frame, and returns an
RGB array to save or stream (no window)."""

from __future__ import annotations

import numpy as np


def _draw_square(img, x, y, half, color):
    h, w = img.shape[:2]
    x0, x1 = max(x - half, 0), min(x + half + 1, w)
    y0, y1 = max(y - half, 0), min(y + half + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    img[y0, x0:x1] = color
    img[y1 - 1, x0:x1] = color
    img[y0:y1, x0] = color
    img[y0:y1, x1 - 1] = color


def draw_frame(img_gray: np.ndarray, feats: dict, map_point_ids: np.ndarray | None = None,
               detections: list | None = None, state: str = "OK") -> np.ndarray:
    """(H, W) grayscale and host features -> (H, W, 3) uint8 overlay."""
    g = np.clip(img_gray, 0, 255).astype(np.uint8)
    img = np.stack([g, g, g], axis=-1)
    green = np.array([0, 255, 0], np.uint8)
    blue = np.array([80, 80, 255], np.uint8)
    red = np.array([255, 0, 0], np.uint8)

    for det in detections or ():
        if det is not None and det.mask is not None:
            m = det.mask
            img[m] = (0.6 * img[m] + 0.4 * red).astype(np.uint8)

    valid = feats["valid"] > 0
    xy = feats["xy"].astype(np.int64)
    for i in np.nonzero(valid)[0]:
        matched = map_point_ids is not None and map_point_ids[i] >= 0
        _draw_square(img, xy[i, 0], xy[i, 1], 3, green if matched else blue)

    # status strip: a coloured bar at the bottom (no font dependency)
    img[-6:, :] = {"OK": green, "LOST": red}.get(state, blue)
    return img
