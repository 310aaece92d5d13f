"""LiDAR scans of the synthetic street, for the detect cell.

An HDL-64E-like ray cast of a drive's world (benchmark/scene.py) from each
frame's pose: `beams` elevations evenly from `elev_top_deg` down to
`elev_bottom_deg`, `azimuths` steps over 360 degrees, returns to
`max_range` m. A ray ends at the nearest of the ground plane, the world's
textured layers (where a sparse layer has a patch) and the objects'
spheres. The sensor sits at the left camera's centre (KITTI's sits 0.27 m
behind and 0.08 m above it), so a scan is in the velodyne frame of a
camera at the world's pose: x forward, y left, z up. Intensity is 0.2 on
the ground, 0.3 plus the texel's brightness over 510 on a layer, 0.6 on a
sphere. Scans are rendered in set-up and cached beside the frames
(benchmark/.cache/scans/), then go to the detector on the host, as a scan
read from disk does.
"""

from __future__ import annotations

import os

import numpy as np

from .common import cache_path
from .world import render_poses


def ray_directions(spec: dict) -> np.ndarray:
    """(beams * azimuths, 3) unit directions in the velodyne frame."""
    el = np.radians(np.linspace(spec["elev_top_deg"], spec["elev_bottom_deg"], spec["beams"]))
    az = np.linspace(0.0, 2 * np.pi, spec["azimuths"], endpoint=False)
    e, a = np.meshgrid(el, az, indexing="ij")
    return np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1).reshape(-1, 3)


# velodyne (x forward, y left, z up) -> camera (x right, y down, z forward)
VELO_TO_CAM = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def scan(drive, k: int, spec: dict) -> np.ndarray:
    """Frame k's scan of `drive` -> (N, 4) float32 [x, y, z, intensity]."""
    world = drive.world
    T = drive.traj[min(k, len(drive.traj) - 1)]
    R, C = T[:3, :3], T[:3, 3]
    d_velo = ray_directions(spec)
    d = d_velo @ VELO_TO_CAM.T @ R.T                   # world directions
    t_best = np.full(len(d), float(spec["max_range"]))
    inten = np.zeros(len(d))
    with np.errstate(divide="ignore", invalid="ignore"):
        if world.ground_height is not None:
            t = (world.ground_height - C[1]) / d[:, 1]
            hit = (d[:, 1] > 1e-9) & (t > 0.25) & (t < t_best)
            t_best[hit], inten[hit] = t[hit], 0.2
        for z, shift_min, tex in world.layers:
            t = (z - C[2]) / d[:, 2]
            ok = (d[:, 2] > 1e-9) & (t > 0.25) & (t < t_best)
            X = C[None] + t[:, None] * d
            col = np.floor(world.fx * X[:, 0] / z + world.cx - shift_min + 0.5)
            row = np.floor(world.fx * X[:, 1] / z + world.cy + 0.5)
            ok &= (row >= 0) & (row < tex.shape[0]) & (col >= 0) & (col < tex.shape[1])
            texel = np.full(len(d), np.nan)
            texel[ok] = tex[row[ok].astype(np.int64), col[ok].astype(np.int64)]
            hit = ok & ~np.isnan(texel)
            t_best[hit], inten[hit] = t[hit], 0.3 + texel[hit] / 510.0
        for c in drive.centers(k):
            oc = C - c
            b = d @ oc
            disc = b * b - (oc @ oc - drive.radius ** 2)
            t = -b - np.sqrt(np.maximum(disc, 0.0))
            hit = (disc > 0) & (t > 0.25) & (t < t_best)
            t_best[hit], inten[hit] = t[hit], 0.6
    ret = t_best < spec["max_range"]
    return np.concatenate([t_best[ret, None] * d_velo[ret], inten[ret, None]], 1).astype(np.float32)


def load_or_render(drive, spec: dict) -> bool:
    """Fill drive.scans (one (N, 4) array a frame) from the cache, or ray
    cast them and store them. Returns True on a cache hit."""
    path = cache_path({"drive": drive.cache_key(), "lidar": spec, "generator": "lidar.py@1"}, kind="scans")
    if os.path.exists(path):
        with np.load(path) as z:
            drive.scans = np.split(z["points"], z["offsets"][1:-1])
        return True
    drive.scans = render_poses(lambda k: scan(drive, k, spec), range(len(drive.traj)))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, points=np.concatenate(drive.scans),
             offsets=np.cumsum([0] + [len(s) for s in drive.scans]))
    os.replace(tmp, path)
    return False
