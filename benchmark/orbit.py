"""The orbit traffic: a hand-held camera circling a parked object, as in
the Freiburg Cars sequences, through the mono cells' layered world.

The camera keeps its height and yaws to look at the circled object's
centre, moving along an arc of `radius` metres at `deg_per_frame` from
`start_deg` (0 looks along +z). The world is `world.LayeredWorld` (the
mix's `world` block: planes, ground, texture seeds) with canvases wide
enough for the arc's views, and the parked objects are textured spheres
rendered into it with a depth test: the circled one at `center`, the
others at the `parked` offsets from it. Each sphere's texture is a
3D block pattern fixed to the sphere (blocks of `block` metres), so its
surface points are trackable map points.

Each frame also has a label map (uint8, 0 where no object is the nearest
surface, j + 1 where object j is), from which `instances(k)` gives the
visible objects' masks and boxes, as a segmentation of the frame would.
Renders and labels are cached under benchmark/.cache/renders/ by
everything they depend on.
"""

from __future__ import annotations

import os

import numpy as np

from .common import cache_path
from .world import LayeredWorld, pose_yaw, render_poses

GENERATOR = "orbit.py@1"


def orbit_trajectory(spec: dict, n: int) -> np.ndarray:
    """(n, 4, 4) camera-to-world poses on the arc, each looking at the
    centre."""
    cx, cy, cz = spec["center"]
    out = np.empty((n, 4, 4))
    for k in range(n):
        a = np.radians(spec["start_deg"] + spec["deg_per_frame"] * k)
        out[k] = pose_yaw(cx - spec["radius"] * np.sin(a), cz - spec["radius"] * np.cos(a), a)
    return out


def build_world(camera: dict, mix: dict, traj: np.ndarray, texture_seed: int) -> LayeredWorld:
    """The mix's layered world with canvases covering the arc's camera
    positions and `yaw_max_deg` of yaw."""
    spec = mix["world"]
    xs, zs = traj[:, 0, 3], traj[:, 2, 3]
    return LayeredWorld(
        camera["width"], camera["height"], camera["fx"], cx=camera["cx"], cy=camera["cy"],
        depths=tuple(spec["depths"]), coverage=tuple(spec["coverage"]), ground_height=spec["ground_height"],
        max_ground_depth=spec["max_ground_depth"], x_range=(float(xs.min()) - 1.0, float(xs.max()) + 1.0),
        seed=texture_seed, yaw_max=np.radians(spec["yaw_max_deg"]),
        z_range=(float(zs.min()), float(zs.max())),
    )


class OrbitDrive:
    """One variant of an orbit mix: poses, world, spheres, frames ((image,)
    uint8 per frame) and label maps."""

    def __init__(self, camera: dict, mix: dict, texture_seed: int):
        n = mix["frames_per_drive"]
        self.camera, self.mix, self.texture_seed = camera, mix, texture_seed
        self.traj = orbit_trajectory(mix["trajectory"], n + 1)
        obj = mix["objects"]
        c = np.asarray(mix["trajectory"]["center"], np.float64)
        self.spheres = np.vstack([c[None], c[None] + np.asarray(obj["parked"], np.float64)]).astype(np.float32)
        self.radius = float(obj["radius"])
        self.frames = self.labels = None
        self.world = None

    def _shot(self, T_wc):
        img, dep = self.world._compose_pose(T_wc)
        cam, obj = self.camera, self.mix["objects"]
        u, v = np.meshgrid(np.arange(cam["width"], dtype=np.float64), np.arange(cam["height"], dtype=np.float64))
        d_c = np.stack([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fx"], np.ones_like(u)], -1)
        R, C = np.asarray(T_wc, np.float64)[:3, :3], np.asarray(T_wc, np.float64)[:3, 3]
        d_w = d_c @ R.T
        dd = np.sum(d_w * d_w, -1)
        labels = np.zeros(dep.shape, np.uint8)
        tex = np.random.default_rng(obj["texture_seed"]).uniform(30, 235, (64,) * 3).astype(np.float32)
        for j, s in enumerate(self.spheres.astype(np.float64)):
            oc = s - C
            b = d_w @ oc
            disc = b * b - dd * (oc @ oc - self.radius ** 2)
            t = (b - np.sqrt(np.maximum(disc, 0.0))) / dd        # the camera-frame depth (d_c has unit z)
            hit = (disc > 0) & (t > 0.25) & (t < dep)
            p = C + t[hit][:, None] * d_w[hit] - s
            idx = np.floor(p / obj["block"]).astype(np.int64) % 64
            img[hit] = tex[idx[:, 0], idx[:, 1], idx[:, 2]]
            dep[hit] = t[hit]
            labels[hit] = j + 1
        return np.clip(np.round(img), 0, 255).astype(np.uint8), labels

    def render(self):
        self.world = build_world(self.camera, self.mix, self.traj, self.texture_seed)
        shots = render_poses(self._shot, self.traj)
        self.world = None               # the canvases are large and no longer needed
        self.frames = [(img,) for img, _ in shots]
        self.labels = np.stack([lab for _, lab in shots])

    def instances(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(boxes (M, 4) [l, t, r, b], masks (M, H, W) bool) of the objects
        visible in frame k, in object order."""
        lab = self.labels[min(k, len(self.labels) - 1)]
        boxes, masks = [], []
        for j in range(len(self.spheres)):
            m = lab == j + 1
            if not m.any():
                continue
            ys, xs = np.nonzero(m)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
            masks.append(m)
        h, w = lab.shape
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.stack(masks) if masks else np.zeros((0, h, w), bool))

    def cache_key(self) -> dict:
        """Everything the renders depend on."""
        return {"camera": self.camera, "mix": {k: self.mix[k] for k in ("frames_per_drive", "trajectory", "world",
                                                                         "objects", "sensor")},
                "texture_seed": self.texture_seed, "generator": GENERATOR}


def load_or_render(drive: OrbitDrive) -> bool:
    """Fill drive.frames and drive.labels from the cache, or render them
    and store them. Returns True on a cache hit."""
    path = cache_path(drive.cache_key())
    if os.path.exists(path):
        with np.load(path) as z:
            drive.frames = [(f,) for f in z["frames"]]
            drive.labels = z["labels"]
        return True
    drive.render()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, frames=np.stack([f[0] for f in drive.frames]), labels=drive.labels)
    os.replace(tmp, path)
    return False
