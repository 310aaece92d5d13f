"""The SLAM cells' traffic: drives through the synthetic street, their
sensor data and their object measurements.

Frozen copies, in numpy, of the generators of
dspslam_tpu_torch/apps/benchmark_slam.py at commit d92c068: the turn world
(`build_world`), the car-like and the strafing trajectories, the sphere
placement, the lead vehicle, the ground-truth-derived detections (`make_detections`, here as plain dicts and upright) and the mono
arm's world. Every size and rate comes from a traffic mix file
(benchmark/traffic/<mix>.json), so a new mix is a new data file.
"""

from __future__ import annotations

import numpy as np

from .world import LayeredWorld, forward_turn_trajectory, render_poses, strafe_yaw_trajectory

# an object frame with +y up in the camera frame (y down): a 180-degree turn about x
UPRIGHT = np.array([1.0, -1.0, -1.0], np.float32)


def trajectory(spec: dict, n: int) -> np.ndarray:
    """(n, 4, 4) camera-to-world poses of a mix's `trajectory` entry."""
    if spec["type"] == "forward_turn":
        return forward_turn_trajectory(n, step=spec["step"], turn_start=spec["turn_start"],
                                       turn_frames=spec["turn_frames"], total_yaw=np.radians(spec["turn_deg"]))
    if spec["type"] == "strafe_yaw":
        return strafe_yaw_trajectory(n, step=spec["step"], yaw_start=spec["yaw_start"],
                                     yaw_frames=spec["yaw_frames"], total_yaw=np.radians(spec["yaw_deg"]))
    raise ValueError(f"unknown trajectory type {spec['type']!r}")


def build_world(camera: dict, mix: dict, texture_seed: int) -> LayeredWorld:
    """The mix's layered world for `camera`, with canvases that cover the
    drive: a forward drive reaches z by its travel and x by its turn, a
    strafe reaches x by its travel."""
    spec, tr, n = mix["world"], mix["trajectory"], mix["frames_per_drive"]
    if tr["type"] == "forward_turn":
        z_travel = tr["step"] * (n + 2) + 1.0
        x_range = (-2.0, max(9.0, 3.5 + z_travel * np.sin(np.radians(tr["turn_deg"]))))
        z_range = (0.0, z_travel)
    else:
        x_range, z_range = (-1.0, tr["step"] * (n + 2)), (0.0, 0.0)
    return LayeredWorld(
        camera["width"], camera["height"], camera["fx"], cx=camera["cx"], cy=camera["cy"],
        depths=tuple(spec["depths"]), coverage=tuple(spec["coverage"]), ground_height=spec["ground_height"],
        max_ground_depth=spec["max_ground_depth"], x_range=x_range, seed=texture_seed,
        yaw_max=np.radians(spec["yaw_max_deg"]), z_range=z_range,
    )


def place_spheres(traj: np.ndarray, spec: dict) -> np.ndarray:
    """Static spheres ahead of the camera at every `every`-th pose from
    `first`, sides alternating."""
    out, n = [], len(traj)
    side, up, ahead = spec["offset"]
    for i, k in enumerate(range(spec["first"], n, spec["every"])):
        T = traj[min(k, n - 1)]
        out.append(T[:3, 3] + T[:3, :3] @ np.array([side if i % 2 == 0 else -side, up, ahead]))
    return np.asarray(out, np.float32).reshape(-1, 3)


def lead_vehicle(traj: np.ndarray, spec: dict, n: int) -> np.ndarray:
    """A lead-vehicle sphere ahead of the first camera, driving straight."""
    T0 = traj[0]
    fwd = T0[:3, :3] @ np.array([0.0, 0.0, 1.0])
    c0 = T0[:3, 3] + T0[:3, :3] @ np.asarray(spec["offset"], np.float64)
    return np.asarray([c0 + fwd * spec["speed"] * k for k in range(n + 2)], np.float32)


def make_detections(T_wc, centers_w, radius: float, rng) -> list[dict]:
    """Ground-truth-derived object measurements in the camera frame: for
    each sphere in view, up to 250 surface points on its camera-facing
    side, an upright 2x-scaled pose with 5 cm of noise, foreground rays
    with depths and 60 background rays."""
    R_cw, C = T_wc[:3, :3].T, T_wc[:3, 3]
    dets = []
    for c_w in centers_w:
        c = (R_cw @ (c_w - C)).astype(np.float32)
        if not (4.0 < c[2] < 35.0) or abs(c[0] / c[2]) > 0.8 or abs(c[1] / c[2]) > 0.45:
            continue
        d = rng.normal(size=(400, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = d[(d @ (-c / np.linalg.norm(c))) > 0.1][:250]
        pts = (c + radius * d).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        # upright: the object's +y axis is the camera's -y, as a detector's
        # boxes give it, so the GN's rotation prior starts satisfied (the
        # frozen original used the identity rotation, which that prior
        # pushes against at its largest)
        T[:3, :3] = 2.0 * np.diag(UPRIGHT)
        T[:3, 3] = c + rng.normal(0, 0.05, 3)
        uv = pts[:, :2] / pts[:, 2:3]
        rays = np.concatenate([uv, np.ones((len(uv), 1))], -1).astype(np.float32)
        bg_dir = (c / np.linalg.norm(c))[None, :] + rng.normal(0, 0.3, (80, 3))
        bg_dir[:, 2] = np.abs(bg_dir[:, 2]) + 0.5
        bg = (bg_dir / bg_dir[:, 2:3]).astype(np.float32)[:60]
        dets.append({"T_cam_obj": T, "scale": 2.0, "box_size": np.full(3, 2.0, np.float32), "surface_points": pts,
                     "rays": np.concatenate([rays, bg]), "depth": pts[:, 2].copy(), "num_foreground": len(rays)})
    return dets


class Drive:
    """One variant of a mix's drive: its poses, world, objects and sensor
    data. `render()` fills `frames` ((left, right) or (image,) uint8 per
    frame)."""

    def __init__(self, camera: dict, mix: dict, texture_seed: int):
        n = mix["frames_per_drive"]
        self.camera, self.mix, self.texture_seed = camera, mix, texture_seed
        self.traj = trajectory(mix["trajectory"], n + 1)
        self.world = build_world(camera, mix, texture_seed)
        obj = mix.get("objects")
        self.spheres = place_spheres(self.traj, obj["static"]) if obj else np.zeros((0, 3), np.float32)
        self.lead = lead_vehicle(self.traj, obj["lead"], n) if obj and obj.get("lead") else None
        self.radius = obj["radius"] if obj else 1.0
        self.frames = None

    def centers(self, k: int) -> np.ndarray:
        k = min(k, len(self.traj) - 1)
        return self.spheres if self.lead is None else np.vstack([self.spheres, self.lead[k][None]])

    def render(self):
        baseline = self.camera.get("baseline_fx", 0.0) / self.camera["fx"]
        stereo = self.mix["sensor"] == "stereo"

        def shot(T):
            left = np.clip(self.world.render_pose(T), 0, 255).astype(np.uint8)
            if not stereo:
                return (left,)
            return left, np.clip(self.world.render_pose(T, baseline), 0, 255).astype(np.uint8)

        self.frames = render_poses(shot, self.traj)

    def cache_key(self) -> dict:
        """Everything the renders depend on."""
        return {"camera": self.camera, "mix": {k: self.mix[k] for k in ("frames_per_drive", "trajectory", "world",
                                                                         "sensor")},
                "objects": self.mix.get("objects"), "texture_seed": self.texture_seed, "generator": "scene.py@d92c068"}
