"""End-to-end stereo object SLAM benchmark on a synthetic KITTI-like sequence.

Port of the stereo arm of dspslam_tpu/apps/benchmark_slam.py with its light
workload: a LayeredWorld street (KITTI intrinsics, 376 x 1241) driven along
a 0.3 m/frame trajectory with a 30-degree turn; static radius-1 spheres
beside the road and one lead-vehicle sphere at 0.5 m/frame; per-keyframe
detections derived from the ground truth; the analytic sphere decoder
(code 64); ORB at 2000 features and 8 levels; pipelined tracking, keyframe
work spread over the following frames (async keyframes, objects and local
BA) and camera-object edges in BA (`--ba_no_objects`: points-only BA, the
A/B arm).

It reports the mean frames/second over the steady-state frames first and
the median beside it (the JAX package's mono arm reported the median,
ROADMAP fault R4), ATE against the true trajectory, mesh chamfer against
the true spheres (live 33^3 meshes and 64^3 re-decodes), the static and
dynamic object errors, the local BA solves and the per-stage times.

    python -m dspslam_tpu_torch.apps.benchmark_slam [--frames 40] [--device cpu]

Not ported: the JAX benchmark's `full` workload (MaskRCNN + PointPillars
inside the loop, slice 6, and the decoder fit on spheres, slice 7), its
mono (slice 4) and long-loop (slice 5) arms, and its switches for the
synchronous and non-pipelined variants.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..datasets.synthetic import LayeredWorld, forward_turn_trajectory
from ..frontend import orb
from ..models import deepsdf
from ..objects.detections import Detection
from ..objects.pipeline import ObjectPipeline
from ..shape import gn
from ..shape import mesh as mesh_mod
from ..slam.local_mapping import LocalMapperConfig
from ..slam.system import SLAMSystem
from ..slam.tracking import TrackerConfig
from ..utils.evaluation import ate_rmse, chamfer_distance, sample_sphere
from ..utils.timing import StageTimer
from .reconstruct_frame import resolve_device

FX = FY = 707.0912
CX, CY = 601.8873, 183.1104
BF = 379.8145
H, W = 376, 1241
BASELINE_M = BF / FX
CODE_LEN = 64
RADIUS = 1.0
STEP = 0.3
TURN_DEG = 30.0
# the lead vehicle: 0.5 m/frame crosses the 1 m young-object motion gate
# (LocalMapping_util.cc:100-151) by its first re-observation
DYN_SPEED = 0.5


def build_world(seed=0, z_travel=15.0):
    """The turn world: the canvas covers the camera's z travel and the
    x reach of a 30-degree turn."""
    x_reach = max(9.0, 3.5 + z_travel * np.sin(np.radians(TURN_DEG)))
    return LayeredWorld(
        W, H, FX, cx=CX, cy=CY, depths=(55.0, 35.0, 20.0), coverage=(1.0, 0.30, 0.20),
        ground_height=1.65, max_ground_depth=55.0, x_range=(-2.0, x_reach), seed=seed,
        yaw_max=np.radians(TURN_DEG + 6.0), z_range=(0.0, z_travel),
    )


def make_benchmark_trajectory(n_frames):
    """Straight, a 30-degree arc, straight again (car-like)."""
    return forward_turn_trajectory(n_frames, step=STEP, turn_start=10, turn_frames=16,
                                   total_yaw=np.radians(TURN_DEG))


def place_spheres(traj):
    """Spheres ahead of the camera at every 8th trajectory anchor, sides
    alternating: 1-2 in view at any time through the turn."""
    out = []
    n = len(traj)
    for i, k in enumerate(range(2, n, 8)):
        T = traj[min(k, n - 1)]
        side = 4.5 if i % 2 == 0 else -4.5
        out.append(T[:3, 3] + T[:3, :3] @ np.array([side, 0.85, 13.0]))
    return np.asarray(out, np.float32)


def dynamic_sphere_traj(traj, n_frames):
    """A lead-vehicle sphere 16 m ahead of the first camera, driving
    straight at DYN_SPEED."""
    T0 = traj[0]
    fwd = T0[:3, :3] @ np.array([0.0, 0.0, 1.0])
    c0 = T0[:3, 3] + T0[:3, :3] @ np.array([1.8, 0.85, 16.0])
    return np.asarray([c0 + fwd * DYN_SPEED * k for k in range(n_frames + 2)], np.float32)


def make_detections(T_wc, spheres_w, rng):
    """GT-derived object measurements in the camera frame (full pose)."""
    R_cw = T_wc[:3, :3].T
    C = T_wc[:3, 3]
    dets = []
    for c_w in spheres_w:
        c = (R_cw @ (c_w - C)).astype(np.float32)
        if not (4.0 < c[2] < 35.0):
            continue
        if abs(c[0] / c[2]) > 0.8 or abs(c[1] / c[2]) > 0.45:
            continue
        d = rng.normal(size=(400, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        toc = -c / np.linalg.norm(c)
        d = d[(d @ toc) > 0.1][:250]
        pts = (c + RADIUS * d).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] *= 2.0
        T[:3, 3] = c + rng.normal(0, 0.05, 3)
        uv = pts[:, :2] / pts[:, 2:3]
        rays = np.concatenate([uv, np.ones((len(uv), 1))], -1).astype(np.float32)
        bg_dir = (c / np.linalg.norm(c))[None, :] + rng.normal(0, 0.3, (80, 3))
        bg_dir[:, 2] = np.abs(bg_dir[:, 2]) + 0.5
        bg = (bg_dir / bg_dir[:, 2:3]).astype(np.float32)[:60]
        dets.append(Detection(
            T_cam_obj=T, scale=2.0, box_size=np.full(3, 2.0, np.float32), surface_points=pts,
            rays=np.concatenate([rays, bg]), depth=pts[:, 2].copy(), num_foreground=len(rays),
        ))
    return dets


class GroundTruthDetections:
    """Per-keyframe detections fabricated from the ground truth: the static
    spheres and the lead vehicle at the keyframe's frame."""

    def __init__(self, traj, spheres_w, dyn_traj, rng):
        self.traj, self.spheres_w, self.dyn_traj, self.rng = traj, spheres_w, dyn_traj, rng
        self.calls = 0

    def __call__(self, idx):
        idx = min(idx, len(self.traj) - 1)
        self.calls += 1
        centers = np.vstack([self.spheres_w, self.dyn_traj[idx][None]])
        return make_detections(self.traj[idx], centers, self.rng)


def _mean_cm(values):
    return float(np.mean(values)) * 100 if values else None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--warmup", type=int, default=6, help="steady-state cutoff")
    p.add_argument("--ba_no_objects", action="store_true",
                   help="points-only local BA (object poses frozen at their GN measurements)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.frames <= args.warmup:
        args.warmup = max(args.frames // 2, 1)

    traj = make_benchmark_trajectory(args.frames + 1)
    world = build_world(z_travel=STEP * (args.frames + 2) + 1.0)
    spheres_w = place_spheres(traj)
    dyn_traj = dynamic_sphere_traj(traj, args.frames)
    t0 = time.perf_counter()
    host_imgs = [(np.clip(world.render_pose(T), 0, 255).astype(np.uint8),
                  np.clip(world.render_pose(T, BASELINE_M), 0, 255).astype(np.uint8)) for T in traj]
    print(f"sensor pregen: {len(traj)} frames, {time.perf_counter() - t0:.1f} s")

    decoder = deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=CODE_LEN, device=device))
    channel = GroundTruthDetections(traj, spheres_w, dyn_traj, np.random.default_rng(1))

    def pipeline_factory(slam_map):
        # 10 GN iterations; the pipeline calibrates the initial scale
        # against the decoder's zero-code surface radius
        return ObjectPipeline(slam_map, decoder, gn.GNConfig(code_len=CODE_LEN, k4=0.0, num_iterations=10),
                              max_detections=8, max_surface_points=256, max_rays=512,
                              extract_meshes=True, voxels_dim=33)

    system = SLAMSystem(
        tracker_cfg=TrackerConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, width=W, height=H,
                                  min_init_features=400, max_frames_between_kf=5,
                                  search_radius_motion=25.0, pipelined=True),
        orb_params=orb.ORBParams(n_features=2000, n_levels=8),
        object_pipeline_factory=pipeline_factory,
        detection_source=channel,
        local_mapper_cfg=LocalMapperConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, async_keyframe=True,
                                           async_objects=True, ba_objects=not args.ba_no_objects),
        device=device,
    )
    timer = StageTimer()
    system.attach_telemetry(timer)
    times = []
    for k in range(args.frames):
        if k == args.warmup:
            timer.samples.clear()    # the stage record covers the steady state only
        t0 = time.perf_counter()
        system.track_stereo(*host_imgs[k], k * 0.1)
        times.append(time.perf_counter() - t0)
    system.flush()

    steady = np.asarray(times[args.warmup:])
    fps_mean, fps_median = 1.0 / steady.mean(), 1.0 / np.median(steady)

    est, gt = [], []
    for ts, T_cw, lost in system.tracker.trajectory:
        if not lost:
            est.append(np.linalg.inv(T_cw.astype(np.float64)))
            gt.append(traj[int(round(ts / 0.1))])
    ate = ate_rmse(np.stack(est), np.stack(gt))
    lost = sum(1 for _, _, lost in system.tracker.trajectory if lost)
    travel = float(np.linalg.norm(np.diff(traj[: args.frames, :3, 3], axis=0), axis=1).sum())

    objs = [o for o in system.map.objects.values() if not o.bad]
    static = [o for o in objs if not o.dynamic]
    chamfers, refined = [], []
    for obj in static:
        if obj.vertices is not None and len(obj.vertices):
            v_w = obj.vertices @ obj.T_wo[:3, :3].T + obj.T_wo[:3, 3]
            c = spheres_w[np.argmin(np.linalg.norm(spheres_w - v_w.mean(0), axis=1))]
            chamfers.append(chamfer_distance(v_w, sample_sphere(c, RADIUS)))
        # the converged code re-decoded on a 64^3 grid (off the timed path)
        sdf = mesh_mod.decode_sdf_grid(decoder, decoder.w.new_tensor(obj.code[:CODE_LEN]), 64)
        verts, _ = mesh_mod.marching_tetrahedra(sdf.cpu().numpy())
        if len(verts):
            v_w = verts @ obj.T_wo[:3, :3].T + obj.T_wo[:3, 3]
            c = spheres_w[np.argmin(np.linalg.norm(spheres_w - v_w.mean(0), axis=1))]
            refined.append(chamfer_distance(v_w, sample_sphere(c, RADIUS)))
    static_errs = [float(np.min(np.linalg.norm(spheres_w - o.T_wo[:3, 3], axis=1))) for o in static]
    # the lead vehicle against its true position at its last measured frame
    dyn_errs = []
    for obj in objs:
        if obj.dynamic and obj.last_measured_kf_id in system.map.keyframes:
            frame_k = int(round(system.map.keyframes[obj.last_measured_kf_id].timestamp / 0.1))
            dyn_errs.append(float(np.linalg.norm(obj.T_wo_se3[:3, 3] - dyn_traj[min(frame_k, len(dyn_traj) - 1)])))
    pipeline = system.local_mapper.object_pipeline

    record = {
        "metric": "slam_fps_end_to_end", "value": float(fps_mean), "unit": "fps",
        "median_fps": float(fps_median),
        "mean_frame_ms": float(steady.mean()) * 1e3, "median_frame_ms": float(np.median(steady)) * 1e3,
        "max_frame_ms": float(steady.max()) * 1e3, "frame_ms_p95": float(np.percentile(steady, 95)) * 1e3,
        "device": str(device), "workload": "light", "frames": args.frames, "turn_deg": TURN_DEG,
        "lost_frames": lost, "travel_m": travel, "ate_rmse_cm": ate["rmse"] * 100,
        "ba_objects": not args.ba_no_objects,
        "mesh_chamfer_cm": _mean_cm(chamfers), "n_meshes": len(chamfers),
        "mesh_chamfer_refined_cm": _mean_cm(refined),
        "obj_center_err_cm": _mean_cm(static_errs), "static_obj_errs_m": static_errs,
        "n_objects": len(objs), "n_static": len(static),
        "dynamic_obj_err_cm": _mean_cm(dyn_errs), "dynamic_pred_err_cm": _mean_cm(pipeline.dyn_pred_errs),
        "n_dynamic": len(dyn_errs),
        "n_keyframes": len(system.map.keyframes), "n_points": len(system.map.points),
        "detector_calls": channel.calls,
        "ba_solves": system.local_mapper.ba_log, "ba_pt_cap_hits": system.local_mapper.ba_pt_cap_hits,
        "gn_dispatches": dict(pipeline.dispatches),
        "stage_ms": timer.summary_ms(),
    }
    print(f"state={system.state.name} kfs={record['n_keyframes']} pts={record['n_points']} "
          f"objs={len(objs)} ({len(static)} static) mesh_chamfer={record['mesh_chamfer_cm']} cm "
          f"over {len(chamfers)} meshes")
    print(f"mean frame {record['mean_frame_ms']:.1f} ms -> {fps_mean:.2f} fps "
          f"(median {record['median_frame_ms']:.1f} ms, {fps_median:.2f} fps) on {device}; "
          f"ATE RMSE {record['ate_rmse_cm']:.2f} cm through a {TURN_DEG:.0f} deg turn, {travel:.1f} m")
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
