"""End-to-end SLAM benchmarks on synthetic sequences: stereo object SLAM on
a KITTI-like street, and monocular SLAM at the Redwood / Freiburg camera
geometries (`--mono`).

Port of dspslam_tpu/apps/benchmark_slam.py. The stereo arm drives a
LayeredWorld street (KITTI intrinsics, 376 x 1241) along a 0.3 m/frame
trajectory with a 30-degree turn, with static radius-1 spheres beside the
road and one lead-vehicle sphere at 0.5 m/frame; ORB at 2000 features and 8
levels; pipelined tracking, keyframe work spread over the following frames
(async keyframes, objects and local BA; `--sync_kf`, `--sync_ba` turn that
off) and camera-object edges in BA (`--ba_no_objects`: points-only BA, the
A/B arm). Each frame's stereo pair is uploaded once, one frame ahead; the
tracker and the 2D detector take that upload.

`--workload full` (the default) pays, inside the measured loop, what the
reference pays per keyframe (kitti_sequence.py:101-109 runs both detectors
from Tracking.cc:1082-1101): Mask R-CNN on the keyframe's left image and
PointPillars on a ~60k-point synthetic velodyne scan (`make_velodyne_scan`),
both at full width with seeded random weights, dispatched at a keyframe and
collected at the next one (`DetectorChannel`); and object reconstruction
with the reference's DeepSDF architecture (64-code 8 x 512 latent-in MLP),
fitted to spheres at startup (`train_bench_decoder`, `--mlp_steps`), so the
10-iteration GN runs kernel K1 on trained weights and still converges to
verifiable geometry. The detections fed onward are derived from the ground
truth (random-weight detectors cannot localize; their cost is what the
measurement needs). `--workload legacy` keeps the analytic sphere decoder
and no detectors.

It reports the mean frames/second over the steady-state frames first and
the median beside it (the JAX package's mono arm reported the median,
ROADMAP fault R4), the p95 frame ms, ATE against the true trajectory, mesh
chamfer against the true spheres (live 33^3 meshes and 64^3 re-decodes),
the static and dynamic object errors, the local BA solves, the detector
dispatches and the per-stage times.

The mono arm (`main_mono`) tracks a LayeredWorld strafe whose view yaw
ramps 20 degrees mid-run, at the reference's mono settings (4000 features,
8 levels) and a profile's camera (`--mono_profile`: redwood 640 x 480,
fx 538.2, 15 fps; freiburg 960 x 540, fx 930.2, 25 fps; `--mono_downscale
N` divides both), pipelined tracking and async keyframes, no objects. It
reports the mean fps first and the median beside it, the p99 frame ms, the
per-stage times, the two-view initialization frame, the frames lost after
it and the ATE after Sim(3) alignment with the true trajectory (the mono
gauge); `--paced` feeds frames at the profile's rate, drops stale ones and
reports the drop rate.

The long-loop arm (`main_long_loop`, `--long_loop`) closes one loop on a
fabricated 201-keyframe street loop with a vocabulary trained in-process
and reports the ATE before and after the correction.

    python -m dspslam_tpu_torch.apps.benchmark_slam [--frames 56] [--workload legacy] [--device cpu]
    python -m dspslam_tpu_torch.apps.benchmark_slam --mono --mono_profile freiburg \
        [--frames 40] [--paced] [--no_pipeline] [--device cpu]
    python -m dspslam_tpu_torch.apps.benchmark_slam --long_loop [--device cpu]

Not ported (TPU or XLA workarounds): the decoder fit's /tmp cache, the BA
and object-GN bucket warm-up compiles (one call of each detector before the
measurement is kept), and in the mono arm the relay wire probe and the
second in-flight frame.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..datasets.street_loop import StreetLoopWorld
from ..datasets.synthetic import LayeredWorld, forward_turn_trajectory, render_poses, strafe_yaw_trajectory
from ..detect.maskrcnn import Detector2D
from ..detect.pointpillars import Detector3D
from ..frontend import orb
from ..models import deepsdf, deepsdf_train
from ..objects.detections import Detection
from ..objects.pipeline import ObjectPipeline
from ..place.loop_closing import LoopCloser
from ..place.vocabulary import Vocabulary
from ..shape import gn
from ..shape import mesh as mesh_mod
from ..slam.local_mapping import LocalMapperConfig
from ..slam.map import to_torch
from ..slam.system import SLAMSystem
from ..slam.tracking import TrackerConfig
from ..utils.evaluation import ate_rmse, chamfer_distance, sample_sphere
from ..utils import timing
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
# the reference's decoder architecture (deep_sdf_decoder.py:9-110), fitted
# to spheres at startup in the full workload
BENCH_DECODER = deepsdf.DecoderConfig(code_len=CODE_LEN, hidden=(512,) * 8, latent_in=(4,))

MONO_PROFILES = {
    # geometry and pacing of the reference's mono YAMLs (redwood_01053.yaml:
    # 640x480, fx 538 @ 15 fps; freiburg_001.yaml: 960x540, fx 930 @ 25 fps)
    "redwood": dict(w=640, h=480, fx=538.2, cx=320.0, cy=240.0, fps=15.0),
    "freiburg": dict(w=960, h=540, fx=930.2, cx=480.0, cy=270.0, fps=25.0),
}


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


def make_velodyne_scan(T_wc, world, spheres_w, rng):
    """KITTI-like scan in the velodyne frame (x forward, y left, z up):
    multi-beam ground rings, the world's plane layers as walls, sphere
    surfaces and clutter, ~60k points: a realistic pillar occupancy for the
    PointPillars cost (the reference feeds raw HDL-64 scans,
    detector3d.py:59-67). A numpy copy of the JAX package's: the same rng
    gives the same scan."""
    R_cw = T_wc[:3, :3].T
    C = T_wc[:3, 3]

    def cam_to_velo(pc):
        return np.stack([pc[:, 2], -pc[:, 0], -pc[:, 1]], -1)

    parts = []
    # ground rings: 44 beams x 720 azimuths over the front 160 degrees
    elevs = np.radians(np.linspace(-24.0, -2.1, 44))
    azims = np.radians(np.linspace(-80.0, 80.0, 720))
    ee, aa = np.meshgrid(elevs, azims, indexing="ij")
    r = np.minimum(1.65 / np.sin(-ee), 48.0)
    g = np.stack([r * np.cos(ee) * np.cos(aa), r * np.cos(ee) * np.sin(aa), r * np.sin(ee)], -1).reshape(-1, 3)
    parts.append(g[r.reshape(-1) < 47.9])
    # walls: the world's plane layers on a 0.25 m grid, relative to the camera
    for z_l in world.depths:
        xx, yy = np.meshgrid(np.arange(C[0] - 24.0, C[0] + 24.0, 0.25), np.arange(-2.6, 1.6, 0.25))
        Xw = np.stack([xx, yy, np.full_like(xx, z_l)], -1).reshape(-1, 3)
        pc = (Xw - C) @ R_cw.T
        parts.append(cam_to_velo(pc[pc[:, 2] > 1.0]))
    for c_w in spheres_w:
        d = rng.normal(size=(600, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pc = ((c_w + RADIUS * d) - C) @ R_cw.T
        parts.append(cam_to_velo(pc[pc[:, 2] > 1.0]))
    parts.append(np.stack([rng.uniform(0.0, 49.0, 3000), rng.uniform(-39.0, 39.0, 3000),
                           rng.uniform(-1.6, 0.9, 3000)], -1))
    pts = np.concatenate(parts).astype(np.float32)
    pts += rng.normal(0.0, 0.01, pts.shape).astype(np.float32)
    refl = rng.uniform(0.0, 1.0, (len(pts), 1)).astype(np.float32)
    return np.concatenate([pts, refl], -1)


def train_bench_decoder(steps: int, device):
    """BENCH_DECODER fitted to 5 spheres at startup (untimed; seed 0, batch
    8192). Returns (decoder, fit record)."""
    t0 = time.perf_counter()
    decoder, _, loss = deepsdf_train.fit_spheres(BENCH_DECODER, num_shapes=5, steps=steps, batch=8192, seed=0,
                                                 device=device)
    fit = {"steps": steps, "l1": loss, "seconds": time.perf_counter() - t0}
    print(f"decoder fit: {steps} steps, L1 {loss:.4f}, {fit['seconds']:.1f} s")
    return decoder, fit


def build_detectors(device):
    """Mask R-CNN and PointPillars at full width with seeded random weights."""
    return Detector2D(device=device), Detector3D(device=device)


class DetectorChannel:
    """Per-keyframe detector inference and GT-derived measurements (the
    reference's per-keyframe excursion into Python, Tracking.cc:1082-1101
    -> kitti_sequence.py:101-109). At a keyframe both networks are
    dispatched on its sensor data (the velodyne scan, the tracker's upload
    of the left image) and the previous keyframe's outputs are collected;
    the detections returned are fabricated from the ground truth. Without
    detectors it only fabricates."""

    def __init__(self, traj, spheres_w, dyn_traj, rng, scans=None, dev_imgs=None, det2d=None, det3d=None,
                 timer=None):
        self.traj, self.spheres_w, self.dyn_traj, self.rng = traj, spheres_w, dyn_traj, rng
        self.scans, self.dev_imgs, self.det2d, self.det3d = scans, dev_imgs, det2d, det3d
        self.timer = timer
        self.calls = 0
        self.detector_boxes = 0
        self._pending = None

    def _span(self, name, t0):
        if self.timer is not None:
            self.timer.add(name, time.perf_counter() - t0)

    def drain(self):
        """Finalize the previous keyframe's detector outputs: their compute
        and copies overlapped the frames in between."""
        if self._pending is None:
            return
        t0 = time.perf_counter()
        h3, h2 = self._pending
        self._pending = None
        if h3 is not None:
            self.detector_boxes += len(self.det3d.collect(h3))
        if h2 is not None:
            self.detector_boxes += len(self.det2d.collect(h2)["pred_boxes"])
        self._span("detector_collect", t0)

    def __call__(self, idx):
        idx = min(idx, len(self.traj) - 1)
        self.drain()
        t0 = time.perf_counter()
        h3 = self.det3d.dispatch(self.scans[idx]) if self.det3d is not None else None
        h2 = self.det2d.dispatch(self.dev_imgs[idx]) if self.det2d is not None else None
        centers = np.vstack([self.spheres_w, self.dyn_traj[idx][None]])
        dets = make_detections(self.traj[idx], centers, self.rng)
        self._pending = (h3, h2)
        self.calls += 1
        self._span("detector_dispatch", t0)
        return dets


def _mean_cm(values):
    return float(np.mean(values)) * 100 if values else None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--warmup", type=int, default=None,
                   help="steady-state cutoff; default 18 in the full workload (its first keyframes "
                        "fill the detectors' and the GN's working sets), else 6")
    p.add_argument("--workload", choices=("full", "legacy"), default="full",
                   help="full = both detectors and the fitted DeepSDF decoder inside the measured "
                        "loop; legacy = GT-derived detections and the analytic sphere decoder only")
    p.add_argument("--mlp_steps", type=int, default=600, help="startup decoder-fit steps (full workload)")
    p.add_argument("--no_objects", action="store_true", help="no object pipeline and no detections")
    p.add_argument("--sync_ba", action="store_true", help="apply local BA at each keyframe")
    p.add_argument("--async_kf", action="store_true", default=True,
                   help="spread each keyframe's work over the following frames (the default; --sync_kf "
                        "turns it off)")
    p.add_argument("--sync_kf", dest="async_kf", action="store_false",
                   help="process each keyframe whole at the frame that created it")
    p.add_argument("--ba_no_objects", action="store_true",
                   help="points-only local BA (object poses frozen at their GN measurements)")
    p.add_argument("--no_pipeline", action="store_true", help="non-pipelined tracking")
    p.add_argument("--mono", action="store_true",
                   help="the monocular arm at the reference's mono settings (4000 features)")
    p.add_argument("--mono_profile", choices=tuple(MONO_PROFILES), default="redwood",
                   help="camera geometry and pacing: redwood 640x480 @ 15 fps, "
                        "freiburg 960x540 @ 25 fps")
    p.add_argument("--mono_downscale", type=int, default=1,
                   help="mono at 1/N resolution, intrinsics scaled to match")
    p.add_argument("--paced", action="store_true",
                   help="mono: frames arrive at the profile's rate and stale ones are "
                        "dropped (dsp_slam_mono.cc:80-95); reports the drop rate")
    p.add_argument("--long_loop", action="store_true",
                   help="loop closing on a fabricated street loop of max(2 frames + 1, 201) "
                        "keyframes: ATE before vs after the correction")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.long_loop:
        return main_long_loop(args, device)
    if args.mono:
        if args.warmup is None:
            args.warmup = 6
        return main_mono(args, device)
    full = args.workload == "full" and not args.no_objects
    if args.warmup is None:
        args.warmup = 18 if full else 6
    if args.frames <= args.warmup:
        args.warmup = max(args.frames // 2, 1)

    traj = make_benchmark_trajectory(args.frames + 1)
    world = build_world(z_travel=STEP * (args.frames + 2) + 1.0)
    spheres_w = place_spheres(traj)
    dyn_traj = dynamic_sphere_traj(traj, args.frames)
    rng = np.random.default_rng(1)
    # the sensor data the reference reads from disk (dsp_slam.cc:62-75)
    t0 = time.perf_counter()
    host_imgs = render_poses(lambda T: (np.clip(world.render_pose(T), 0, 255).astype(np.uint8),
                                        np.clip(world.render_pose(T, BASELINE_M), 0, 255).astype(np.uint8)), traj)
    scans = [make_velodyne_scan(T, world, np.vstack([spheres_w, dyn_traj[k][None]]), rng)
             for k, T in enumerate(traj)] if full else None
    print(f"sensor pregen: {len(traj)} frames" + (f" + scans ({len(scans[0])} points)" if full else "")
          + f", {time.perf_counter() - t0:.1f} s")

    fit = None
    if full:
        decoder, fit = train_bench_decoder(args.mlp_steps, device)
        det2d, det3d = build_detectors(device)
    else:
        decoder = deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=CODE_LEN, device=device))
        det2d = det3d = None
    timer = StageTimer()
    dev_imgs = {}

    def upload(k):
        # one upload per frame, one frame ahead; Mask R-CNN takes the
        # tracker's copy of a keyframe's left image (a keyframe surfaces at
        # most one call late, so the last few frames' copies are kept)
        t0 = time.perf_counter()
        pair = tuple(to_torch(img, device) for img in host_imgs[k])
        dev_imgs[k] = pair[0]
        dev_imgs.pop(k - 4, None)
        timer.add("upload_enqueue", time.perf_counter() - t0)
        return pair

    channel = None if args.no_objects else DetectorChannel(
        traj, spheres_w, dyn_traj, rng, scans=scans, dev_imgs=dev_imgs, det2d=det2d, det3d=det3d, timer=timer)

    def pipeline_factory(slam_map):
        # 10 GN iterations; the pipeline calibrates the initial scale
        # against the decoder's zero-code surface radius
        return ObjectPipeline(slam_map, decoder, gn.GNConfig(code_len=CODE_LEN, k4=0.0, num_iterations=10),
                              max_detections=8, max_surface_points=256, max_rays=512,
                              extract_meshes=True, voxels_dim=33)

    system = SLAMSystem(
        tracker_cfg=TrackerConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, width=W, height=H,
                                  min_init_features=400, max_frames_between_kf=5,
                                  search_radius_motion=25.0, pipelined=not args.no_pipeline),
        orb_params=orb.ORBParams(n_features=2000, n_levels=8),
        object_pipeline_factory=None if args.no_objects else pipeline_factory,
        detection_source=channel,
        local_mapper_cfg=LocalMapperConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, async_ba=not args.sync_ba,
                                           async_keyframe=args.async_kf, async_objects=args.async_kf,
                                           ba_objects=not args.ba_no_objects),
        device=device,
    )
    if full:
        # one call of each detector before the measurement (the JAX package
        # compiled them there); its dispatches are not counted
        t0 = time.perf_counter()
        det3d.make_prediction(scans[0])
        det2d.make_prediction(to_torch(host_imgs[0][0], device))
        det2d.dispatches = det3d.dispatches = 0
        print(f"detector warm-up: {time.perf_counter() - t0:.1f} s")
    previous_sink = system.attach_telemetry(timer)
    times = []
    pair = upload(0)
    for k in range(args.frames):
        if k == args.warmup:
            timer.clear()    # the stage record covers the steady state only
        next_pair = upload(k + 1) if k + 1 < args.frames else None
        t0 = time.perf_counter()
        system.track_stereo(*pair, k * 0.1)
        times.append(time.perf_counter() - t0)
        pair = next_pair
    system.flush()
    if channel is not None:
        channel.drain()
    timing.attach(previous_sink)

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

    all_objs = list(system.map.objects.values())
    objs = [o for o in all_objs if not o.bad]
    static = [o for o in objs if not o.dynamic]
    skipped = {"bad": len(all_objs) - len(objs), "dynamic": len(objs) - len(static), "no_mesh": 0, "empty": 0}
    chamfers, refined = [], []
    for obj in static:
        if obj.vertices is None:
            skipped["no_mesh"] += 1
        elif not len(obj.vertices):
            skipped["empty"] += 1
        else:
            v_w = obj.vertices @ obj.T_wo[:3, :3].T + obj.T_wo[:3, 3]
            c = spheres_w[np.argmin(np.linalg.norm(spheres_w - v_w.mean(0), axis=1))]
            chamfers.append(chamfer_distance(v_w, sample_sphere(c, RADIUS)))
        # the converged code re-decoded on a 64^3 grid (off the timed path):
        # a missing live mesh does not skip it
        code = torch.as_tensor(np.asarray(obj.code[:CODE_LEN], np.float32), device=device)
        verts, _ = mesh_mod.marching_tetrahedra(mesh_mod.decode_sdf_grid(decoder, code, 64).cpu().numpy())
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
        "median_fps": float(fps_median), "vs_baseline": float(fps_mean) / 10.0,
        "mean_frame_ms": float(steady.mean()) * 1e3, "median_frame_ms": float(np.median(steady)) * 1e3,
        "max_frame_ms": float(steady.max()) * 1e3, "frame_ms_p95": float(np.percentile(steady, 95)) * 1e3,
        "device": str(device), "workload": "detectors+mlp" if full else "legacy", "frames": args.frames,
        "warmup": args.warmup, "turn_deg": TURN_DEG,
        "lost_frames": lost, "travel_m": travel, "ate_rmse_cm": ate["rmse"] * 100,
        "ba_objects": not args.ba_no_objects,
        "mesh_chamfer_cm": _mean_cm(chamfers), "n_meshes": len(chamfers), "meshes_skipped": skipped,
        "mesh_chamfer_refined_cm": _mean_cm(refined),
        "obj_center_err_cm": _mean_cm(static_errs), "static_obj_errs_m": static_errs,
        "n_objects": len(objs), "n_static": len(static),
        "dynamic_obj_err_cm": _mean_cm(dyn_errs),
        "dynamic_pred_err_cm": _mean_cm(pipeline.dyn_pred_errs) if pipeline is not None else None,
        "n_dynamic": len(dyn_errs),
        "n_keyframes": len(system.map.keyframes), "n_points": len(system.map.points),
        "n_redone": system.tracker.n_redone,
        "detector_calls": channel.calls if channel is not None else 0,
        "detector_dispatches": {"maskrcnn": det2d.dispatches, "pointpillars": det3d.dispatches} if full else None,
        "detector_boxes": channel.detector_boxes if channel is not None else 0,
        "decoder_fit": fit,
        "ba_solves": system.local_mapper.ba_log, "ba_pt_cap_hits": system.local_mapper.ba_pt_cap_hits,
        "gn_dispatches": dict(pipeline.dispatches) if pipeline is not None else None,
        "expected_k1_launches": pipeline.expected_k1_launches() if pipeline is not None else 0,
        "stage_ms": timer.summary_ms(), "counts": dict(timer.counts),
    }
    print(f"state={system.state.name} kfs={record['n_keyframes']} pts={record['n_points']} "
          f"objs={len(objs)} ({len(static)} static) detector_calls={record['detector_calls']} "
          f"mesh_chamfer={record['mesh_chamfer_cm']} cm over {len(chamfers)} meshes")
    print(f"mean frame {record['mean_frame_ms']:.1f} ms -> {fps_mean:.2f} fps "
          f"(median {record['median_frame_ms']:.1f} ms, {fps_median:.2f} fps) on {device}; "
          f"ATE RMSE {record['ate_rmse_cm']:.2f} cm through a {TURN_DEG:.0f} deg turn, {travel:.1f} m")
    print(json.dumps(record))
    return record


def main_long_loop(args, device, street_len=None):
    """Long-sequence loop benchmark (the JAX package's `main_long_loop`): a
    fabricated street loop (datasets.street_loop) with 1%-per-step odometry
    drift, driven through the loop-closing stack (BoW detection, Sim(3)
    RANSAC and refinement, essential graph, backgrounded global BA) on
    `device`. Reports the ATE RMSE before and after the correction.
    `street_len` overrides the street length (tests run it small)."""
    n_kf = max(2 * args.frames + 1, 201)
    world = StreetLoopWorld(street_len=(n_kf - 1) // 2 if street_len is None else street_len)
    t0 = time.perf_counter()
    slam_map, kfs, truth = world.build()
    print(f"street-loop map: {len(kfs)} KFs, {len(slam_map.points)} points, "
          f"{time.perf_counter() - t0:.1f} s")
    voc = Vocabulary.train(world.lmk_desc, branching=6, levels=2, seed=1, device=device)
    closer = LoopCloser(slam_map, voc, [world.fx, world.fy, world.cx, world.cy, world.fx * 0.4],
                        fix_scale=True, min_matches=12, device=device)
    err_before = None
    snap_id = kfs[-(world.revisit_len + 1)].id
    t0 = time.perf_counter()
    for kf in kfs:
        closer.insert_keyframe(kf)
        if err_before is None and kf.id == snap_id:
            err_before = world.pose_errors(slam_map, kfs, truth)
    closer.flush()
    loop_wall_s = time.perf_counter() - t0
    err_after = world.pose_errors(slam_map, kfs, truth)
    ate_before = float(np.sqrt(np.mean(err_before ** 2)))
    ate_after = float(np.sqrt(np.mean(err_after ** 2)))
    print(f"loops_closed={closer.loops_closed} ATE RMSE {ate_before * 100:.1f} -> "
          f"{ate_after * 100:.1f} cm over {len(kfs)} KFs ({truth.max():.0f} m out-and-back, "
          f"{loop_wall_s:.1f} s wall)")
    record = {
        "metric": "loop_ate_rmse_cm", "value": ate_after * 100, "unit": "cm",
        "vs_baseline": ate_before / max(ate_after, 1e-9),
        "ate_before_loop_cm": ate_before * 100, "ate_after_loop_cm": ate_after * 100,
        "loop_kfs": len(kfs), "loops_closed": closer.loops_closed, "loop_wall_s": loop_wall_s,
        "device": str(device),
    }
    print(json.dumps(record))
    return record


def mono_sequence(profile: str, frames: int, downscale: int = 1):
    """The mono arm's world, camera and trajectory: a strafe at STEP m per
    frame whose view yaw ramps 20 degrees over the middle third. Returns
    (world, (w, h, fx, cx, cy), poses (frames + 1, 4, 4) camera-to-world)."""
    prof = MONO_PROFILES[profile]
    ds = max(downscale, 1)
    cam = (prof["w"] // ds, prof["h"] // ds, prof["fx"] / ds, prof["cx"] / ds, prof["cy"] / ds)
    w, h, fx, cx, cy = cam
    world = LayeredWorld(w, h, fx, cx=cx, cy=cy, depths=(25.0, 12.0, 7.0), ground_height=1.65,
                         x_range=(-1.0, STEP * (frames + 2)), seed=0, yaw_max=np.radians(24.0))
    poses = strafe_yaw_trajectory(frames + 1, step=STEP, yaw_start=max(6, frames // 3),
                                  yaw_frames=max(8, frames // 3), total_yaw=np.radians(20.0))
    return world, cam, poses


def mono_system(cam, pipelined: bool, device) -> SLAMSystem:
    """The mono arm's SLAMSystem for a camera (w, h, fx, cx, cy): ORB at 4000
    features and 8 levels, keyframe work spread over the following frames,
    no objects."""
    w, h, fx, cx, cy = cam
    return SLAMSystem(
        tracker_cfg=TrackerConfig(fx=fx, fy=fx, cx=cx, cy=cy, bf=fx * 0.5, width=w, height=h,
                                  min_init_features=400, max_frames_between_kf=5,
                                  search_radius_motion=25.0, pipelined=pipelined),
        orb_params=orb.ORBParams(n_features=4000, n_levels=8),
        local_mapper_cfg=LocalMapperConfig(fx=fx, fy=fx, cx=cx, cy=cy, bf=fx * 0.5, async_ba=True,
                                           async_keyframe=True),
        device=device,
    )


def main_mono(args, device):
    """Monocular throughput and accuracy at the reference's mono settings
    (4000 features, 8 levels, a Redwood or Freiburg camera; pacing targets
    15 and 25 fps). Objects off: mono objects reconstruct every ~5th
    keyframe from accumulated map points."""
    pace = MONO_PROFILES[args.mono_profile]["fps"]
    world, cam, traj = mono_sequence(args.mono_profile, args.frames, args.mono_downscale)
    w, h, fx = cam[:3]
    system = mono_system(cam, not args.no_pipeline, device)
    t0 = time.perf_counter()
    host_imgs = render_poses(lambda T: np.clip(world.render_pose(T), 0, 255).astype(np.uint8), traj)
    print(f"sensor pregen: {len(traj)} frames at {w}x{h}, {time.perf_counter() - t0:.1f} s")
    timer = StageTimer()
    previous_sink = system.attach_telemetry(timer)
    times, dropped = [], 0
    dt = 1.0 / pace if args.paced else 0.1
    if args.paced:
        # real-time camera pacing with stale-frame dropping: frame k arrives
        # at k / pace; a frame the tracker reaches after the next arrival is
        # skipped (the reference's main-loop pacing)
        system.track_mono(host_imgs[0], 0.0)
        t_origin = time.perf_counter()
        for k in range(1, args.frames):
            now = time.perf_counter() - t_origin
            if now > (k + 1) * dt:
                dropped += 1
                continue
            if now < k * dt:
                time.sleep(k * dt - now)
            if len(times) == args.warmup:
                timer.clear()    # steady-state stages only
            t0 = time.perf_counter()
            system.track_mono(host_imgs[k], k * dt)
            times.append(time.perf_counter() - t0)
    else:
        for k in range(args.frames):
            if k == args.warmup:
                timer.clear()    # steady-state stages only
            t0 = time.perf_counter()
            system.track_mono(host_imgs[k], k * dt)
            times.append(time.perf_counter() - t0)
    system.flush()
    timing.attach(previous_sink)

    steady = np.asarray(times[args.warmup:] if len(times) > args.warmup else times)
    fps_mean, fps_median = 1.0 / steady.mean(), 1.0 / np.median(steady)
    entries = [(int(round(ts / dt)), T_cw, lost) for ts, T_cw, lost in system.tracker.trajectory]
    tracked = [k for k, _, lost in entries if not lost]
    init_frame = tracked[0] if tracked else None
    lost_after = sum(1 for k, _, lost in entries if lost and init_frame is not None and k > init_frame)
    travel = float(np.linalg.norm(np.diff(traj[: args.frames, :3, 3], axis=0), axis=1).sum())
    ate = None
    if len(tracked) >= 3:
        est = np.stack([np.linalg.inv(T.astype(np.float64)) for _, T, lost in entries if not lost])
        ate = ate_rmse(est, traj[tracked], scale=True)["rmse"]
    record = {
        "metric": f"mono_slam_fps_{args.mono_profile}", "value": float(fps_mean), "unit": "fps",
        "median_fps": float(fps_median), "vs_pace": float(fps_mean / pace),
        "mean_frame_ms": float(steady.mean()) * 1e3, "median_frame_ms": float(np.median(steady)) * 1e3,
        "frame_ms_p99": float(np.percentile(steady, 99)) * 1e3, "max_frame_ms": float(steady.max()) * 1e3,
        "device": str(device), "profile": args.mono_profile, "width": w, "height": h, "fx": fx,
        "frames": args.frames, "frames_tracked": len(entries), "pipelined": not args.no_pipeline,
        "init_frame": init_frame, "lost_after_init": lost_after,
        "travel_m": travel, "ate_rmse_cm": None if ate is None else ate * 100,
        "ate_frac_of_travel": None if ate is None else ate / travel,
        "n_keyframes": len(system.map.keyframes), "n_points": len(system.map.points),
        "n_redone": system.tracker.n_redone, "stage_ms": timer.summary_ms(), "counts": dict(timer.counts),
    }
    if args.mono_downscale > 1:
        record["downscale"] = args.mono_downscale
    if args.paced:
        record["drop_rate"] = dropped / max(args.frames - 1, 1)
    print(f"state={system.state.name} kfs={record['n_keyframes']} pts={record['n_points']}; "
          f"initialized at frame {init_frame}, {lost_after} lost after it; ATE (Sim(3)-aligned) "
          f"{record['ate_rmse_cm']} cm over {travel:.2f} m")
    drop_note = f", dropped {dropped}/{args.frames - 1} at {pace:.0f} fps pacing" if args.paced else ""
    print(f"mean frame {record['mean_frame_ms']:.1f} ms -> {fps_mean:.2f} fps (median "
          f"{record['median_frame_ms']:.1f} ms, {fps_median:.2f} fps; {args.mono_profile} {w}x{h}, "
          f"pacing target {pace:.0f} fps{drop_note}) on {device}")
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
