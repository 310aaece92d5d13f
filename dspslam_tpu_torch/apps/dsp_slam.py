"""Stereo+LiDAR object SLAM CLI, the dsp_slam.cc equivalent.

Port of dspslam_tpu/apps/dsp_slam.py. Usage:

    python -m dspslam_tpu_torch.apps.dsp_slam \\
        --sequence_dir <kitti_seq> --settings configs/KITTI04-12.yaml \\
        --config configs/config_kitti.json --map_dir out/map \\
        [--frames N] [--no_objects] [--pipeline] [--vocabulary voc.npz [--no_loop]] \
        [--save_state map.npz] [--overlay_dir ov/] [--live_view_dir live/ [--live_view_port 8000]] \
        [--device cpu]

The per-frame loop mirrors dsp_slam.cc:62-105: track stereo, feed each
keyframe its object detections (the online MaskRCNN and PointPillars on
`--device` when the config says `detect_online`, at the settings of its
detection section's `detector_2d` / `detector_3d` blocks, else offline
labels), save the map and the
trajectory at the end, print median / mean tracking times. `--device`
defaults to cuda; asking for cuda without a card is an error, never a
silent run on the CPU. `--profile_dir` writes a torch.profiler trace.
`--vocabulary` (a trained .npz, or a DBoW2 ORBvoc .bin / .txt) attaches
relocalization after tracking loss and, unless `--no_loop`, loop closing;
`--save_state` writes a resumable map checkpoint (slam/state_io.py).
`--overlay_dir` writes each finished frame's tracking overlay as a PNG
(viz/frame_drawer.py; under `--pipeline` a frame finishes one call late);
`--live_view_dir` refreshes a live view there every `--live_view_every`
frames (viz/live_viewer.py, matplotlib), served over HTTP on 127.0.0.1 with
`--live_view_port`. The JAX app's map snapshot image (matplotlib) is not
written: `apps/visualize_map.py` draws one from the saved map.
"""

from __future__ import annotations

import argparse
import os

from .. import config as cfg_mod
from ..datasets.kitti import KITTISequence
from ..frontend import orb
from ..objects.pipeline import ObjectPipeline
from ..slam.system import SLAMSystem
from ..slam.tracking import TrackerConfig
from ..utils.timing import StageTimer
from .reconstruct_frame import get_decoder, resolve_device

def build_system(system_cfg: cfg_mod.SystemConfig, sequence, enable_objects=True, pipelined=False,
                 device=None, vocabulary=None, enable_loop=True):
    """The SLAMSystem dsp_slam.cc builds from a SystemConfig: tracker and
    ORB settings from the camera and ORB sections, the object pipeline on
    the configured DeepSDF decoder (the analytic sphere decoder when no
    experiment dir is configured), the sequence's detections per keyframe;
    with a vocabulary, relocalization and (enable_loop) loop closing.
    device None means cuda."""
    device = resolve_device("cuda" if device is None else str(device))
    cam = system_cfg.camera
    tracker_cfg = TrackerConfig(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.baseline_fx,
        width=cam.width, height=cam.height, th_depth=cam.depth_threshold,
        max_frames_between_kf=int(cam.fps),
        dist_coeffs=(cam.k1, cam.k2, cam.p1, cam.p2, cam.k3),
        pipelined=pipelined,
    )
    orb_params = orb.ORBParams(
        n_features=system_cfg.orb.n_features, scale_factor=system_cfg.orb.scale_factor,
        n_levels=system_cfg.orb.n_levels, fast_threshold=system_cfg.orb.ini_th_fast,
        min_threshold=system_cfg.orb.min_th_fast,
    )
    pipeline_factory = None
    if enable_objects:
        decoder = get_decoder(system_cfg, device)
        d = system_cfg.detection

        def pipeline_factory(slam_map):
            return ObjectPipeline(
                slam_map, decoder, system_cfg.optimizer, max_detections=d.max_detections,
                max_surface_points=d.max_surface_points, max_rays=d.max_rays,
                voxels_dim=system_cfg.voxels_dim,
            )

    detection_source = None
    if enable_objects and sequence is not None and sequence.det_cfg is not None:
        image_hw = (cam.height, cam.width)

        def detection_source(frame_idx):
            try:
                return sequence.get_frame_detections(frame_idx, image_hw)
            except FileNotFoundError:
                return []

    system = SLAMSystem(tracker_cfg=tracker_cfg, orb_params=orb_params,
                        object_pipeline_factory=pipeline_factory,
                        detection_source=detection_source, device=device)
    if vocabulary is not None:
        if enable_loop:
            system.enable_loop_closing(vocabulary, fix_scale=True)
        else:
            system.attach_vocabulary(vocabulary)
    return system


def write_overlay(out_dir: str, system, frame, recent: dict):
    """The FrameDrawer overlay of a finished frame as <frame id>.png."""
    if frame is None:
        return
    fid, img = recent.get(round(float(frame.timestamp), 6), (None, None))
    if fid is None:
        return
    from PIL import Image

    from ..viz import frame_drawer

    os.makedirs(out_dir, exist_ok=True)
    overlay = frame_drawer.draw_frame(img, frame.feats, frame.map_point_ids, state=system.state.name)
    Image.fromarray(overlay).save(os.path.join(out_dir, f"{fid:06d}.png"))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sequence_dir", required=True)
    p.add_argument("--settings", help="per-sequence YAML (reference format)")
    p.add_argument("--config", help="dataset JSON (reference format)")
    p.add_argument("--map_dir", default="map")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--no_objects", action="store_true")
    p.add_argument("--no_loop", action="store_true",
                   help="with --vocabulary: relocalization only, no loop closing")
    p.add_argument("--vocabulary", help="trained vocabulary .npz, or a DBoW2 ORBvoc .bin / .txt")
    p.add_argument("--profile_dir", help="write a torch.profiler trace here")
    p.add_argument("--save_state", help="write a resumable map checkpoint (npz) here")
    p.add_argument("--overlay_dir", help="write each finished frame's tracking overlay here (PNG)")
    p.add_argument("--save_frames_dir",
                   help="per-frame map dumps (System::SaveMapCurrentFrame format)")
    p.add_argument("--save_frames_every", type=int, default=1)
    p.add_argument("--pipeline", action="store_true",
                   help="one-frame-lag pipelined tracking")
    p.add_argument("--live_view_dir", help="refresh a live map + frame view here (map.png, frame.png, index.html)")
    p.add_argument("--live_view_port", type=int, default=None,
                   help="also serve --live_view_dir over HTTP on 127.0.0.1 (an auto-refreshing page)")
    p.add_argument("--live_view_every", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.live_view_port is not None and not args.live_view_dir:
        p.error("--live_view_port needs --live_view_dir")
    device = resolve_device(args.device)

    system_cfg = cfg_mod.SystemConfig.load(args.config) if args.config else cfg_mod.SystemConfig()
    if args.settings:
        system_cfg = cfg_mod.SystemConfig.from_reference_yaml(args.settings, base=system_cfg)
    # the detection section carries the detectors' settings to get_detectors
    seq = KITTISequence(args.sequence_dir, system_cfg.detection, device=device)
    voc = None
    if args.vocabulary:
        from ..place.vocabulary import Vocabulary

        voc = Vocabulary.load_any(args.vocabulary)
    system = build_system(system_cfg, seq, enable_objects=not args.no_objects,
                          pipelined=args.pipeline, device=device, vocabulary=voc,
                          enable_loop=not args.no_loop)

    n = args.frames or seq.num_frames
    timer = StageTimer()
    profiler = None
    if args.profile_dir:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
    # frames finish one call late under --pipeline: each overlay is keyed by
    # the finished frame's timestamp (the reference's drawer also renders the
    # last finished frame, FrameDrawer.cc:30-80)
    recent: dict = {}
    live = None
    if args.live_view_dir:
        from ..viz.live_viewer import LiveViewer

        live = LiveViewer(system, args.live_view_dir, every=args.live_view_every, serve_port=args.live_view_port)
    for frame_id in range(n):
        img_l, img_r = seq.load_stereo_gray(frame_id)
        if args.overlay_dir or live is not None:
            recent[round(float(seq.timestamp(frame_id)), 6)] = (frame_id, img_l)
            while len(recent) > 8:                      # frames dropped or lost
                recent.pop(next(iter(recent)))
        with timer.stage("track"):
            frame = system.track_stereo(img_l, img_r, seq.timestamp(frame_id))
        if args.overlay_dir:
            write_overlay(args.overlay_dir, system, frame, recent)
        if live is not None:
            fid_img = recent.get(round(float(frame.timestamp), 6)) if frame is not None else None
            live.tick(frame_id, frame=frame, img=None if fid_img is None else fid_img[1])
        if args.save_frames_dir and frame_id % args.save_frames_every == 0:
            system.save_map_current_frame(args.save_frames_dir, frame_id)
        if frame_id % 20 == 0:
            print(f"frame {frame_id}/{n} state={system.state.name} kfs={len(system.map.keyframes)} "
                  f"pts={len(system.map.points)} objs={len(system.map.objects)}")
    last = system.flush()
    if args.overlay_dir:
        write_overlay(args.overlay_dir, system, last, recent)
    if live is not None:
        live._last_render = 0.0          # a final refresh
        live.tick(0)
        live.close()
    if profiler is not None:
        profiler.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    os.makedirs(args.map_dir, exist_ok=True)
    system.save_map(args.map_dir)
    if args.save_state:
        from ..slam import state_io

        state_io.save_state(system.map, args.save_state)
    print(timer)
    stats = timer.report().get("track", {})
    print(f"median tracking time: {stats.get('median_ms', 0):.1f} ms, "
          f"mean: {stats.get('mean_ms', 0):.1f} ms")
    return system


if __name__ == "__main__":
    main()
