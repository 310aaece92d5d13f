"""Monocular object SLAM CLI, the dsp_slam_mono.cc equivalent (Redwood
chairs, Freiburg cars).

Port of dspslam_tpu/apps/dsp_slam_mono.py. Usage:

    python -m dspslam_tpu_torch.apps.dsp_slam_mono \\
        --sequence_dir <seq> --config configs/freiburg_001.json \\
        --map_dir out/ [--settings <reference yaml>] [--frames N] \\
        [--no_objects] [--pipeline] [--vocabulary voc.npz] [--device cpu]

Frames are the sequence's PNG / JPG images (image_0/ or the directory
itself); detections come from the offline 2D labels the config names
(`detection.path_label_2d`), the largest mask per frame. It writes
MapPoints.txt, MapObjects.txt, Cameras.txt and trajectory_tum.txt to
--map_dir. `--device` defaults to cuda; asking for cuda without a card is
an error, never a silent run on the CPU. `--vocabulary` attaches
relocalization after tracking loss (loop closing stays stereo-only, as in
the reference).
"""

from __future__ import annotations

import argparse
import os

from .. import config as cfg_mod
from ..datasets.mono import MonoSequence
from ..frontend import orb
from ..objects.mono_pipeline import MonoObjectPipeline
from ..slam.system import SLAMSystem
from ..slam.tracking import TrackerConfig
from ..utils.timing import StageTimer
from .reconstruct_frame import get_decoder, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sequence_dir", required=True)
    p.add_argument("--settings", help="per-sequence YAML (reference format)")
    p.add_argument("--config", help="dataset JSON (native format)")
    p.add_argument("--map_dir", default="map")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--no_objects", action="store_true")
    p.add_argument("--vocabulary", help="trained vocabulary .npz, or a DBoW2 ORBvoc .bin / .txt "
                   "(relocalization after tracking loss; loop closing stays stereo-only)")
    p.add_argument("--pipeline", action="store_true",
                   help="one-frame-lag pipelined tracking (distortion-free cameras; "
                        "lens-distorted ones stay on the modular path)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    system_cfg = cfg_mod.SystemConfig.load(args.config) if args.config else cfg_mod.SystemConfig()
    if args.settings:
        system_cfg = cfg_mod.SystemConfig.from_reference_yaml(args.settings, base=system_cfg)
    cam = system_cfg.camera
    dist = (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
    seq = MonoSequence(args.sequence_dir, system_cfg.detection, cam.K, dist_coeffs=dist)
    tracker_cfg = TrackerConfig(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.baseline_fx, width=cam.width,
        height=cam.height, max_frames_between_kf=int(cam.fps), dist_coeffs=dist,
        pipelined=args.pipeline,
    )
    orb_params = orb.ORBParams(n_features=system_cfg.orb.n_features,
                               scale_factor=system_cfg.orb.scale_factor,
                               n_levels=system_cfg.orb.n_levels)

    pipeline_factory = detection_source = None
    if not args.no_objects:
        decoder = get_decoder(system_cfg, device)

        def pipeline_factory(slam_map):
            return MonoObjectPipeline(slam_map, decoder, system_cfg.optimizer,
                                      voxels_dim=system_cfg.voxels_dim)

        detection_source = seq.get_frame_detections

    system = SLAMSystem(tracker_cfg=tracker_cfg, orb_params=orb_params,
                        object_pipeline_factory=pipeline_factory,
                        detection_source=detection_source, device=device)
    if args.vocabulary:
        from ..place.vocabulary import Vocabulary

        system.attach_vocabulary(Vocabulary.load_any(args.vocabulary))
    n = args.frames or seq.num_frames
    timer = StageTimer()
    for frame_id in range(n):
        img = seq.load_gray(frame_id)
        with timer.stage("track"):
            system.track_mono(img, frame_id / cam.fps)
        if frame_id % 25 == 0:
            print(f"frame {frame_id}/{n} state={system.state.name} kfs={len(system.map.keyframes)} "
                  f"pts={len(system.map.points)} objs={len(system.map.objects)}")
    system.flush()
    os.makedirs(args.map_dir, exist_ok=True)
    system.save_map(args.map_dir)
    system.save_trajectory_tum(os.path.join(args.map_dir, "trajectory_tum.txt"))
    print(timer)
    return system


if __name__ == "__main__":
    main()
