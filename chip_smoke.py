"""Smoke test of the PyTorch port on one CUDA card: builds kernels K1 and K2
and the greedy-NMS kernel from the repository's sources, checks each against its plain PyTorch
version, drives single-frame object reconstruction, stereo tracking,
object SLAM in stereo, mono and RGB-D, place recognition with loop
closing, the online detectors, the decoder fit with the benchmark's full
workload, the detector and vocabulary trainers, the overlays, the
(dp, tp) mesh, the decoder's configuration contract and the headline
benchmark entry (`apps.bench`) through their entry points, and times
them.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. K1's, K2's and the greedy-NMS kernel's builds (one nvcc each,
     started together, sm_90a);
  3. K1 against its plain version at N in {1, 7, 63, 64, 65, 300, 2048,
     4000, 8192} rows (ragged 64-row tiles), with each 64-row tile on a
     cluster of 1 and of 2 CTAs; each width's SASS must hold TF32
     tensor-core instructions (HGMMA ... TF32, `cuobjdump -sass`); time at
     N = 2048 and 8192 at every width and at the default choice,
     beside the plain version and the 3xTF32 tensor-core bound, with the
     SM fill of each width and the weight bytes streamed from L2 (a
     figure computed from the design, not measured);
  4. `dspslam_tpu_torch.apps.reconstruct_frame.main` on the synthetic frame
     with a seeded random full-width DeepSDF experiment dir (B=8, P=256,
     R=512, S=50, K=1024, 10 iterations): K1 must launch exactly 2 x 10
     times; then the same app with the analytic sphere decoder on the card
     against the CPU;
  5. GN at bench.py::bench_gn's inputs, timed with CUDA events, with K1 and
     with sdf_and_input_grad bound to the plain version; the two paths'
     poses and codes are compared after 1 and 10 iterations;
  6. K2 against its plain version: exact on integer images at every KITTI
     pyramid shape (376x1241 ... 105x346) and 49x130, and exact on the 16
     level maps of a stereo frame (resized levels included) in one launch;
     time per launch at 376x1241 and per stereo frame (one launch for the
     16 maps), CUDA events, in turns plain, kernel, kernel, plain; the
     bound from the work (52 lane operations per pixel, 48 more at a
     low-tier corner, counted on the frame; 8 bytes per pixel); the
     instructions per pixel in K2's SASS as a diagnostic;
  7. stereo tracking (`Tracker.process_stereo` + `flush`) at KITTI 00-02's
     settings (configs/kitti_00_02.json: 376x1241, 2000 features, 8 levels)
     over a 30-frame LayeredWorld street turn, non-pipelined and
     pipelined: 0 lost frames, ATE < 3% of travel, K2 launched once per
     frame tracked (plus once per re-tracked frame), poses within 1e-4 of a
     run over the first 15 frames with FAST bound to K2's plain version, one
     chained frame program
     free of host syncs (`torch.cuda.set_sync_debug_mode("error")`), the
     steady-state ms per frame and a `torch.profiler` table of the
     pipelined steady state;
  8. stereo object SLAM (slice 3) through its entry points:
     a. `apps.benchmark_slam.main` with `--workload legacy` (GT-derived
        sphere detections, the sphere decoder, pipelined tracking, async
        joint BA)
        at KITTI intrinsics, 376x1241, 2000 features, 8 levels, 20 frames
        through a 30-degree turn: 0 lost frames, ATE < 3% of travel, every
        static object within 0.35 m of a true sphere centre, an applied
        local BA solve with a camera-object edge inlier (the points-only
        A/B runs at the full workload in phase 15);
     b. `apps.dsp_slam.build_system` at configs/kitti_00_02.json with phase
        4's seeded random full-width DeepSDF over phase 7's turn, GT-derived
        sphere detections: 0 lost frames, ATE < 3% of travel, finite
        objects, K1 launched exactly as often as the object pipeline's GN
        calls need (pose-only iterations per measure call, 2 x iterations per
        recon or refine call) and K2 once per tracked frame plus once per
        re-tracked frame; per-frame stage times, the time between CUDA
        events around each local BA solve's and each keyframe's object-GN
        launches, and a `torch.profiler` table of one keyframe's drain
        with K1's share;
     c. `apps.dsp_slam.main` over tests/fixtures/mini_kitti (PNG pairs,
        velodyne, .lbl labels) on the card and on the CPU, both with K2's
        FAST response (the CPU through its plain version): the three map
        files parse and Cameras.txt agrees within 1e-3;
     and one `keyframe_matching` and one `bundle_adjust` with object edges
     under `torch.cuda.set_sync_debug_mode("error")`;
  9. monocular and RGB-D SLAM (slice 4) through their entry points, at
     configs/freiburg_001.json's camera (960x540, fx 930.2, 4000 features,
     8 levels): K2 exact on a mono frame's 8 level maps in one launch, timed;
     a. the bench entry's `mono_freiburg` arm (`apps.benchmark_slam.main(
        ["--frames", "30", "--mono", "--mono_profile", "freiburg"])`) over
        30 frames of a strafe with a 20-degree view yaw, pipelined, then not
        pipelined: two-view initialization within the first 10
        frames, 0 frames lost after it, Sim(3)-aligned ATE < 3% of travel,
        K2 once per extracted frame (re-tracked frames included); mean and
        median fps, p99 frame ms, stage times; the entry's 30-frame `paced`
        arm: its drop rate at 25 fps, K2 once per extracted frame;
        a `torch.profiler` table of 4 pipelined frames, the Hamming
        matrices' time and peak memory at 4000 features, and one
        `track_frame_mono_chained` under set_sync_debug_mode("error");
     b. `SLAMSystem.track_mono` with `MonoObjectPipeline` over
        tests/test_mono_objects.py's sphere scene rendered at Freiburg's
        camera: the sphere decoder (the object within 0.5 R of the truth
        after gauge alignment), then phase 4's random full-width DeepSDF
        (finite objects, K1 launched exactly `expected_k1_launches()` > 0
        times, each object-GN call's span, K1's share of one reconstructing
        keyframe's drain);
     c. `apps.dsp_slam_mono.main` over a 6-frame fixture it writes (raw
        renders through freiburg_001.json's lens, PNG, .npz labels) on the
        card and on the CPU, both with K2's FAST response:
        trajectory_tum.txt agrees within 1e-3 and the map files parse;
     d. `SLAMSystem.track_rgbd`, fused and pipelined, over 16 frames of 9a's
        sequence with its rendered depth images: 0 lost frames, ATE < 3% of
        travel, one K2 launch per frame.
 10. place recognition, relocalization and loop closing (slice 5) through
     their entry points:
     a. the bench entry's `long_loop` arm (`apps.benchmark_slam.main(
        ["--frames", "100", "--long_loop"])`): 201 keyframes of the
        fabricated street loop, a vocabulary trained in-process: 1 loop
        closed, ATE after <= 10% of before (printed beside the JAX
        package's TPU mark); the essential-graph and global-BA solves timed
        with CUDA events around their launches; one `_dispatch_global_ba`
        and one `optimize_pose_graph` at the run's shapes under
        set_sync_debug_mode("error");
     b. `SLAMSystem.track_stereo` at KITTI 00-02's settings with
        `attach_vocabulary` (trained on frames 0, 5, 10) over phase 7's turn
        with frames 12-14 blank: LOST there, relocalized within 2 frames
        after, none lost after that, ATE < 3% of travel, one K2 launch per
        frame;
     c. 8b's system with `enable_loop_closing`: 0 loops on a sequence with
        no revisit, K1 and K2 counted, each `insert_keyframe` timed around
        the call, the keyframe drains beside 8b's;
     d. the 1000-keyframe essential graph of tests/test_pose_graph_scale.py
        (its slow test): one `optimize_pose_graph_cg` solve at 1024
        vertices, timed, with its CG iterations;
     e. `apps.dsp_slam.main --vocabulary --save_state` over mini-KITTI,
        `load_state` and 3 more frames relocalized in the loaded map, then
        `apps.extract_map_objects.main` on the card and on the CPU: the same
        vertex and face counts, every vertex within 1e-4 of the other
        mesh's nearest (the host mesher's weld may order them differently).
 11. the online detectors (slice 6; seeded random weights; their one
     kernel is the greedy NMS, csrc/greedy_nms.cu) through their entry
     points:
     a. MaskRCNN at full width (R50-FPN, 256 channels, 80 classes, RPN
        512 / 128, 16 detections) on phase 7's first left frame as RGB, card
        against the CPU stage by stage on identical inputs: the bf16
        backbone + FPN (max |d| / max |f| per level <= 5e-2); the RPN's
        top-k + NMS fed the CPU's level outputs (the same proposals, within
        1e-3 px); the box and mask heads fed the CPU's proposals (1e-4); the
        box NMS fed the CPU's boxes and scores (equal); the share of kept
        scores exactly 1.0 (random weights saturate);
     b. PointPillars at full width over benchmark_detectors.synthetic_scan()
        (120,000 points, the 12,000-pillar cap hit): the device pillar build
        card vs CPU (coords and masks equal, features within 1e-5), the bf16
        forward (5e-2), select_detections fed the CPU's outputs (the same
        boxes), and host vs device pillar assignment under the cap;
     c. `apps.benchmark_detectors.main(["--iters", "20"])`, a
        `torch.profiler` table of one `Detector2D` and one `Detector3D`
        call, and one dispatch of each under set_sync_debug_mode("error");
     d. `apps.dsp_slam.main` over mini-KITTI with `detect_online: true` and
        phase 4's random DeepSDF: 3 frames, none lost, both detectors
        dispatched once per keyframe, K2 once per tracked frame, K1 exactly
        as the object GN calls need, the NMS kernel twice per MaskRCNN and
        once per PointPillars call, the map files parse. Nothing downstream
        of a detector's discrete choice is compared between card and CPU;
     e. the greedy-NMS kernel at the kitti_detect cell's settings
        (benchmark/configs/kitti_04_12_online.json): one `Detector2D` and one
        `Detector3D` call on 11a's frame and 11b's scan, counted from 0
        (`nms_launches` 3), with the three calls' inputs recorded (the RPN's
        4441 candidates and 1000 rounds under its per-level mask, the
        R-CNN's 1000 and 100, PointPillars' 100 and 50 over rotated
        overlaps); each call replayed on the card equals the plain loop
        (`greedy_suppress_plain`) on the CPU and on the card, picks, scores
        and ok, exactly; the kernel's time per call (CUDA events, back to
        back; device time from the profiler) beside the plain loop's on the
        card (wall, synchronized) and the bound of its bytes (the scores and
        each kept pick's overlap row over HBM).
 12. slice 7 (the decoder fit and the full workload, the detector trainers,
     the vocabulary trainer, the overlays) through their entry points:
     a. `deepsdf_train.fit_spheres` at `benchmark_slam.train_bench_decoder`'s
        shapes (the canonical decoder, 5 shapes, batch 8192, 600 steps): each
        code's surface along +x within 0.05 m of its radius; one `train_step`
        on the card and on the CPU from the same seeded state and numpy
        batch with float32 products (matmul_precision "highest"; loss
        within 1e-5 relative; each device's gradients against a float64
        step's, the card's largest error over the tensors within twice the
        CPU's or 1e-4 of a tensor's largest entry); the exported
        experiment dir through `load_torch_checkpoint` gives equal outputs;
        the steady ms per step;
     b. the bench entry's `full` arm (`apps.benchmark_slam.main(["--frames",
        "56"])`), the full workload
        (bench.py's 56 frames, 18 warm-up): Mask R-CNN and PointPillars at
        full width on every keyframe inside the measured loop, the decoder
        fitted at startup: 0 lost frames, ATE < 3% of travel, every static
        object within 0.35 m, at least one mesh, live chamfer <= 15 cm (the
        JAX package's TPU marks printed beside it); each detector
        dispatched once per detection call, K1 exactly as the object GN
        calls need, K2 once per frame plus once per re-tracked frame; mean
        and median fps, p95 frame ms, stage times, and a `torch.profiler`
        table of frames 10-14 with K1's and the detectors' device time;
     c. the closed loops of tests/test_detector_closed_loop.py (slow there)
        with the port's trainers on the card under that file's assertions,
        with deterministic algorithms (a seed gives one result in every
        run): Mask R-CNN 600 steps, PointPillars 640 steps, the BN trainer
        600 steps on 4 unseen scenes; one Mask R-CNN loss and gradient card vs
        CPU (1e-4 relative, 1e-3 of each tensor's largest gradient); ms per
        step of each trainer;
     d. `apps.train_vocabulary.main` over 10 of phase 7's left frames as PNG
        (branching 4, 3 levels): one K2 launch per image; then
        `apps.dsp_slam.main --vocabulary` with it over mini-KITTI;
     e. `apps.dsp_slam.main --overlay_dir --pipeline` over mini-KITTI: one
        PNG per finished frame, each the shape of its frame.
 13. the (dp, tp) mesh (slice 8; no kernel of its own, K1 runs on every
     rank of the sharded GN), in a one-rank NCCL group that the phase opens
     and destroys (the card machine has one H100):
     a. `deepsdf_train.shard_state` + `train_step` at train_deepsdf's
        defaults (the canonical decoder with float32 products, batch 16384,
        8 sphere shapes) on a
        (1, 1) mesh against the one-process step from the same state, under
        deterministic scatter-adds: the loss of 3 steps, the first step's
        gradients, the parameters after steps 1 and 3; ms per step of each;
     b. `mesh_utils.sharded_object_gn` at bench_gn's inputs with 12a's fitted
        decoder against the unsharded `batched_reconstruct`: K1 launched
        exactly 2 x 10 times in the 10-iteration call, poses and codes within
        1e-4 after one iteration and, after 10, as close to float64 as phase
        5 asks; ms per object of each;
     c. `shape.mesh.decode_sdf_grid_sharded` at 64^3 against
        `decode_sdf_grid` (1e-6), then `apps.extract_map_objects.main
        --shard` over a two-object map: its files equal the unsharded run's;
     d. two gloo ranks on the card (`parallel.dryrun.spawn` of
        `run_cases`): 13a's first step at tp = 2 against 13a's one-process
        step (the loss; the gradients, each held to a float64 step as 12a
        holds the card to the CPU; the parameters within what Adam's first
        step makes of the gradient difference), and `sharded_object_gn` at
        dp = 2 against 13b with 2 x 10 K1 launches on each rank.
 14. the decoder's configuration contract (slice 9): `compute_dtype`,
     `matmul_precision` and `GNConfig.render_eval_fraction`:
     a. the GN at bench_gn's inputs on the canonical decoder (K1), with
        phase 5's random weights and with 12a's fitted ones, at
        matmul_precision "highest" (f32 products) and "default" (TF32):
        after one iteration (k4 = 1e7) the two within 1e-3; after 10 with
        k4 = 0 "default" as close to a float64 run as phase 5 holds K1. If
        any fails, the shipped default must be "highest". ms per object
        at each precision in turns, K1 launched 2 x 10 times (its counter
        and the profiler), the render grid's forward per GN call and the
        generic input-gradient path at N = 2048 and 8192 at each precision;
     b. a 4 x 256 decoder (latent_in (2,), train_deepsdf --layers 4
        --hidden 256) with seeded weights: its generic path, sync-free, at
        "highest" within K1's tolerances of a float64 run; its GN finite
        after 10 iterations with 0 K1 launches;
     c. the canonical decoder at compute_dtype bfloat16: forward and generic
        sdf within 5e-2 of float32's, its GN finite with 0 K1 launches;
     d. `render_eval_fraction`: a cap at the most valid samples an object
        has gives the uncapped GN exactly after one iteration; 0.5 decodes B x
        int(R S / 2) rows per iteration and ends finite after 10 with 20 K1
        launches; ms per object of each.
 15. the headline benchmark entry, `apps.bench.main([])` (`python -m
     dspslam_tpu_torch.apps.bench`), every arm of bench.py's `_measure`
     but the relay probes: its `full`, `mono_freiburg`, `paced` and
     `long_loop` records are those of 12b, 9a and 10a (which ran them
     through the entry's functions), so no benchmark_slam argv runs twice;
     it runs `ab` (the full workload with points-only BA), `mono_redwood`
     (30 frames at 640x480) and `gn` (bench_gn by wall clock) itself. Its
     two JSON lines are printed; every arm's keys present and finite, no
     `<arm>_error`, fps > 0, 0 lost frames, both A/B arms' ATE < 3% of
     travel, the long loop's ATE after <= 10% of before, the paced drop
     rate in [0, 1]; K1 launched 11 x 20 times in `gn` and as the object GN
     calls need in `ab`, K2 once per extracted frame in `ab` and
     `mono_redwood`.
The last lines are JSON summaries of slice 5's to slice 10's numbers, the
card, a JSON summary of the kernels (the greedy NMS's `launches` phase
11d, its times and `cell_launches` 11e; K1's and K2's
`slam_launches` count phase 8b, their `mono_launches` phases 9b and 9a,
`loop_slam_launches` / `loop_launches` phase 10, `detector_slam_launches`
phase 11d, `full_arm_launches` phase 12b, K2's `vocabulary_launches` 12d,
K1's `sharded_gn_launches` 13b and 13d per rank, its
`decoder_contract_launches` 14a-14c, the GN's ms per object by precision
and the generic path's times, both kernels' `bench_launches` by arm of the
entry) and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
from scipy.spatial import cKDTree

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")

from dspslam_tpu_torch.apps import (  # noqa: E402
    bench, benchmark_detectors, benchmark_slam, dsp_slam, dsp_slam_mono, extract_map_objects, reconstruct_frame,
    train_vocabulary,
)
from dspslam_tpu_torch.apps.bench import canonical_params_np  # noqa: E402
from dspslam_tpu_torch.backend import ba, pose_graph  # noqa: E402
from dspslam_tpu_torch.config import DetectionConfig, SystemConfig  # noqa: E402
from dspslam_tpu_torch.datasets.kitti import KITTISequence, detector_configs  # noqa: E402
from dspslam_tpu_torch.datasets.mono import build_mono_detection  # noqa: E402
from dspslam_tpu_torch.datasets.synthetic import (  # noqa: E402
    blob_images, kitti_turn_sequence, render_poses, render_stereo_u8,
)
from dspslam_tpu_torch.detect import (  # noqa: E402
    layers, maskrcnn, maskrcnn_train, offline, pointpillars, pointpillars_train,
)
from dspslam_tpu_torch.frontend import matcher, orb, undistort  # noqa: E402
from dspslam_tpu_torch.kernels import _nvcc, decoder_fused, fast_score, greedy_nms  # noqa: E402
from dspslam_tpu_torch.models import deepsdf, deepsdf_train  # noqa: E402
from dspslam_tpu_torch.objects.mono_pipeline import MonoObjectPipeline  # noqa: E402
from dspslam_tpu_torch.place import loop_closing  # noqa: E402
from dspslam_tpu_torch.parallel import dryrun, mesh_utils  # noqa: E402
from dspslam_tpu_torch.place.vocabulary import Vocabulary  # noqa: E402
from dspslam_tpu_torch.ops import lie  # noqa: E402
from dspslam_tpu_torch.shape import gn, losses  # noqa: E402
from dspslam_tpu_torch.shape import mesh as mesh_mod  # noqa: E402
from dspslam_tpu_torch.slam import frame_step, keyframe_step, state_io, tracking  # noqa: E402
from dspslam_tpu_torch.slam import map as slam_map_mod  # noqa: E402
from dspslam_tpu_torch.slam.system import SLAMSystem  # noqa: E402
from dspslam_tpu_torch.utils.evaluation import ate_rmse  # noqa: E402
from dspslam_tpu_torch.utils.timing import StageTimer, attach as attach_sink, totals as counter_totals  # noqa: E402
from dspslam_tpu_torch.utils.io import read_mesh_ply  # noqa: E402

DEV = torch.device("cuda")
SRC = "dspslam_tpu_torch/csrc/decoder_fused.cu"
REPLACES = "dspslam_tpu/ops/pallas/decoder_kernel.py:106"
K2_SRC = "dspslam_tpu_torch/csrc/fast_score.cu"
K2_REPLACES = "dspslam_tpu/ops/pallas/fast_kernel.py:41"
NMS_SRC = "dspslam_tpu_torch/csrc/greedy_nms.cu"
# no TPU kernel: the JAX package's greedy NMS is a lax.fori_loop
NMS_REPLACES = "dspslam_tpu/detect/maskrcnn.py:221"
DETECT_CELL_CONFIG = "benchmark/configs/kitti_04_12_online.json"
KITTI_CONFIG = "configs/kitti_00_02.json"
MINI_KITTI = "tests/fixtures/mini_kitti"
# published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, fp32
# (CUDA-core) operations/s and dense TF32 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# K1 work per decoder row: forward 1,835,520 + backward 1,835,008
# multiply-adds, 2 operations each (PERF.md section 5). f32 accuracy on the
# tensor cores takes three TF32 products per product (3xTF32).
K1_OPS_PER_ROW = 2 * (1_835_520 + 1_835_008)
K1_TF32_PRODUCTS = 3
K1_ROWS_PER_BLOCK = 64
# K2's work: every pixel needs 16 subtractions, 32 low-tier compares
# (bright and dark) and the run test of its two words (a popcount and a
# compare each); a low-tier corner also needs the 16 |d| accumulations and
# 32 high-tier compares (the high tier implies the low one, t_hi >= t_lo).
# Each of the 4 x 132 schedulers issues one warp instruction, 32 lanes, per
# clock: 33.5e12 lane operations/s, the fp32 peak without the FMA's factor 2.
K2_OPS_PER_PX = 16 + 32 + 4
K2_OPS_PER_CORNER = 16 + 32
ISSUE_PER_S = FP32_OPS_PER_S / 2
K2_PIXELS_PER_THREAD = 2
# the previous designs' times (PERF.md section 6: the one-thread-per-pixel
# K2 and the CUDA-core K1, recorded on an NVIDIA H100 80GB HBM3 at 700 W),
# printed beside this run's
PREVIOUS = {"k1_ms": {2048: 1.2005, 8192: 2.5528}, "k2_launch_ms": 0.02783,
            "k2_launch_device_ms": 0.01168, "k2_frame_ms": 0.43187,
            "k2_frame_device_ms": 0.09405}
# GN comparison tolerances, kernel path vs plain path on identical inputs.
# K1 and cuBLAS sum in different orders (~1e-6 relative in J and r); one GN
# step carries that into the pose at about the solve's condition number.
TOL_ITER1 = 1e-3
# After 10 iterations the trajectories may separate further where the
# problem is ill-conditioned (the k4 = 1e7 rotation prior); the kernel path
# must then stay as close to a float64 run of the plain path as the f32
# plain path is, within this factor and floor.
TOL_ITER10_FACTOR, TOL_ITER10_FLOOR = 2.0, 1e-3


def launch_mark() -> dict:
    """The port's process-wide counter totals now (`launches_since`)."""
    return counter_totals()


def launches_since(mark: dict) -> tuple[int, int]:
    """(K1, K2) launches since `mark`: the kernels' launchers count each
    launch (`utils.timing.count`)."""
    now = counter_totals()
    return tuple(now.get(k, 0) - mark.get(k, 0) for k in ("k1_launches", "k2_launches"))


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown"


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(events) -> tuple[str, float]:
    """(attribute name, total device time in ms of the kernels among
    `events`); the attribute was renamed from the cuda_ to the device_
    form. Operator rows repeat their kernels' time and are left out."""
    key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return key, sum(getattr(e, key) for e in kernels) / 1e3


def kernel_device_ms(fn, reps: int, kernel: str) -> float:
    """Device time per call of the kernels whose name holds `kernel`, from
    torch.profiler over `reps` calls of `fn`. A profiler session now and
    then records none of the kernel's launches (seen once for K2, whose
    library is launched through ctypes): up to 3 sessions run before that
    counts as a failure."""
    fn()
    torch.cuda.synchronize()
    sessions = 3
    for attempt in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        if events:
            return device_ms(events)[1] / reps
        print(f"profiler session {attempt + 1} of {sessions} recorded no {kernel} launch")
    check(False, f"the profiler saw no {kernel} launch in {sessions} sessions")


def bound(nbytes: float, ops_ms: float) -> tuple[float, str]:
    """Least time in ms for the work on this card, given the least time of
    its operations, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= ops_ms else (ops_ms, "operations")


def sass(so: str) -> dict:
    """{kernel function name: [(address, instruction text)]} of a built
    library, from `cuobjdump -sass`."""
    tool = os.path.join(os.path.dirname(_nvcc.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def function(code: dict, kernel: str) -> list:
    names = [k for k in code if kernel in k]
    check(len(names) == 1, f"{kernel}: expected one function in the SASS, found {names}")
    return code[names[0]]


def k1_tensor_instructions(so: str) -> dict:
    """K1's tensor-core instructions, from its SASS: per instantiation
    (one per cluster width), the HGMMA ones and how many of those take TF32
    operands."""
    code = sass(so)
    names = [k for k in code if "decoder_fused_kernel" in k]
    check(len(names) == len(decoder_fused.WIDTHS),
          f"expected {len(decoder_fused.WIDTHS)} K1 functions in the SASS, found {names}")
    out = {}
    for name in names:
        hgmma = [t for _, t in code[name] if "HGMMA" in t]
        counts = {"hgmma": len(hgmma), "tf32": sum("TF32" in t for t in hgmma),
                  "example": hgmma[0] if hgmma else ""}
        check(counts["tf32"] > 0, f"{name}: no TF32 HGMMA instruction in the SASS: {counts}")
        out[name] = counts
    return out


def k2_instructions(so: str) -> dict:
    """Instructions each pixel issues in K2, from the SASS of its library
    (`cuobjdump -sass`): the section every thread runs after the tile is
    staged, from the barrier to the end, less the code a forward branch may
    skip (the run tests a word with < 9 bits set skips, and the corner
    path), divided by the pixels per thread. A diagnostic of the
    non-corner pixel's path, not a bound."""
    code = function(sass(so), "fast_score_maps_kernel")
    start = next(i for i, (_, t) in enumerate(code) if t.startswith("BAR.SYNC"))
    stop = max(i for i, (_, t) in enumerate(code) if t.endswith("EXIT"))
    total, skip_to = 0, -1
    for addr, text in code[start:stop]:
        if addr < skip_to:
            continue
        total += 1
        branch = re.match(r"@!?U?P\d BRA (0x[0-9a-f]+)", text)
        if branch and int(branch.group(1), 16) > addr:
            skip_to = int(branch.group(1), 16)
    per_px = total / K2_PIXELS_PER_THREAD
    check(per_px > 48, f"K2's SASS parsed to {per_px} instructions per pixel")
    return {"per_pixel": per_px}


def k2_bound(px: int, corners: int) -> tuple[float, str]:
    """Least time in ms for K2's work on `px` pixels of which `corners`
    are low-tier corners: the lane operations over the issue rate, or 8
    bytes per pixel over HBM."""
    ops = K2_OPS_PER_PX * px + K2_OPS_PER_CORNER * corners
    return bound(8.0 * px, ops / ISSUE_PER_S * 1e3)


def k1_bound(n: int, param_floats: int) -> tuple[float, str]:
    """Least time in ms for K1 at n rows: the 3xTF32 products at the TF32
    tensor-core peak, or reading the inputs and f32 weights once and
    writing the outputs."""
    nbytes = 4.0 * (n * 67 * 2 + n + param_floats)
    return bound(nbytes, K1_TF32_PRODUCTS * K1_OPS_PER_ROW * n / TF32_OPS_PER_S * 1e3)


def k1_l2_bytes(n: int) -> float:
    """Bytes of packed weights K1 streams from L2 at n rows, computed from
    the design (not measured): the CTAs of every 64-row tile read the whole
    packed buffer once between them, at any cluster width."""
    return -(-n // K1_ROWS_PER_BLOCK) * 4.0 * decoder_fused.packed_floats()


def phase_kernel(dec, so: str, name: str) -> dict:
    w, b = list(dec.weights), list(dec.biases)
    rng = np.random.default_rng(1)
    max_err = 0.0
    for n in (1, 7, 63, 64, 65, 300, 2048, 4000, 8192):
        x = torch.from_numpy((rng.normal(size=(n, 67)) * 0.3).astype(np.float32)).to(DEV)
        sdf_p, grad_p = decoder_fused.sdf_and_input_grad_plain(w, b, x)
        errs = []
        for cw in decoder_fused.WIDTHS:
            sdf, grad = decoder_fused.sdf_and_input_grad(w, b, x, cluster=cw)
            torch.cuda.synchronize()
            sdf_err = float((sdf - sdf_p).abs().max())
            row_err = (grad - grad_p).abs().amax(dim=1)
            p99 = float(torch.quantile(row_err, 0.99))
            outliers = int((row_err > 1e-4).sum())
            max_err = max(max_err, sdf_err, float(row_err.max()))
            errs.append(f"{cw}: {sdf_err:.3e} / {float(row_err.max()):.3e} / {p99:.3e} / {outliers}")
            where = f"N={n}, {cw} CTAs per tile"
            check(bool(torch.isfinite(sdf).all() and torch.isfinite(grad).all()), f"non-finite K1 output at {where}")
            check(sdf_err <= 1e-5, f"K1 sdf error {sdf_err} > 1e-5 at {where}")
            check(p99 < 1e-4, f"K1 grad p99 error {p99} >= 1e-4 at {where}")
            check(outliers <= max(3, n // 1000), f"{outliers} K1 grad outliers at {where}")
        print(f"[3] K1 vs plain N={n}, by CTAs per tile (sdf max err / grad max err / grad p99 err "
              f"/ rows > 1e-4): {'; '.join(errs)}")
    tc = k1_tensor_instructions(so)
    for fn_name, c in tc.items():
        print(f"[3] K1's SASS, {fn_name}: {c['hgmma']} HGMMA instructions, {c['tf32']} of them TF32 "
              f"(e.g. `{c['example']}`)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {}
    for n in (2048, 8192):
        x = torch.from_numpy((rng.normal(size=(n, 67)) * 0.3).astype(np.float32)).to(DEV)
        tiles = -(-n // K1_ROWS_PER_BLOCK)
        chosen = decoder_fused.width(DEV, n)
        order = ["plain", *decoder_fused.WIDTHS]
        runs = {path: [] for path in order}
        for path in order + order[::-1]:
            if path == "plain":
                fn = lambda: decoder_fused.sdf_and_input_grad_plain(w, b, x)  # noqa: E731
            else:
                fn = lambda: decoder_fused.sdf_and_input_grad(w, b, x, cluster=path)  # noqa: E731
            runs[path].append(cuda_ms(fn, 20))
        t = {path: float(np.mean(v)) for path, v in runs.items()}
        t["kernel"] = t[chosen]
        t["width"] = chosen
        t["device"] = kernel_device_ms(lambda: decoder_fused.sdf_and_input_grad(w, b, x),
                                       20, "decoder_fused_kernel")
        t["bound"], t["bound_by"] = k1_bound(n, decoder_fused.packed_floats())
        old_bound = K1_OPS_PER_ROW * n / FP32_OPS_PER_S * 1e3
        for cw in decoder_fused.WIDTHS:
            fit = decoder_fused.clusters(DEV, cw)
            print(f"[3] K1 N={n}, {cw} CTAs per tile: {t[cw]:.4f} ms ({runs[cw][0]:.4f}, "
                  f"{runs[cw][1]:.4f}); {tiles * cw} CTAs, {fit} clusters of {cw} run at once: "
                  f"{-(-tiles // fit)} wave(s), SM fill {min(tiles, fit) * cw / sms:.3f} of "
                  f"{sms} SMs in the first")
        times[n] = t
        print(f"[3] K1 time N={n}: kernel {t['kernel']:.4f} ms at the default choice of {chosen} CTAs per "
              f"tile (device {t['device']:.4f}), plain {t['plain']:.4f} ms ({runs['plain'][0]:.4f}, "
              f"{runs['plain'][1]:.4f}) (CUDA events, 20 launches, mean of 2 turns) on {name}; bound "
              f"{t['bound']:.4f} ms ({t['bound_by']}: 3xTF32 at 495 TFLOP/s; the f32 CUDA-core "
              f"figure was {old_bound:.4f}); weights streamed from L2 {k1_l2_bytes(n) / 1e9:.3f} GB "
              f"at every width (computed, not measured); the CUDA-core design took "
              f"{PREVIOUS['k1_ms'][n]:.4f} ms")
    return {"max_abs_err": max_err, "times": times, "tensor": tc}


def write_experiment(path: str, params_np: dict):
    """Reference-format DeepSDF experiment dir: specs.json + latest.pth."""
    os.makedirs(os.path.join(path, "ModelParameters"))
    cfg = deepsdf.DecoderConfig()
    specs = {"CodeLength": cfg.code_len, "NetworkArch": "deep_sdf_decoder",
             "NetworkSpecs": {"dims": list(cfg.hidden), "latent_in": list(cfg.latent_in),
                              "weight_norm": False, "use_tanh": False}}
    with open(os.path.join(path, "specs.json"), "w") as f:
        json.dump(specs, f)
    state = {}
    for i, (w, b) in enumerate(zip(params_np["w"], params_np["b"])):
        state[f"lin{i}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        state[f"lin{i}.bias"] = torch.from_numpy(b)
    torch.save({"epoch": 0, "model_state_dict": state},
               os.path.join(path, "ModelParameters", "latest.pth"))


def phase_slice(tmp: str) -> int:
    exp = os.path.join(tmp, "deepsdf")
    write_experiment(exp, canonical_params_np(seed=2))
    cfg_path = os.path.join(tmp, "config.json")
    SystemConfig(deepsdf_dir=exp).to_json(cfg_path)
    out_dir = os.path.join(tmp, "out")
    mark = launch_mark()
    summary = reconstruct_frame.main(["--synthetic", "--config", cfg_path, "--output_dir", out_dir])
    launches = launches_since(mark)[0]
    print(f"[4] reconstruct_frame (full-width DeepSDF, 10 GN iterations): K1 launches {launches}")
    check(launches == 2 * 10, f"K1 launched {launches} times in the slice, expected 20")
    check(len(summary) == 2, f"expected 2 detections, got {len(summary)}")
    for rec in summary:
        finite = all(np.isfinite(np.asarray(rec[k], np.float64)).all() for k in ("t_cam_obj", "code", "loss"))
        check(finite, f"object {rec['index']}: non-finite pose, code or loss")
        verts = "no mesh"
        if "mesh" in rec:
            verts = f"{len(read_mesh_ply(rec['mesh'])[0])} mesh vertices"
        print(f"[4] object {rec['index']}: is_good {rec['is_good']}, loss {rec['loss']:.6g}, {verts}")

    # the rest of the GPU path (losses, GN, mesh) on the analytic decoder,
    # card against CPU
    on_card = reconstruct_frame.main(["--synthetic", "--output_dir", os.path.join(tmp, "s_cuda")])
    on_cpu = reconstruct_frame.main(["--synthetic", "--device", "cpu", "--output_dir", os.path.join(tmp, "s_cpu")])
    for a, b in zip(on_card, on_cpu):
        dT = float(np.abs(np.asarray(a["t_cam_obj"]) - np.asarray(b["t_cam_obj"])).max())
        dc = float(np.abs(np.asarray(a["code"]) - np.asarray(b["code"])).max())
        print(f"[4] sphere decoder object {a['index']}: card vs CPU |d pose| {dT:.3e}, |d code| {dc:.3e}")
        check(a["is_good"] and b["is_good"] and dT < 1e-4 and dc < 1e-4,
              "sphere-decoder slice differs between card and CPU")
    return launches


def bench_gn_inputs():
    """bench.py::bench_gn's batch and inputs (B=8, P=256, R=512) on the
    card, seeded with numpy (`apps.bench.bench_gn_inputs`)."""
    return bench.GN_BATCH, bench.bench_gn_inputs(DEV)


def phase_gn(name: str) -> dict:
    params_np = canonical_params_np(seed=0)
    kernel_dec = deepsdf.params_from_jax(params_np, device=DEV)
    plain_dec = deepsdf.params_from_jax(params_np, device=DEV)
    # the smoke test's own comparison: this instance's input gradients come
    # from the plain version
    plain_dec.sdf_and_input_grad = lambda x: decoder_fused.sdf_and_input_grad_plain(
        list(plain_dec.weights), list(plain_dec.biases), x
    )
    B, args = bench_gn_inputs()
    decs = {"kernel": kernel_dec, "plain": plain_dec}
    runs = {"kernel": [], "plain": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        run = gn.batched_reconstruct(decs[path], gn.GNConfig(code_len=64, num_iterations=10))
        runs[path].append(cuda_ms(lambda: run(*args), 5) / B)
    ms = {k: float(np.mean(v)) for k, v in runs.items()}
    print(f"[5] GN at bench_gn shapes (B=8, P=256, R=512, S=50, K=1024, 10 iterations), "
          f"ms/object: kernel {ms['kernel']:.3f} ({runs['kernel'][0]:.3f}, {runs['kernel'][1]:.3f}), "
          f"plain {ms['plain']:.3f} ({runs['plain'][0]:.3f}, {runs['plain'][1]:.3f}) on {name}")

    f64_dec = deepsdf.params_from_jax(params_np, device=DEV).double()
    f64_dec.sdf_and_input_grad = lambda x: decoder_fused.sdf_and_input_grad_plain(
        list(f64_dec.weights), list(f64_dec.biases), x
    )
    refs = {}
    for iters in (1, 10):
        cfg = gn.GNConfig(code_len=64, num_iterations=iters)
        out = {p: gn.batched_reconstruct(decs[p], cfg)(*args) for p in decs}
        ref = refs[iters] = gn.batched_reconstruct(f64_dec, cfg)(*[a.double() for a in args])
        for p in out:
            check(bool(torch.isfinite(out[p]["t_cam_obj"]).all() and torch.isfinite(out[p]["code"]).all()),
                  f"non-finite GN output on the {p} path after {iters} iterations")
        d = {k: float((out["kernel"][k] - out["plain"][k]).abs().max()) for k in ("t_cam_obj", "code")}
        d64 = {p: max(float((out[p][k].double() - ref[k]).abs().max()) for k in ("t_cam_obj", "code"))
               for p in out}
        print(f"[5] after {iters} iteration(s): kernel vs plain |d t_cam_obj| {d['t_cam_obj']:.3e}, "
              f"|d code| {d['code']:.3e}; vs float64 plain: kernel {d64['kernel']:.3e}, "
              f"plain {d64['plain']:.3e}; is_good kernel {out['kernel']['is_good'].tolist()}")
        if iters == 1:
            check(max(d.values()) <= TOL_ITER1, f"GN paths differ by {d} after 1 iteration")
        else:
            bound = TOL_ITER10_FACTOR * d64["plain"] + TOL_ITER10_FLOOR
            check(d64["kernel"] <= bound,
                  f"kernel path {d64['kernel']} from float64 after 10 iterations, bound {bound}")
    return {"ms": ms, "f64_decoder": f64_dec, "ref64_iter1": refs[1]}


def k2_levels(left: np.ndarray, right: np.ndarray, params) -> list:
    """The 16 (h, w) level maps of one stereo frame's two pyramids on the
    card, in the order `orb.extract_stereo` gives them to K2: by level, the
    left and right image of a level adjacent."""
    pyramids = []
    for img in (left, right):
        t = torch.from_numpy(img).to(DEV).float()
        pyramids.append([t if level == 0 else orb.resize(t, h, w).contiguous()
                         for level, (h, w) in enumerate(orb.level_shapes(params, *img.shape))])
    return [pyr[level] for level in range(len(pyramids[0])) for pyr in pyramids]


def phase_fast(frame0, params, so: str, name: str) -> dict:
    t_lo, t_hi = float(params.min_threshold), float(params.fast_threshold)
    max_err = 0.0
    shapes = orb.level_shapes(params, 376, 1241) + [(49, 130)]
    for i, (h, w) in enumerate(shapes):
        x = torch.from_numpy(blob_images(1, h, w, seed=i)[0]).to(DEV)
        (out,) = fast_score.fast_score_maps([x], t_lo, t_hi, orb.BOOST)
        torch.cuda.synchronize()
        (ref,) = fast_score.fast_score_maps_plain([x], t_lo, t_hi, orb.BOOST)
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        check(bool(torch.equal(out, ref)), f"K2 differs from its plain version at {h}x{w}: {err}")
        check(int((ref >= orb.BOOST).sum()) > 0, f"no high-tier corner at {h}x{w}")
    print(f"[6] K2 vs plain on integer images at {len(shapes)} shapes "
          f"({shapes[0][0]}x{shapes[0][1]} ... {shapes[-2][0]}x{shapes[-2][1]}, 49x130): exact")

    levels = k2_levels(*frame0, params)
    mark = launch_mark()
    outs = fast_score.fast_score_maps(levels, t_lo, t_hi, orb.BOOST)
    torch.cuda.synchronize()
    check(launches_since(mark)[1] == 1, "K2 took more than one launch for a frame")
    refs = fast_score.fast_score_maps_plain(levels, t_lo, t_hi, orb.BOOST)
    for x, out, ref in zip(levels, outs, refs):
        max_err = max(max_err, float((out - ref).abs().max()))
        check(bool(torch.equal(out, ref)), f"K2 differs from its plain version on a {tuple(x.shape)} level")
    print(f"[6] K2 vs plain on the 16 level maps of a KITTI-shaped stereo frame (resized levels, "
          f"non-integer), one launch: exact")

    full = levels[:1]
    per_launch = {"plain": [], "kernel": []}
    per_frame = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        fn = fast_score.fast_score_maps if path == "kernel" else fast_score.fast_score_maps_plain
        per_launch[path].append(cuda_ms(lambda: fn(full, t_lo, t_hi, orb.BOOST), 50))
        per_frame[path].append(cuda_ms(lambda: fn(levels, t_lo, t_hi, orb.BOOST), 50))
    ms = {k: float(np.mean(v)) for k, v in per_launch.items()}
    frame_ms = {k: float(np.mean(v)) for k, v in per_frame.items()}
    # the wrapper's own host time per frame: calls queued without a sync
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fast_score.fast_score_maps(levels, t_lo, t_hi, orb.BOOST)
    host_frame_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    dev_launch = kernel_device_ms(lambda: fast_score.fast_score_maps(full, t_lo, t_hi, orb.BOOST),
                                  50, "fast_score_maps_kernel")
    dev_frame = kernel_device_ms(lambda: fast_score.fast_score_maps(levels, t_lo, t_hi, orb.BOOST),
                                 50, "fast_score_maps_kernel")
    px = full[0].numel()
    px_frame = sum(x.numel() for x in levels)
    instr = k2_instructions(so)
    # low-tier corners (a nonzero score): where the work beyond the
    # every-pixel part is needed
    corners = int((refs[0] != 0).sum())
    corners_frame = sum(int((r != 0).sum()) for r in refs)
    b_launch, by_launch = k2_bound(px, corners)
    b_frame, by_frame = k2_bound(px_frame, corners_frame)
    print(f"[6] K2's SASS: {instr['per_pixel']:.1f} instructions per pixel on a non-corner "
          f"pixel's path (a diagnostic; the one-launch-per-map kernel: 393)")
    print(f"[6] K2 time per launch at 376x1241 ({px} px): kernel {ms['kernel']:.5f} ms "
          f"({per_launch['kernel'][0]:.5f}, {per_launch['kernel'][1]:.5f}; device {dev_launch:.5f}), "
          f"plain {ms['plain']:.5f} ms ({per_launch['plain'][0]:.5f}, {per_launch['plain'][1]:.5f}), "
          f"bound {b_launch:.5f} ms ({by_launch}: {K2_OPS_PER_PX} lane operations per pixel, "
          f"{K2_OPS_PER_CORNER} more at each of its {corners} low-tier corners) on {name}; the one-launch-per-map design took {PREVIOUS['k2_launch_ms']:.5f} ms (device "
          f"{PREVIOUS['k2_launch_device_ms']:.5f})")
    print(f"[6] K2 time per stereo frame (16 level maps, {px_frame} px, one launch): kernel "
          f"{frame_ms['kernel']:.5f} ms ({per_frame['kernel'][0]:.5f}, {per_frame['kernel'][1]:.5f}; "
          f"device {dev_frame:.5f}), plain {frame_ms['plain']:.5f} ms ({per_frame['plain'][0]:.5f}, "
          f"{per_frame['plain'][1]:.5f}), host time of the wrapper {host_frame_ms:.5f} ms (50 calls queued, "
          f"perf_counter), bound {b_frame:.5f} ms ({by_frame}; {corners_frame} low-tier "
          f"corners, {corners_frame / px_frame:.4f} of the pixels) on {name}; the previous "
          f"design's 16 launches took {PREVIOUS['k2_frame_ms']:.5f} ms (device {PREVIOUS['k2_frame_device_ms']:.5f})")
    return {"max_abs_err": max_err, "ms": ms, "frame_ms": frame_ms,
            "device_ms": dev_launch, "device_frame_ms": dev_frame, "host_frame_ms": host_frame_ms,
            "bound_ms": b_launch, "bound_by": by_launch, "frame_bound_ms": b_frame,
            "instructions_per_pixel": instr["per_pixel"]}


def run_tracker(system_cfg, images, pipelined: bool) -> tuple:
    """Drive Tracker.process_stereo + flush over the sequence; returns the
    tracker and the wall time of each call (synchronised at the end)."""
    tr = tracking.tracker_from_system_config(system_cfg, pipelined=pipelined)
    walls = []
    t_start = None
    for k, (left, right) in enumerate(images):
        if k == 5:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        t0 = time.perf_counter()
        tr.process_stereo(left, right, 0.1 * k)
        walls.append(time.perf_counter() - t0)
    tr.flush()
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t_start) / (len(images) - 5)
    return tr, walls, steady


def trajectory_wc(tr) -> np.ndarray:
    return np.stack([np.linalg.inv(T.astype(np.float64)) for _, T, _ in tr.trajectory])


PLAIN_FRAMES = 15


def phase_tracking(system_cfg, images, poses, name: str) -> dict:
    n = len(images)
    travel = float(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1).sum())
    out = {"launches": 0}
    for pipelined in (False, True):
        form = "pipelined" if pipelined else "non-pipelined"
        # the main path: launches counted from just before to just after
        mark = launch_mark()
        tr, walls, steady = run_tracker(system_cfg, images, pipelined)
        k1, launches = launches_since(mark)
        check(k1 == 0, "K1 ran on the tracking path")
        out["launches"] += launches
        lost = sum(1 for _, _, l in tr.trajectory if l)
        ate = ate_rmse(trajectory_wc(tr), poses)["rmse"]
        print(f"[7] {form}: {len(tr.trajectory)} frames, {lost} lost, state {tr.state.name}, "
              f"{len(tr.map.keyframes)} keyframes, {len(tr.map.points)} map points, "
              f"ATE {ate:.5f} m over {travel:.3f} m; K2 launches {launches} "
              f"({tr.n_redone} frames re-tracked)")
        check(len(tr.trajectory) == n and lost == 0, f"{form}: {lost} lost frames")
        check(tr.state == tracking.State.OK, f"{form}: ends in {tr.state}")
        check(ate < 0.03 * travel, f"{form}: ATE {ate} m >= 3% of {travel} m")
        check(launches == n + tr.n_redone,
              f"{form}: K2 launched {launches} times, expected one per frame: {n} + {tr.n_redone}")
        # the same drive with FAST bound to K2's plain version, over the
        # first PLAIN_FRAMES frames (the whole turn no longer fits the smoke's time limit)
        with mock.patch.object(fast_score, "fast_score_maps", fast_score.fast_score_maps_plain):
            ref, _, _ = run_tracker(system_cfg, images[:PLAIN_FRAMES], pipelined)
        dT = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(tr.trajectory, ref.trajectory))
        check(len(ref.trajectory) == PLAIN_FRAMES and dT <= 1e-4, f"{form}: K2 and plain paths differ by {dT}")
        med = float(np.median(walls[5:])) * 1e3
        print(f"[7] {form}: K2 vs plain-FAST run, max |d T_cw| over the first {PLAIN_FRAMES} frames {dT:.3e}; "
              f"steady state (frames 5..{n - 1}): median call {med:.3f} ms, "
              f"synchronised wall {steady * 1e3:.3f} ms/frame on {name}")
        out[form] = {"median_ms": med, "wall_ms": steady * 1e3, "ate": ate, "tracker": tr}
    return out


def phase_sync_free(tr, images):
    """One chained frame program with every input on the card, under
    torch.cuda.set_sync_debug_mode("error")."""
    left, right = (tr._upload_image(x) for x in images[-1])
    _, dev = tr._local_pack()
    if tr._chain is None:
        tr._seed_chain()
    args = (tr.orb_params, tr._radii(), float(tr.cfg.velocity_smoothing), left, right,
            float(tr.cfg.bf), float(tr.cfg.bf / 0.5), tr.intrinsics, *tr._chain, *dev)
    frame_step.track_frame_stereo_chained(*args)        # constants cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feats, st, result, chain = frame_step.track_frame_stereo_chained(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(result["T_cw"]).all()), "chained program gave a non-finite pose")
    print(f"[7] track_frame_stereo_chained under set_sync_debug_mode('error'): no host sync; "
          f"{int(result['n_inliers'])} inliers")


def phase_profile(system_cfg, images, wall_ms_per_frame: float):
    """torch.profiler over 8 steady pipelined frames: device time by kernel
    and the device idle share of the window."""
    tr = tracking.tracker_from_system_config(system_cfg, pipelined=True)
    for k, (left, right) in enumerate(images[:8]):
        tr.process_stereo(left, right, 0.1 * k)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(8, 16):
            tr.process_stereo(*images[k], 0.1 * k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tr.flush()
    events = prof.key_averages()
    key, busy_ms = device_ms(events)
    print(f"[7] profile, 8 pipelined frames: wall {wall_ms:.3f} ms under the profiler, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / 8:.3f} ms/frame); idle share {1 - busy_ms / wall_ms:.3f} "
          f"of the profiled wall, {1 - busy_ms / 8 / wall_ms_per_frame:.3f} of the unprofiled "
          f"{wall_ms_per_frame:.3f} ms/frame")
    print(events.table(sort_by=key, row_limit=25))


# 8a's depth: 20 frames (not the JAX benchmark's 40) keep the smoke inside
# its time limit on a slow host; the turn starts at frame 10
LEGACY_FRAMES = 20


def phase_slam_accuracy(name: str) -> dict:
    """8a: the port's benchmark_slam (stereo arm, `--workload legacy`) at KITTI
    intrinsics, 376x1241, 2000 features, 8 levels, 20 frames into the
    30-degree turn: joint BA, pipelined tracking, async BA. (The joint vs
    points-only A/B runs at the full workload in phase 15.)"""
    mark = launch_mark()
    rec = benchmark_slam.main(["--frames", str(LEGACY_FRAMES), "--workload", "legacy"])
    k1, k2 = launches_since(mark)
    limit = 0.03 * rec["travel_m"]
    print(f"[8a] benchmark_slam, {LEGACY_FRAMES} frames (joint BA): {rec['lost_frames']} lost, ATE "
          f"{rec['ate_rmse_cm']:.4f} cm over {rec['travel_m']:.2f} m; {rec['n_keyframes']} keyframes, "
          f"{rec['n_points']} map points, {rec['n_objects']} objects ({rec['n_static']} static, "
          f"errors {[round(e, 4) for e in rec['static_obj_errs_m']]} m; {rec['n_dynamic']} dynamic, "
          f"{rec['dynamic_obj_err_cm']} cm); mesh chamfer {rec['mesh_chamfer_cm']} cm over "
          f"{rec['n_meshes']} meshes (64^3 re-decode {rec['mesh_chamfer_refined_cm']} cm); "
          f"{rec['value']:.3f} fps mean, {rec['median_fps']:.3f} median; K2 launches {k2}, K1 {k1} "
          f"(sphere decoder) on {name}")
    print(f"[8a] local BA solves: {rec['ba_solves']}")
    check(rec["lost_frames"] == 0, f"8a: {rec['lost_frames']} lost frames")
    check(rec["ate_rmse_cm"] / 100 < limit, f"8a: ATE {rec['ate_rmse_cm']} cm >= 3% of {rec['travel_m']} m")
    check(rec["n_static"] >= 1 and max(rec["static_obj_errs_m"]) < 0.35,
          f"8a: static objects {rec['static_obj_errs_m']} (need >= 1, each < 0.35 m)")
    check(any(b["edge_inliers"] >= 1 for b in rec["ba_solves"]),
          "8a: no applied local BA solve with a camera-object edge inlier")
    check(k2 > 0 and k1 == 0, f"8a: K2 launched {k2} times, K1 {k1}")
    return rec


def kitti_detections(poses):
    """benchmark_slam's GT-derived sphere detections against a sequence's
    camera-to-world poses, seeded."""
    spheres = benchmark_slam.place_spheres(poses)
    rng = np.random.default_rng(3)
    return lambda idx: benchmark_slam.make_detections(poses[min(idx, len(poses) - 1)], spheres, rng)


def phase_slam_k1(system_cfg, exp_dir: str, images, poses, name: str) -> dict:
    """8b: dsp_slam.build_system at KITTI 00-02 settings with the seeded
    random full-width DeepSDF decoder (K1 in every object GN iteration) over
    phase 7's turn, GT-derived sphere detections."""
    cfg = dataclasses.replace(system_cfg, deepsdf_dir=exp_dir)
    system = dsp_slam.build_system(cfg, None, pipelined=True)
    system.detection_source = kitti_detections(poses)
    timer = StageTimer()
    previous_sink = system.attach_telemetry(timer)
    pipeline = system.local_mapper.object_pipeline
    # one keyframe's drain under torch.profiler: the second one that runs
    # object GN work
    profiled, drains = {}, [0]
    drain = system._drain_keyframes

    def profiled_drain():
        if not system.tracker.new_keyframes or profiled:
            return drain()
        drains[0] += 1
        if drains[0] < 2:
            return drain()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            drain()
            torch.cuda.synchronize()
        profiled["events"] = prof.key_averages()

    system._drain_keyframes = profiled_drain
    mark = launch_mark()
    kf_frames = []
    for k, (left, right) in enumerate(images):
        n_kf = len(system.map.keyframes)
        system.track_stereo(left, right, 0.1 * k)
        if len(system.map.keyframes) != n_kf:
            kf_frames.append(k)
    system.flush()
    torch.cuda.synchronize()
    attach_sink(previous_sink)
    k1, k2 = launches_since(mark)
    expected = pipeline.expected_k1_launches()
    tr = system.tracker
    n = len(images)
    lost = sum(1 for _, _, l in tr.trajectory if l)
    travel = float(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1).sum())
    ate = ate_rmse(trajectory_wc(tr), poses)["rmse"]
    objs = [o for o in system.map.objects.values() if not o.bad]
    print(f"[8b] dsp_slam.build_system (KITTI 00-02, random full-width DeepSDF, pipelined) over {n} "
          f"frames: {lost} lost, ATE {ate:.5f} m over {travel:.3f} m, {len(system.map.keyframes)} "
          f"keyframes, {len(system.map.points)} map points, {len(objs)} objects; GN calls "
          f"{pipeline.dispatches}; K1 launches {k1} (expected {expected}), K2 launches {k2} "
          f"({tr.n_redone} frames re-tracked) on {name}")
    check(len(tr.trajectory) == n and lost == 0, f"8b: {lost} lost frames")
    check(ate < 0.03 * travel, f"8b: ATE {ate} m >= 3% of {travel} m")
    check(k1 == expected and k1 > 0, f"8b: K1 launched {k1} times, expected {expected} (> 0)")
    check(k2 == n + tr.n_redone, f"8b: K2 launched {k2} times, expected {n} + {tr.n_redone}")
    for o in objs:
        check(bool(np.isfinite(o.T_wo).all() and np.isfinite(o.code).all()), f"8b: object {o.id} not finite")
    rep = timer.report()
    track = rep["track"]
    print(f"[8b] per frame: track mean {track['mean_ms']:.3f} ms, median {track['median_ms']:.3f} ms "
          f"(n={track['count']}); keyframe frames {kf_frames}: keyframe_drain "
          f"{[round(x * 1e3, 3) for x in timer.samples['keyframe_drain']]} ms, background_poll "
          f"{[round(x * 1e3, 3) for x in timer.samples['background_poll']]} ms")
    print("[8b] stages, host ms (mean / total / count): " + "; ".join(
        f"{k} {v['mean_ms']:.3f} / {v['total_ms']:.3f} / {v['count']}" for k, v in sorted(rep.items())))
    print(f"[8b] local BA solves, ms between CUDA events recorded around each solve's launches "
          f"(device time plus the device's waits for those launches): "
          f"{[round(b['device_ms'], 3) for b in system.local_mapper.ba_log]}; edges "
          f"{[b['n_edges'] for b in system.local_mapper.ba_log]}, edge inliers "
          f"{[b['edge_inliers'] for b in system.local_mapper.ba_log]}")
    print(f"[8b] object GN per keyframe, ms between CUDA events around its launches: "
          f"{[round(x, 3) for x in pipeline.gn_device_ms]}")
    check("events" in profiled, "8b: no keyframe drain was profiled")
    events = profiled["events"]
    key, busy = device_ms(events)
    k1_events = [e for e in events if "decoder_fused_kernel" in e.key]
    k1_ms = device_ms(k1_events)[1] if k1_events else 0.0
    print(f"[8b] profile of one keyframe drain: device busy {busy:.3f} ms, K1 {k1_ms:.3f} ms "
          f"({k1_ms / max(busy, 1e-9):.3f} of it)")
    print(events.table(sort_by=key, row_limit=20))
    return {"k1_launches": k1, "k2_launches": k2, "system": system, "timer": timer,
            "k1_share": k1_ms / max(busy, 1e-9)}


def mini_kitti_config(tmp: str) -> str:
    with open(os.path.join(MINI_KITTI, "config.template.json")) as f:
        text = f.read().replace("{SEQ}", os.path.abspath(MINI_KITTI))
    cfg = os.path.join(tmp, "mini_kitti.json")
    with open(cfg, "w") as f:
        f.write(text)
    return cfg


def phase_cli(tmp: str, name: str):
    """8c: dsp_slam.main over the mini-KITTI fixture (PNG pairs, velodyne,
    .lbl labels) on the card and on the CPU, both with K2's FAST response."""
    cfg = mini_kitti_config(tmp)
    cams = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"mini_{dev}")
        # the CPU run takes K2's two-tier FAST response (its plain version),
        # as the card does, in place of the CPU's default arc-min response
        with mock.patch.object(orb, "_use_k2", lambda backend, device: True):
            system = dsp_slam.main(["--sequence_dir", MINI_KITTI, "--config", cfg, "--map_dir", out,
                                    "--no_loop", "--device", dev])
        check(system.state.name == "OK", f"8c: {dev} run ends in {system.state}")
        cams[dev] = np.loadtxt(os.path.join(out, "Cameras.txt")).reshape(-1, 3, 4)
        pts = np.loadtxt(os.path.join(out, "MapPoints.txt")).reshape(-1, 3)
        lines = [ln for ln in open(os.path.join(out, "MapObjects.txt")).read().split("\n") if ln.strip()]
        check(len(lines) % 3 == 0 and len(lines) >= 3, f"8c: {dev} MapObjects.txt has {len(lines)} lines")
        for i in range(0, len(lines), 3):
            int(lines[i])
            check(len(lines[i + 1].split()) == 12 and len(lines[i + 2].split()) == 64,
                  f"8c: {dev} MapObjects.txt entry {i // 3} malformed")
        check(cams[dev].shape[0] == 3 and len(pts) > 100, f"8c: {dev} map files {cams[dev].shape}, {len(pts)} points")
        print(f"[8c] mini-KITTI CLI on {dev}: {cams[dev].shape[0]} cameras, {len(pts)} map points, "
              f"{len(lines) // 3} objects")
    d = float(np.abs(cams["cuda"] - cams["cpu"]).max())
    print(f"[8c] Cameras.txt card vs CPU: max |d| {d:.3e} on {name}")
    check(d <= 1e-3, f"8c: Cameras.txt differs from the CPU run by {d}")


def phase_mapping_sync_free(system):
    """One keyframe_matching and one bundle_adjust with camera-object edges,
    every input on the card, under torch.cuda.set_sync_debug_mode("error")."""
    kfs = [kf for _, kf in sorted(system.map.keyframes.items())]
    kf, nbs = kfs[-1], kfs[-3:-1]
    N, C = kf.n, keyframe_step.FUSE_CAP
    intr = system.local_mapper.intrinsics
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    rng = np.random.default_rng(5)
    kf_args = (kf.feats_torch(DEV), t(kf.T_cw), t((kf.map_point_ids >= 0).astype(np.float32)),
               t(np.zeros(N, np.float32)), [o.feats_torch(DEV) for o in nbs],
               t(np.stack([o.T_cw for o in nbs])), t(np.stack([(o.map_point_ids >= 0).astype(np.float32) for o in nbs])),
               t(np.ones(2, np.float32)), t((rng.normal(0, 5, (C, 3)) + [0, 0, 15]).astype(np.float32)),
               t(np.ones(C, np.float32)), t(rng.integers(0, 2**31, (C, 8)).astype(np.int32)),
               t(np.zeros(C, np.int32)), intr)
    # a window at the local mapper's smallest bucket: 16 keyframes, 1024
    # points, 4096 observations, 8 objects, 32 edges
    K, P, O, M, Q = 16, 1024, 4096, 8, 32
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-2, 2, P), rng.uniform(8, 30, P)], -1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 2, 3] = -0.5 * np.arange(K)
    obs_kf = rng.integers(0, K, O).astype(np.int32)
    obs_pt = rng.integers(0, P, O).astype(np.int32)
    pc = pts[obs_pt] + poses[obs_kf, :3, 3]
    cam = intr.cpu().numpy()
    uvr = np.stack([cam[0] * pc[:, 0] / pc[:, 2] + cam[2], cam[1] * pc[:, 1] / pc[:, 2] + cam[3],
                    cam[0] * pc[:, 0] / pc[:, 2] + cam[2] - cam[4] / pc[:, 2]], -1).astype(np.float32)
    T_wo = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    T_wo[:, :3, 3] = pts[:M]
    edge_kf, edge_obj = rng.integers(0, K, Q).astype(np.int32), rng.integers(0, M, Q).astype(np.int32)
    obj_state = {"poses": t(T_wo), "fixed": t(np.zeros(M, np.float32)), "edge_kf": t(edge_kf),
                 "edge_obj": t(edge_obj), "edge_Tco": t(poses[edge_kf] @ T_wo[edge_obj]),
                 "edge_valid": t(np.ones(Q, np.float32))}
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1
    ba_args = (t(poses), t(fixed), t(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
               t(np.ones(P, np.float32)), t(obs_kf), t(obs_pt), t(uvr + rng.normal(0, 0.5, uvr.shape).astype(np.float32)),
               t(np.ones(O, np.float32)), t(np.ones(O, np.float32)), t(np.ones(O, np.float32)), intr, 1e-3, obj_state)
    keyframe_step.keyframe_matching(*kf_args)
    ba.bundle_adjust(*ba_args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out_kf = keyframe_step.keyframe_matching(*kf_args)
        out_ba = ba.bundle_adjust(*ba_args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_ba["kf_poses"]).all() and torch.isfinite(out_ba["obj_poses"]).all()),
          "bundle_adjust gave non-finite poses")
    print(f"[8] keyframe_matching and bundle_adjust (K={K}, P={P}, O={O}, M={M}, Q={Q}) under "
          f"set_sync_debug_mode('error'): no host sync; {int(out_kf['tri_ok'].sum())} triangulations, "
          f"{int(out_ba['obs_inlier'].sum())} BA inliers, {int(out_ba['obj_edge_inlier'].sum())} edge inliers")


class SphereScene:
    """tests/test_mono_objects.py's scene at another camera: a far plane and
    large internally textured near patches (two depth layers) behind a
    radius-0.8 sphere with a blocky 3D texture, seen by a camera strafing
    along +x. Texture features keep their world size (pixel sizes scale
    with fx / 500, the test's focal length; counts with the image area).
    `dist` renders the lens's raw image: each raw pixel samples the scene
    at its undistorted position (rows beyond the canvas repeat its edge)."""

    FAR_Z, NEAR_Z = 8.0, 3.5
    CENTER = np.array([0.8, 0.25, 5.0], np.float32)
    RADIUS = 0.8

    def __init__(self, w: int, h: int, fx: float, cx: float, cy: float, dist=None, seed: int = 11):
        self.w, self.h, self.fx, self.cx, self.cy = w, h, fx, cx, cy
        self.K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32)
        uv = np.stack(np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)), -1)
        if undistort.has_distortion(dist):
            uv = undistort.undistort_points(uv.reshape(-1, 2), self.K, dist).reshape(h, w, 2)
        self.u, self.v = uv[..., 0], uv[..., 1]
        # the test's draws, in its order; at its camera (640 x 240, fx 500)
        # the same scene
        f = fx / 500.0
        n = w * h / (640 * 240) / f ** 2
        rng = np.random.default_rng(seed)
        far = rng.normal(80, 10, (h, 4 * w)).astype(np.float32)
        for _ in range(int(round(700 * n))):
            y, x = rng.integers(10, h - int(round(20 * f))), rng.integers(10, 4 * w - int(round(20 * f)))
            s = int(round(rng.integers(4, 12) * f))
            far[y: y + s, x: x + s] = rng.uniform(150, 230)
        near = np.full((h, 8 * w), np.nan, np.float32)
        for _ in range(int(round(150 * n))):
            y = rng.integers(10, h - int(round(48 * f)))
            x = rng.integers(10, 8 * w - int(round(48 * f)))
            s = int(round(rng.integers(24, 44) * f))
            patch = rng.normal(120, 25, (s, s)).astype(np.float32)
            for _ in range(6):
                py, px = rng.integers(2, s - int(round(10 * f)), 2)
                q = int(round(rng.integers(4, 8) * f))
                patch[py: py + q, px: px + q] = rng.uniform(30, 240)
            near[y: y + s, x: x + s] = patch
        self.far, self.near = far, near
        self.tex = np.random.default_rng(5).uniform(30, 235, (64,) * 3).astype(np.float32)

    def _layer(self, tex, z, cam_x):
        cols = np.clip(np.round(self.u + self.w + self.fx * cam_x / z).astype(np.int64), 0, tex.shape[1] - 1)
        rows = np.clip(np.round(self.v).astype(np.int64), 0, tex.shape[0] - 1)
        return tex[rows, cols]

    def sphere_hit(self, cam_x: float):
        """(mask (h, w), world points where the raw pixels' rays hit)."""
        d = np.stack([(self.u - self.cx) / self.fx, (self.v - self.cy) / self.fx, np.ones_like(self.u)], -1)
        c = self.CENTER - np.array([cam_x, 0, 0], np.float32)
        b = d @ c
        dd = np.sum(d * d, axis=-1)
        disc = b * b - dd * (c @ c - self.RADIUS ** 2)
        t = (b - np.sqrt(np.maximum(disc, 0.0))) / np.maximum(dd, 1e-9)
        hit = (disc > 0) & (t > 0.1)
        return hit, t[..., None] * d + np.array([cam_x, 0, 0], np.float32)

    def render(self, cam_x: float) -> np.ndarray:
        img = self._layer(self.far, self.FAR_Z, cam_x)
        near = self._layer(self.near, self.NEAR_Z, cam_x)
        img = np.where(np.isnan(near), img, near)
        hit, p = self.sphere_hit(cam_x)
        idx = np.floor(p[hit] * 20.0).astype(np.int64) % 64
        img[hit] = self.tex[idx[:, 0], idx[:, 1], idx[:, 2]]
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    def label(self, cam_x: float):
        """(box (1, 4) [l, t, r, b], mask (1, h, w)) of the sphere, or None."""
        hit, _ = self.sphere_hit(cam_x)
        if hit.sum() < 1200:
            return None
        ys, xs = np.nonzero(hit)
        return np.array([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]], np.float32), hit[None]


MONO_FRAMES = 40             # 9d's sequence (its first 16 frames)
SPHERE_STEP = 0.15
SPHERE_FRAMES = 26
FREIBURG_CONFIG = "configs/freiburg_001.json"


def mono_level_maps(img: np.ndarray, params) -> list:
    """The 8 (h, w) level maps of one mono frame on the card, in the order
    `orb.extract` gives them to K2."""
    t = torch.from_numpy(img).to(DEV).float()
    return [t if level == 0 else orb.resize(t, h, w).contiguous()
            for level, (h, w) in enumerate(orb.level_shapes(params, *img.shape))]


def phase_mono_fast(name: str) -> dict:
    """9: K2 on the 8 level maps of a Freiburg-shaped mono frame (960x540
    ... 268x151, resized levels non-integer) in one launch: exact against
    its plain version; time per frame in turns plain, kernel, kernel,
    plain."""
    params = orb.ORBParams(n_features=4000, n_levels=8)
    world, _, poses = benchmark_slam.mono_sequence("freiburg", 2)
    img = np.clip(world.render_pose(poses[0]), 0, 255).astype(np.uint8)
    levels = mono_level_maps(img, params)
    t_lo, t_hi = float(params.min_threshold), float(params.fast_threshold)
    mark = launch_mark()
    outs = fast_score.fast_score_maps(levels, t_lo, t_hi, orb.BOOST)
    torch.cuda.synchronize()
    check(launches_since(mark)[1] == 1, "K2 took more than one launch for a mono frame")
    refs = fast_score.fast_score_maps_plain(levels, t_lo, t_hi, orb.BOOST)
    max_err = 0.0
    for x, out, ref in zip(levels, outs, refs):
        max_err = max(max_err, float((out - ref).abs().max()))
        check(bool(torch.equal(out, ref)), f"K2 differs from its plain version on a {tuple(x.shape)} mono level")
    runs = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        fn = fast_score.fast_score_maps if path == "kernel" else fast_score.fast_score_maps_plain
        runs[path].append(cuda_ms(lambda: fn(levels, t_lo, t_hi, orb.BOOST), 50))
    ms = {k: float(np.mean(v)) for k, v in runs.items()}
    dev = kernel_device_ms(lambda: fast_score.fast_score_maps(levels, t_lo, t_hi, orb.BOOST),
                           50, "fast_score_maps_kernel")
    px = sum(x.numel() for x in levels)
    corners = sum(int((r != 0).sum()) for r in refs)
    b, by = k2_bound(px, corners)
    print(f"[9] K2 vs plain on the 8 level maps of a Freiburg-shaped mono frame "
          f"({' '.join(f'{h}x{w}' for h, w in (tuple(x.shape) for x in levels))}), one launch: exact; "
          f"time per frame kernel {ms['kernel']:.5f} ms ({runs['kernel'][0]:.5f}, {runs['kernel'][1]:.5f}; "
          f"device {dev:.5f}), plain {ms['plain']:.5f} ms ({runs['plain'][0]:.5f}, {runs['plain'][1]:.5f}), "
          f"bound {b:.5f} ms ({by}; {px} px, {corners} low-tier corners) on {name}")
    return {"max_abs_err": max_err, "ms": ms["kernel"], "plain_ms": ms["plain"], "device_ms": dev,
            "bound_ms": b, "bound_by": by}


def phase_mono_tracking(name: str) -> dict:
    """9a: the mono arm of benchmark_slam at Freiburg's camera (960x540, fx
    930.2, 4000 features, 8 levels): the bench entry's `mono_freiburg` arm
    (30 frames, pipelined), then the same 30 frames not pipelined: two-view
    initialization within the first 10 frames, 0 frames lost after it,
    Sim(3)-aligned ATE < 3% of travel, K2 once per extracted frame; then the
    entry's `paced` arm (30 frames at 25 fps, stale ones dropped): its drop
    rate, K2 once per extracted frame."""
    out = {"launches": 0, "k2": {}, "seconds": {}}
    # the non-pipelined run takes the entry's 30-frame sequence too: a
    # shorter one yaws its 20 degrees within 8 frames, and the mono gauge
    # drifts past 3% of travel on it
    runs = (("pipelined", bench.mono_freiburg),
            ("non-pipelined", lambda dev: bench.slam(
                ["--frames", str(bench.MONO_FRAMES), "--mono", "--mono_profile", "freiburg", "--no_pipeline"], dev)),
            ("paced", bench.paced))
    for form, run in runs:
        # the main path: launches counted from just before to just after
        mark = launch_mark()
        t0 = time.perf_counter()
        rec = run(DEV)
        out["seconds"][form] = time.perf_counter() - t0
        k1, k2 = launches_since(mark)
        out["launches"] += k2
        out["k2"][form] = k2
        out[form] = rec
        check(k2 == rec["frames_tracked"] + rec["n_redone"],
              f"9a {form}: K2 launched {k2} times, expected {rec['frames_tracked']} + {rec['n_redone']}")
        check(k1 == 0, f"9a {form}: K1 ran on the mono tracking path")
        if form == "paced":
            print(f"[9a] mono pipelined, paced at 25 fps: drop rate {rec['drop_rate']:.4f} "
                  f"({rec['frames_tracked']} frames tracked of {rec['frames']}), {rec['value']:.3f} fps mean on "
                  f"the frames it took, {rec['lost_after_init']} lost after initialization; K2 launches {k2} "
                  f"on {name}")
            check(0.0 <= rec["drop_rate"] <= 1.0, f"9a paced: drop rate {rec['drop_rate']}")
            continue
        print(f"[9a] mono {form}, {rec['frames']} frames at {rec['width']}x{rec['height']}: initialized at "
              f"frame {rec['init_frame']}, {rec['lost_after_init']} lost after it, ATE (Sim(3)-aligned) "
              f"{rec['ate_rmse_cm']} cm over {rec['travel_m']:.2f} m ({rec['ate_frac_of_travel']} of travel); "
              f"{rec['n_keyframes']} keyframes, {rec['n_points']} map points; {rec['value']:.3f} fps mean, "
              f"{rec['median_fps']:.3f} median, p99 frame {rec['frame_ms_p99']:.3f} ms; K2 launches {k2} "
              f"({rec['frames_tracked']} frames + {rec['n_redone']} re-tracked), K1 {k1} on {name}")
        print(f"[9a] mono {form} stages (p50 / p95 / total ms, n): " + "; ".join(
            f"{k} {v['p50']:.3f} / {v['p95']:.3f} / {v['total']:.3f}, {v['n']}" for k, v in rec["stage_ms"].items()))
        check(rec["init_frame"] is not None and rec["init_frame"] < 10,
              f"9a {form}: initialized at frame {rec['init_frame']}")
        check(rec["lost_after_init"] == 0, f"9a {form}: {rec['lost_after_init']} frames lost after initialization")
        check(rec["ate_frac_of_travel"] is not None and rec["ate_frac_of_travel"] < 0.03,
              f"9a {form}: ATE {rec['ate_rmse_cm']} cm >= 3% of {rec['travel_m']} m")
    return out


def phase_mono_profile(name: str) -> dict:
    """9a: 4 steady pipelined mono frames at Freiburg's camera under
    torch.profiler (device activity); the Hamming matrices at 4000 features (the
    initialization's 4000 x 4000 window match and a projection search
    against LOCAL_POINT_CAP points), timed and with their peak memory; one
    chained mono program under set_sync_debug_mode("error")."""
    world, cam, poses = benchmark_slam.mono_sequence("freiburg", 20)
    imgs = render_poses(lambda T: np.clip(world.render_pose(T), 0, 255).astype(np.uint8), poses[:20])
    system = benchmark_slam.mono_system(cam, True, DEV)
    for k in range(12):
        system.track_mono(imgs[k], 0.1 * k)
    tr = system.tracker
    check(tr.state == tracking.State.OK, f"9a profile run: tracker {tr.state} after 12 frames")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(12, 16):
        system.track_mono(imgs[k], 0.1 * k)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / 4
    # device activity only: the host-side operator records of ~10^4
    # launches per frame cost the profiler minutes to summarise
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(16, 20):
            system.track_mono(imgs[k], 0.1 * k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    key, busy_ms = device_ms(events)
    print(f"[9a] profile, 4 pipelined mono frames: wall {wall_ms:.3f} ms under the profiler, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / 4:.3f} ms/frame); idle share {1 - busy_ms / wall_ms:.3f} of the "
          f"profiled wall, {1 - busy_ms / 4 / plain_wall_ms:.3f} of the unprofiled {plain_wall_ms:.3f} "
          f"ms/frame (frames 12-15)")
    print(events.table(sort_by=key, row_limit=15))

    feats = [orb.extract(tr._upload_image(imgs[k]), tr.orb_params) for k in (0, 1)]
    n = feats[0]["xy"].shape[0]
    cand = torch.from_numpy(np.random.default_rng(6).integers(
        -2**31, 2**31, (tracking.LOCAL_POINT_CAP, 8)).astype(np.int32)).to(DEV)
    mem, t = {}, {}
    for what, fn in (("window", lambda: matcher.match_in_windows(feats[0], feats[1], radius=100.0)),
                     ("hamming_window", lambda: matcher.hamming_matrix(feats[0]["desc"], feats[1]["desc"])),
                     ("hamming_projection", lambda: matcher.hamming_matrix(cand, feats[1]["desc"]))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        mem[what] = (torch.cuda.max_memory_allocated() - base) / 2**20
        t[what] = cuda_ms(fn, 10)
    share = 2 * t["hamming_projection"] / max(busy_ms / 4, 1e-9)
    print(f"[9a] Hamming matrices at {n} features: match_in_windows {n} x {n} {t['window']:.3f} ms, peak "
          f"{mem['window']:.1f} MiB above the live set (hamming_matrix alone {t['hamming_window']:.3f} ms, "
          f"{mem['hamming_window']:.1f} MiB); a projection search's {tracking.LOCAL_POINT_CAP} x {n} "
          f"hamming_matrix {t['hamming_projection']:.3f} ms, {mem['hamming_projection']:.1f} MiB; two per "
          f"tracked frame are {share:.3f} of its device time on {name}")

    (img,) = tr._upload("mono", (imgs[-1],))
    _, local = tr._local_pack()
    if tr._chain is None:
        tr._seed_chain()
    args = (tr.orb_params, tr._radii(), float(tr.cfg.velocity_smoothing), img, tr.intrinsics, *tr._chain, *local)
    frame_step.track_frame_mono_chained(*args)          # constants cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, result, _ = frame_step.track_frame_mono_chained(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(result["T_cw"]).all()), "chained mono program gave a non-finite pose")
    print(f"[9a] track_frame_mono_chained under set_sync_debug_mode('error'): no host sync; "
          f"{int(result['n_inliers'])} inliers")
    system.flush()
    return {"busy_ms_per_frame": busy_ms / 4, "hamming_ms": t, "hamming_mib": mem}


def sphere_run(scene, pipeline_factory, frames: int = SPHERE_FRAMES, profile_recon: bool = False):
    """SLAMSystem.track_mono with a MonoObjectPipeline over the sphere
    scene (Freiburg's ORB: 4000 features, 8 levels); with profile_recon,
    the first keyframe drain that runs object GN under torch.profiler."""
    cam_xs = [k * SPHERE_STEP for k in range(frames)]

    def detections(idx):
        lab = scene.label(cam_xs[min(idx, frames - 1)])
        if lab is None:
            return []
        det = build_mono_detection(lab[1], lab[0], np.linalg.inv(scene.K), min_mask_area=1000.0)
        return [det] if det is not None else []

    system = SLAMSystem(
        tracker_cfg=tracking.TrackerConfig(fx=scene.fx, fy=scene.fx, cx=scene.cx, cy=scene.cy,
                                           width=scene.w, height=scene.h, max_frames_between_kf=3,
                                           search_radius_motion=40.0 * scene.fx / 500.0),
        orb_params=orb.ORBParams(n_features=4000, n_levels=8), object_pipeline_factory=pipeline_factory,
        detection_source=detections, device=DEV)
    pipeline = system.local_mapper.object_pipeline
    profiled, drain = {}, system._drain_keyframes

    def profiled_drain():
        c, new = pipeline.kf_count, len(system.tracker.new_keyframes)
        recon = any(i >= pipeline.warmup_kfs and i % pipeline.recon_every == 0 for i in range(c + 1, c + new + 1))
        if not (profile_recon and recon and not profiled):
            return drain()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            drain()
            torch.cuda.synchronize()
        profiled["events"] = prof.key_averages()

    system._drain_keyframes = profiled_drain
    for k, x in enumerate(cam_xs):
        system.track_mono(scene.render(x), 0.1 * k)
    system.flush()
    torch.cuda.synchronize()
    return system, cam_xs, profiled.get("events")


def phase_mono_objects(name: str) -> dict:
    """9b: SLAMSystem with MonoObjectPipeline over the sphere scene at
    Freiburg's camera: the analytic sphere decoder (the object's centre
    within 0.5 R of the truth after gauge alignment), then phase 4's seeded
    random full-width DeepSDF (finite objects, K1 launched exactly as the
    pipeline's GN calls need, the span of each GN call, K1's share of one
    reconstructing keyframe's drain)."""
    scene = SphereScene(960, 540, 930.2, 480.0, 270.0)
    sphere = deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=8, device=DEV))

    def sphere_factory(slam_map):
        return MonoObjectPipeline(slam_map, sphere, gn.GNConfig(code_len=8, k4=0.0, num_iterations=8,
                                                                max_grad_points=256),
                                  max_surface_points=128, max_rays=256, voxels_dim=17,
                                  warmup_kfs=5, recon_every=2)

    system, cam_xs, _ = sphere_run(scene, sphere_factory)
    kfs = sorted(system.map.keyframes.values(), key=lambda kf: kf.id)
    lost = sum(1 for _, _, l in system.tracker.trajectory if l)
    objs = [o for o in system.map.objects.values() if not o.bad and getattr(o, "has_valid_pose", False)]
    check(system.state == tracking.State.OK and len(kfs) >= 6, f"9b: {system.state}, {len(kfs)} keyframes")
    check(len(objs) >= 1, "9b: no object survived the GN reconstruction")
    # the mono gauge: the first keyframe's camera is the world origin, the
    # map's scale from the known camera step
    x0, x1 = (cam_xs[int(round(kf.timestamp / 0.1))] for kf in (kfs[0], kfs[-1]))
    s = np.linalg.norm(kfs[-1].T_wc[:3, 3] - kfs[0].T_wc[:3, 3]) / abs(x1 - x0)
    obj = max(objs, key=lambda o: len(o.point_ids))
    err = float(np.linalg.norm(obj.T_wo[:3, 3] / s - (scene.CENTER - [x0, 0, 0])))
    print(f"[9b] mono objects, sphere decoder, {len(cam_xs)} frames: {lost} lost, {len(kfs)} keyframes, "
          f"{len(system.map.points)} map points, {len(objs)} reconstructed objects, the largest with "
          f"{len(obj.point_ids)} member points; centre error {err:.4f} m (limit {0.5 * scene.RADIUS} m) on {name}")
    check(err < 0.5 * scene.RADIUS, f"9b: object centre {err} m from the truth")

    dec = deepsdf.params_from_jax(canonical_params_np(seed=2), device=DEV)
    opt = SystemConfig.from_json(FREIBURG_CONFIG).optimizer

    def deepsdf_factory(slam_map):
        return MonoObjectPipeline(slam_map, dec, opt, voxels_dim=32, warmup_kfs=5, recon_every=2)

    mark = launch_mark()
    system, _, events = sphere_run(scene, deepsdf_factory, profile_recon=True)
    k1, k2 = launches_since(mark)
    pipeline = system.local_mapper.object_pipeline
    expected = pipeline.expected_k1_launches()
    objs = [o for o in system.map.objects.values() if not o.bad]
    print(f"[9b] mono objects, random full-width DeepSDF (freiburg_001.json's optimizer, "
          f"{opt.num_iterations} GN iterations): {len(objs)} objects, GN calls {pipeline.gn_calls} "
          f"(batches {pipeline.gn_batches}); K1 launches {k1} (expected {expected}), K2 {k2} "
          f"({len(system.tracker.trajectory)} frames + {system.tracker.n_redone} re-tracked); each object "
          f"GN call, ms between CUDA events around its launches: "
          f"{[round(x, 3) for x in pipeline.gn_device_ms]} on {name}")
    check(k1 == expected and k1 > 0, f"9b: K1 launched {k1} times, expected {expected} (> 0)")
    check(k2 == len(system.tracker.trajectory) + system.tracker.n_redone, f"9b: K2 launched {k2} times")
    for o in objs:
        check(bool(np.isfinite(o.T_wo).all() and np.isfinite(o.code).all()), f"9b: object {o.id} not finite")
    check(events is not None, "9b: no reconstructing keyframe drain was profiled")
    key, busy = device_ms(events)
    k1_events = [e for e in events if "decoder_fused_kernel" in e.key]
    k1_ms = device_ms(k1_events)[1] if k1_events else 0.0
    print(f"[9b] profile of one reconstructing mono keyframe's drain (triangulation, object GN, mesh): "
          f"device busy {busy:.3f} ms, K1 {k1_ms:.3f} ms ({k1_ms / max(busy, 1e-9):.3f} of it)")
    print(events.table(sort_by=key, row_limit=15))
    return {"k1_launches": k1, "k1_share": k1_ms / max(busy, 1e-9), "gn_ms": pipeline.gn_device_ms}


def write_mono_fixture(root: str, scene: SphereScene, frames: int) -> str:
    """A mono sequence in dsp_slam_mono's layout: image_0/*.png (raw,
    lens-distorted renders of the sphere scene) and labels/*.npz (the
    sphere's box and mask), with a config from configs/freiburg_001.json
    naming the labels. Returns the config's path."""
    from PIL import Image

    os.makedirs(os.path.join(root, "image_0"))
    for k in range(frames):
        x = k * SPHERE_STEP
        Image.fromarray(scene.render(x)).convert("RGB").save(os.path.join(root, "image_0", f"{k:06d}.png"))
        lab = scene.label(x)
        if lab is not None:
            offline.save_labels_npz(os.path.join(root, "labels"), os.path.join(root, "labels_3d"), k,
                                    np.zeros((0, 7), np.float32), lab[0], lab[1])
    cfg = SystemConfig.from_json(FREIBURG_CONFIG)
    cfg = dataclasses.replace(cfg, detection=dataclasses.replace(
        cfg.detection, path_label_2d=os.path.join(root, "labels")))
    path = os.path.join(root, "config.json")
    cfg.to_json(path)
    return path


def phase_mono_cli(tmp: str, name: str):
    """9c: dsp_slam_mono.main over a 6-frame mono fixture (PNGs, .npz 2D
    labels, freiburg_001.json's lens) on the card and on the CPU, both with
    K2's FAST response: the map files parse and trajectory_tum.txt agrees
    within 1e-3."""
    cam = SystemConfig.from_json(FREIBURG_CONFIG).camera
    scene = SphereScene(cam.width, cam.height, cam.fx, cam.cx, cam.cy,
                        dist=(cam.k1, cam.k2, cam.p1, cam.p2, cam.k3))
    seq = os.path.join(tmp, "mono_seq")
    cfg = write_mono_fixture(seq, scene, 6)
    traj = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"mono_{dev}")
        t0 = time.perf_counter()
        with mock.patch.object(orb, "_use_k2", lambda backend, device: True):
            system = dsp_slam_mono.main(["--sequence_dir", seq, "--config", cfg, "--map_dir", out,
                                         "--device", dev])
        wall = time.perf_counter() - t0
        traj[dev] = np.loadtxt(os.path.join(out, "trajectory_tum.txt")).reshape(-1, 8)
        pts = np.loadtxt(os.path.join(out, "MapPoints.txt")).reshape(-1, 3)
        cams = np.loadtxt(os.path.join(out, "Cameras.txt")).reshape(-1, 3, 4)
        lines = [ln for ln in open(os.path.join(out, "MapObjects.txt")).read().split("\n") if ln.strip()]
        check(len(lines) % 3 == 0, f"9c: {dev} MapObjects.txt has {len(lines)} lines")
        for i in range(0, len(lines), 3):
            int(lines[i])
            check(len(lines[i + 1].split()) == 12 and len(lines[i + 2].split()) == 64,
                  f"9c: {dev} MapObjects.txt entry {i // 3} malformed")
        check(system.state.name == "OK" and len(traj[dev]) >= 4 and len(cams) == len(traj[dev]) and len(pts) > 50,
              f"9c: {dev} run: {system.state}, {len(traj[dev])} poses, {len(pts)} map points")
        print(f"[9c] mono CLI on {dev} ({wall:.1f} s): {len(traj[dev])} tracked poses, {len(pts)} map points, "
              f"{len(lines) // 3} objects")
    check(traj["cuda"].shape == traj["cpu"].shape, f"9c: {traj['cuda'].shape} vs {traj['cpu'].shape} poses")
    d = float(np.abs(traj["cuda"] - traj["cpu"]).max())
    print(f"[9c] trajectory_tum.txt card vs CPU: max |d| {d:.3e} on {name}")
    check(d <= 1e-3, f"9c: trajectory_tum.txt differs from the CPU run by {d}")


def phase_rgbd(name: str) -> int:
    """9d: SLAMSystem.track_rgbd fused and pipelined over the first 16
    frames of the mono arm's 40-frame sequence (its view yaw
    starts at frame 13) with the true depth images (Freiburg's camera, bf =
    0.5 fx, the mono arm's 25 px motion search): 0 lost frames, ATE < 3% of
    travel, one K2 launch per frame."""
    n = 16
    world, cam, poses = benchmark_slam.mono_sequence("freiburg", MONO_FRAMES)
    w, h, fx, cx, cy = cam
    frames = render_poses(lambda T: (np.clip(world.render_pose(T), 0, 255).astype(np.uint8),
                                     world.depth_map_pose(T)), poses[:n])
    travel = float(np.linalg.norm(np.diff(poses[:n, :3, 3], axis=0), axis=1).sum())
    launches = 0
    for pipelined in (False, True):
        form = "pipelined" if pipelined else "fused"
        system = SLAMSystem(
            tracker_cfg=tracking.TrackerConfig(fx=fx, fy=fx, cx=cx, cy=cy, bf=fx * 0.5, width=w, height=h,
                                               min_init_features=400, max_frames_between_kf=5,
                                               search_radius_motion=25.0, pipelined=pipelined),
            orb_params=orb.ORBParams(n_features=4000, n_levels=8), device=DEV)
        mark = launch_mark()
        t0 = time.perf_counter()
        for k, (img, depth) in enumerate(frames):
            system.track_rgbd(img, depth, 0.1 * k)
        system.flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
        k2 = launches_since(mark)[1]
        launches += k2
        tr = system.tracker
        lost = sum(1 for _, _, l in tr.trajectory if l)
        ate = ate_rmse(trajectory_wc(tr), poses[:n])["rmse"]
        print(f"[9d] RGB-D {form}: {len(tr.trajectory)} frames, {lost} lost, ATE {ate:.5f} m over {travel:.2f} m, "
              f"{len(system.map.keyframes)} keyframes, {len(system.map.points)} map points; K2 launches {k2} "
              f"({tr.n_redone} re-tracked); {wall:.3f} ms per frame (synchronised wall) on {name}")
        check(len(tr.trajectory) == n and lost == 0, f"9d {form}: {lost} lost frames")
        check(ate < 0.03 * travel, f"9d {form}: ATE {ate} m >= 3% of {travel} m")
        check(k2 == n + tr.n_redone, f"9d {form}: K2 launched {k2} times, expected {n} + {tr.n_redone}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: slice 5 (place recognition, relocalization, loop closing,
# checkpoints, mesh export)

# the JAX package's long-loop record on the TPU (BENCH_r04.json): ATE before
# and after the loop correction, cm. An accuracy mark, not a speed claim.
JAX_TPU_LONG_LOOP_CM = (115.61, 6.21)
RELOC_WITHIN = 2         # frames after the blackout by which 10b must relocalize
BLACKOUT = range(12, 15)


def events_ms(spans) -> list:
    """ms between each (start, stop) CUDA event pair (after a synchronize)."""
    return [a.elapsed_time(b) for a, b in spans]


def around_launches(spans: list, fn):
    """`fn` with a CUDA event recorded before and after each call: their
    span is the device time of the call's launches plus the device's waits
    for them."""
    def run(*args, **kw):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        stop.record()
        spans.append((start, stop))
        return out
    return run


def vocabulary_from(imgs, params, branching: int, levels: int) -> Vocabulary:
    """A vocabulary trained in-process on the ORB descriptors of `imgs`."""
    descs = []
    for img in imgs:
        f = orb.extract(torch.from_numpy(np.ascontiguousarray(img)).to(DEV), params)
        descs.append(f["desc"].cpu().numpy().view(np.uint32)[f["valid"].cpu().numpy() > 0])
    return Vocabulary.train(np.concatenate(descs), branching=branching, levels=levels, seed=0, device=DEV)


def phase_long_loop(name: str) -> dict:
    """10a: the bench entry's `long_loop` arm (benchmark_slam --frames 100
    --long_loop: 201 keyframes, one loop, a vocabulary trained in-process) on
    the card; the essential-graph and global-BA
    solves timed with CUDA events around their launches; then one
    `_dispatch_global_ba` and one `optimize_pose_graph` at the run's shapes
    under set_sync_debug_mode("error")."""
    spans = {"pose_graph": [], "gba": []}
    seen = {}
    dispatch = loop_closing.LoopCloser._dispatch_global_ba
    solve = pose_graph.optimize_pose_graph

    def capture_dispatch(self, kf, loop_kf):
        seen["gba"] = (self, kf, loop_kf)
        return dispatch(self, kf, loop_kf)

    def capture_solve(*args, **kw):
        seen["pose_graph"] = (args, kw)
        return solve(*args, **kw)

    mark = launch_mark()
    with mock.patch.object(loop_closing.LoopCloser, "_dispatch_global_ba", capture_dispatch), \
            mock.patch.object(pose_graph, "optimize_pose_graph", around_launches(spans["pose_graph"], capture_solve)), \
            mock.patch.object(ba, "global_bundle_adjust", around_launches(spans["gba"], ba.global_bundle_adjust)):
        t0 = time.perf_counter()
        rec = bench.long_loop(DEV)
        seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    k1, k2 = launches_since(mark)
    pg_ms, gba_ms = events_ms(spans["pose_graph"]), events_ms(spans["gba"])
    before, after = rec["ate_before_loop_cm"], rec["ate_after_loop_cm"]
    print(f"[10a] benchmark_slam --long_loop: {rec['loop_kfs']} keyframes, loops closed "
          f"{rec['loops_closed']}, ATE {before:.4f} -> {after:.4f} cm (the JAX package on the TPU, "
          f"BENCH_r04: {JAX_TPU_LONG_LOOP_CM[0]} -> {JAX_TPU_LONG_LOOP_CM[1]} cm), loop wall "
          f"{rec['loop_wall_s']:.3f} s; essential-graph solves {[round(x, 3) for x in pg_ms]} ms, "
          f"global BA {[round(x, 3) for x in gba_ms]} ms between CUDA events around their launches; "
          f"K1 {k1}, K2 {k2} launches on {name}")
    check(rec["loops_closed"] == 1, f"10a: {rec['loops_closed']} loops closed, expected 1")
    check(after <= 0.1 * before, f"10a: ATE after {after} cm > 10% of before {before} cm")
    check(len(pg_ms) >= 1 and len(gba_ms) == 1, f"10a: {len(pg_ms)} pose-graph and {len(gba_ms)} GBA solves")

    closer, kf, loop_kf = seen["gba"]
    args, kw = seen["pose_graph"]
    solve(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = dispatch(closer, kf, loop_kf)
        out = solve(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    res = tracking._host_result(pending["host"], pending["event"])["out"]
    check(bool(np.isfinite(res["kf_poses"]).all() and torch.isfinite(out).all()),
          "10a: non-finite GBA or pose-graph result")
    print(f"[10a] _dispatch_global_ba (K={loop_closing.GBA_KF_CAP}, P={loop_closing.GBA_PT_CAP}, "
          f"O={loop_closing.GBA_OBS_CAP}) and optimize_pose_graph (K={args[0].shape[0]}, "
          f"E={args[2].shape[0]}) under set_sync_debug_mode('error'): no host sync")
    # where a dense essential-graph solve's time goes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(*args, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    key, busy = device_ms(events)
    n_kernels = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[10a] profile of one optimize_pose_graph: wall {wall:.3f} ms under the profiler, device busy "
          f"{busy:.3f} ms ({n_kernels} kernel launches), idle share {1 - busy / wall:.3f}")
    print(events.table(sort_by=key, row_limit=12))
    return {"record": rec, "pose_graph_ms": pg_ms, "gba_ms": gba_ms, "pose_graph_busy_ms": busy, "seconds": seconds}


def phase_relocalization(system_cfg, images, poses, params, name: str) -> dict:
    """10b: SLAMSystem.track_stereo at KITTI 00-02's settings with
    attach_vocabulary (a K=10, L=3 vocabulary trained on frames 0, 5 and 10)
    over phase 7's turn with frames 12-14 blank: LOST on the blackout,
    relocalized within RELOC_WITHIN frames after it, no frame lost after
    that, ATE over the tracked frames < 3% of travel, K2 once per extracted
    frame."""
    voc = vocabulary_from([images[k][0] for k in (0, 5, 10)], params, 10, 3)
    system = dsp_slam.build_system(system_cfg, None, enable_objects=False, device=DEV, vocabulary=voc,
                                   enable_loop=False)
    blank = np.zeros_like(images[0][0])
    mark = launch_mark()
    t0 = time.perf_counter()
    for k, (left, right) in enumerate(images):
        if k in BLACKOUT:
            left = right = blank
        system.track_stereo(left, right, 0.1 * k)
    system.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = launches_since(mark)[1]
    tr = system.tracker
    lost = [l for _, _, l in tr.trajectory]
    n = len(images)
    end = BLACKOUT[-1] + 1
    back = next((k for k in range(end, n) if not lost[k]), None)
    ok = [k for k in range(n) if not lost[k]]
    sel = np.asarray(ok)
    travel = float(np.linalg.norm(np.diff(poses[sel, :3, 3], axis=0), axis=1).sum())
    ate = ate_rmse(trajectory_wc(tr)[sel], poses[sel])["rmse"]
    print(f"[10b] relocalization: blank frames {list(BLACKOUT)}, lost frames "
          f"{[k for k in range(n) if lost[k]]}, back at frame {back}, {len(system.kf_db.vectors)} keyframes "
          f"in the database; ATE {ate:.5f} m over {travel:.3f} m of tracked frames; K2 launches {k2} "
          f"({tr.n_redone} re-tracked); {wall / n * 1e3:.3f} ms per frame on {name}")
    check(all(lost[k] for k in BLACKOUT), "10b: a blank frame was not lost")
    check(back is not None and back - end <= RELOC_WITHIN, f"10b: relocalized at {back}, blackout ended {end}")
    check(not any(lost[back:]), f"10b: lost frames after relocalizing: {[k for k in range(back, n) if lost[k]]}")
    check(not any(lost[:BLACKOUT[0]]), "10b: lost frames before the blackout")
    check(ate < 0.03 * travel, f"10b: ATE {ate} m >= 3% of {travel} m")
    check(k2 == n + tr.n_redone, f"10b: K2 launched {k2} times, expected {n} + {tr.n_redone}")
    return {"k2_launches": k2, "back": back, "ate": ate, "voc": voc}


def phase_loop_slam(system_cfg, exp_dir: str, images, poses, voc, drain_8b: list, name: str) -> dict:
    """10c: 8b's system (dsp_slam.build_system, the random full-width
    DeepSDF, pipelined) with loop closing enabled, over phase 7's turn (no
    revisit): 0 loops closed, 0 lost, K1 and K2 counted; each
    insert_keyframe timed on the host around the call; the keyframe drains
    beside 8b's."""
    cfg = dataclasses.replace(system_cfg, deepsdf_dir=exp_dir)
    system = dsp_slam.build_system(cfg, None, pipelined=True, vocabulary=voc)
    system.detection_source = kitti_detections(poses)
    timer = StageTimer()
    previous_sink = system.attach_telemetry(timer)
    closer = system.loop_closer
    insert = closer.insert_keyframe
    insert_ms = []

    def timed_insert(kf):
        t0 = time.perf_counter()
        out = insert(kf)
        insert_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    closer.insert_keyframe = timed_insert
    mark = launch_mark()
    for k, (left, right) in enumerate(images):
        system.track_stereo(left, right, 0.1 * k)
    system.flush()
    torch.cuda.synchronize()
    attach_sink(previous_sink)
    k1, k2 = launches_since(mark)
    expected = system.local_mapper.object_pipeline.expected_k1_launches()
    tr = system.tracker
    n = len(images)
    lost = sum(1 for _, _, l in tr.trajectory if l)
    drains = [x * 1e3 for x in timer.samples["keyframe_drain"]]
    print(f"[10c] stereo object SLAM with loop closing (KITTI 00-02, random full-width DeepSDF, "
          f"pipelined): {lost} lost, loops closed {closer.loops_closed}, {len(system.map.keyframes)} "
          f"keyframes, {len(system.kf_db.vectors)} in the database; K1 launches {k1} (expected "
          f"{expected}), K2 {k2}; insert_keyframe ms {[round(x, 3) for x in insert_ms]} (mean "
          f"{np.mean(insert_ms):.3f}); keyframe_drain mean {np.mean(drains):.3f} / median "
          f"{np.median(drains):.3f} ms over {len(drains)}, 8b's without the loop closer "
          f"{np.mean(drain_8b):.3f} / {np.median(drain_8b):.3f} ms over {len(drain_8b)} (its "
          f"one drain under the profiler included) on {name}")
    check(closer.loops_closed == 0, f"10c: {closer.loops_closed} false loops")
    check(len(tr.trajectory) == n and lost == 0, f"10c: {lost} lost frames")
    check(k1 == expected and k1 > 0, f"10c: K1 launched {k1} times, expected {expected} (> 0)")
    check(k2 == n + tr.n_redone, f"10c: K2 launched {k2} times, expected {n} + {tr.n_redone}")
    check(len(insert_ms) == len(system.kf_db.vectors) >= 2, f"10c: {len(insert_ms)} keyframes inserted")
    system.map.check_invariants()
    return {"k1_launches": k1, "k2_launches": k2, "insert_ms": insert_ms, "drain_ms": drains}


def chain_map(n_kf: int, drift_per_kf: float, step: float = 0.5):
    """tests/test_pose_graph_scale.py's `_chain_map`: an out-and-back street
    (truth x 0 -> L -> 0) whose estimates drift linearly; the spanning tree
    is the chain, with strong covisibility between neighbours."""
    rng = np.random.default_rng(3)
    m = slam_map_mod.Map()
    kfs, truth = [], []
    half = n_kf // 2
    for k in range(n_kf):
        x_true = step * k if k < half else step * (2 * half - k)
        feats = {"xy": rng.uniform(0, 400, (8, 2)).astype(np.float32),
                 "desc": rng.integers(0, 2**32, (8, 8), dtype=np.uint32),
                 "angle": np.zeros(8, np.float32), "level": np.zeros(8, np.int32),
                 "sigma2": np.ones(8, np.float32), "response": np.zeros(8, np.float32),
                 "valid": np.ones(8, np.float32)}
        frame = slam_map_mod.Frame(0.1 * k, feats)
        frame.T_cw = np.eye(4, dtype=np.float32)
        frame.T_cw[0, 3] = -(x_true + drift_per_kf * k)
        kf = slam_map_mod.KeyFrame(frame)
        m.add_keyframe(kf)
        if kfs:
            kf.parent = kfs[-1].id
            kfs[-1].children.add(kf.id)
            kf.covis[kfs[-1].id] = kfs[-1].covis[kf.id] = 150
        kfs.append(kf)
        truth.append(x_true)
    return m, kfs, np.asarray(truth)


def phase_pose_graph_cg(name: str) -> dict:
    """10d: tests/test_pose_graph_scale.py's 1000-keyframe essential graph
    (its slow test: an out-and-back chain with 3 mm/keyframe drift, the
    last three keyframes snapped to truth, a loop edge to keyframe 4)
    through LoopCloser._optimize_essential_graph: the coarse dense pass,
    then one optimize_pose_graph_cg solve at 1024 vertices, timed (CUDA
    events and the host wall) with the CG iterations of each LM step."""
    n = 1000
    m, kfs, truth = chain_map(n, 0.003)
    voc = Vocabulary.train(np.random.default_rng(0).integers(0, 2**32, (64, 8), dtype=np.uint32),
                           branching=4, levels=2, seed=0, device=DEV)
    closer = loop_closing.LoopCloser(m, voc, [500.0, 500.0, 320.0, 240.0, 200.0], fix_scale=True,
                                     device=DEV)
    cur, loop = kfs[-1], kfs[4]
    corrections = {}
    for i, kf in enumerate(kfs[-3:]):
        before = kf.T_cw.copy()
        kf.T_cw = before.copy()
        kf.T_cw[0, 3] = -truth[n - 3 + i]
        corrections[kf.id] = (before, kf.T_cw)
    cur.loop_edges.add(loop.id)
    loop.loop_edges.add(cur.id)
    stats, spans, walls = {}, [], []
    cg = pose_graph.optimize_pose_graph_cg

    def timed_cg(*args, **kw):
        t0 = time.perf_counter()
        out = around_launches(spans, cg)(*args, stats=stats, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        stats["K"], stats["E"] = args[0].shape[0], args[2].shape[0]
        return out

    with mock.patch.object(pose_graph, "optimize_pose_graph_cg", timed_cg):
        closer._optimize_essential_graph(cur, loop, corrections)
    err = np.array([abs(-float(kf.T_cw[0, 3]) - truth[i]) for i, kf in enumerate(kfs)])
    est = np.array([-float(kf.T_cw[0, 3]) for kf in kfs])
    kink = float(np.abs(np.abs(np.diff(est)) - np.abs(np.diff(truth))).max())
    its = stats.get("cg_iters", [])
    print(f"[10d] essential graph at {n} keyframes: optimize_pose_graph_cg (K={stats.get('K')}, "
          f"E={stats.get('E')}) {events_ms(spans)[0]:.3f} ms between CUDA events, {walls[0]:.3f} ms host "
          f"wall; CG iterations per LM step {its} ({sum(its)} in all, host check every "
          f"{pose_graph.CG_CHECK_EVERY}); error mid-chain {err[n // 2]:.4f} m, max {err.max():.4f} m, "
          f"kink {kink:.4f} m on {name}")
    check(len(walls) == 1 and len(its) == 25, f"10d: {len(walls)} CG solves, {len(its)} LM steps")
    check(err[n // 2] < 0.35 and err.max() < 0.5 and kink < 0.08,
          f"10d: mid {err[n // 2]}, max {err.max()}, kink {kink}")
    m.check_invariants()
    return {"ms": events_ms(spans)[0], "wall_ms": walls[0], "cg_iters": its}


def continue_on(system, slam_map, voc):
    """Put a loaded map under a freshly built system and relocalize into it:
    the map goes to every stage, the vocabulary indexes its keyframes, and
    tracking starts LOST at the newest keyframe."""
    system.map = system.tracker.map = system.local_mapper.map = slam_map
    if system.local_mapper.object_pipeline is not None:
        system.local_mapper.object_pipeline.map = slam_map
    system.enable_loop_closing(voc)
    for kf_id, kf in sorted(slam_map.keyframes.items()):
        kf.bow = voc.bow_vector(kf.feats_torch(DEV)["desc"], kf.feats["valid"])
        system.kf_db.add(kf_id, kf.bow)
    system.tracker.state = tracking.State.LOST
    system.tracker.ref_kf = slam_map.keyframes[max(slam_map.keyframes)]


def phase_checkpoint(tmp: str, name: str) -> dict:
    """10e: dsp_slam.main --vocabulary --save_state over the mini-KITTI
    fixture on the card; load_state and 3 more frames (the fixture again,
    relocalized in the loaded map); extract_map_objects over the saved map
    on the card and on the CPU: the same vertex and face counts, every
    vertex within 1e-4 of the other mesh's nearest."""
    cfg = mini_kitti_config(tmp)
    seq = KITTISequence(MINI_KITTI, None)
    params = orb.ORBParams(n_features=1000, n_levels=4)
    voc = vocabulary_from([seq.load_stereo_gray(0)[0]], params, 6, 2)
    voc_path, state = os.path.join(tmp, "voc.npz"), os.path.join(tmp, "state.npz")
    voc.save(voc_path)
    out = os.path.join(tmp, "ckpt_map")
    mark = launch_mark()
    system = dsp_slam.main(["--sequence_dir", MINI_KITTI, "--config", cfg, "--map_dir", out,
                            "--vocabulary", voc_path, "--save_state", state])
    k2 = launches_since(mark)[1]
    check(system.state.name == "OK" and system.loop_closer is not None, f"10e: {system.state}")
    check(k2 == seq.num_frames + system.tracker.n_redone, f"10e: K2 launched {k2} times")
    loaded = state_io.load_state(state)
    check(set(loaded.keyframes) == set(system.map.keyframes) and len(loaded.points) > 100,
          f"10e: checkpoint holds {len(loaded.keyframes)} keyframes, {len(loaded.points)} points")
    loaded.check_invariants()
    system_cfg = SystemConfig.load(cfg)
    cont = dsp_slam.build_system(system_cfg, KITTISequence(MINI_KITTI, system_cfg.detection), device=DEV)
    continue_on(cont, loaded, Vocabulary.load_any(voc_path))
    n_kf = len(loaded.keyframes)
    states = []
    for k in range(3):
        cont.track_stereo(*seq.load_stereo_gray(k), 10.0 + seq.timestamp(k))
        states.append(cont.state.name)
    cont.flush()
    check(states == ["OK"] * 3, f"10e: continued frames {states}")
    cont.map.check_invariants()
    meshes = {}
    for dev in ("cuda", "cpu"):
        objs, meshes[dev] = extract_map_objects.main(["--map_dir", out, "--config", cfg, "--device", dev,
                                                      "--output_dir", os.path.join(tmp, f"meshes_{dev}")])
    check(len(objs) >= 1 and meshes["cuda"].keys() == meshes["cpu"].keys(), f"10e: {len(objs)} objects")
    d, reordered = 0.0, 0
    for obj_id, m in meshes["cuda"].items():
        c = meshes["cpu"][obj_id]
        check(m["vertices"].shape == c["vertices"].shape and m["faces"].shape == c["faces"].shape,
              f"10e: object {obj_id} mesh {m['vertices'].shape} / {m['faces'].shape} on the card, "
              f"{c['vertices'].shape} / {c['faces'].shape} on the CPU")
        if not len(m["vertices"]):
            continue
        # the host mesher welds vertices by rounded position and returns them
        # in that order, so grid values that differ in the last bits can
        # reorder them: each vertex is held against the nearest of the other
        # mesh's, both ways
        d = max(d, float(cKDTree(c["vertices"]).query(m["vertices"])[0].max()),
                float(cKDTree(m["vertices"]).query(c["vertices"])[0].max()))
        reordered += int(np.any(m["vertices"] != c["vertices"], axis=1).sum())
    print(f"[10e] dsp_slam --vocabulary --save_state over mini-KITTI: {len(loaded.keyframes)} keyframes, "
          f"{len(loaded.points)} points, {len(loaded.objects)} objects saved; continued on the loaded map "
          f"{states} ({len(cont.map.keyframes) - n_kf} new keyframes); mesh export card vs CPU: "
          f"{[(i, len(m['vertices']), len(m['faces'])) for i, m in meshes['cuda'].items()]} (id, vertices, "
          f"faces), max distance to the other mesh's nearest vertex {d:.3e} ({reordered} vertices at "
          f"another index); K2 launches {k2} on {name}")
    check(d <= 1e-4, f"10e: mesh vertices differ by {d}")
    return {"k2_launches": k2}


# ---------------------------------------------------------------------------
# phase 11 (slice 6): the online detectors

# Tolerances, card against the CPU run of the same port code on identical
# inputs. The bf16 backbones round every layer's output to 8 significant
# bits; cuDNN and oneDNN sum in other orders, so a rounding may land one
# step apart, and ~55 layers (ResNet-50 + FPN) or 19 (the BEV backbone, neck
# and heads) compound it: max |d| / max |f| within 5e-2.
BF16_TOL = 5e-2
# the f32 heads with TF32 off, fed identical inputs: max |d| / max |x|
HEAD_TOL = 1e-4
# the RPN's top-k and NMS fed identical level outputs pick the same boxes;
# their decode takes exp, which may differ in its last bit between devices
PROPOSAL_TOL_PX = 1e-3
# the device pillar build: float scatter-adds are atomics on the card
PILLAR_FEAT_TOL = 1e-5


def rel_err(ref: torch.Tensor, other: torch.Tensor) -> float:
    ref, other = ref.detach().float().cpu(), other.detach().float().cpu()
    return float((ref - other).abs().max() / ref.abs().max().clamp_min(1e-30))


def phase_maskrcnn(left: np.ndarray, name: str) -> dict:
    """11a: MaskRCNN at full width (R50-FPN, 256 channels, 80 classes, RPN
    512 / 128, 16 detections; seeded random weights) on phase 7's first left
    frame as RGB, stage by stage on the card against the CPU: the bf16
    backbone + FPN; the RPN's top-k + NMS fed the CPU's level outputs; the
    box and mask heads fed the CPU's proposals and kept boxes; the box NMS
    fed the CPU's boxes and scores."""
    cfg = maskrcnn.MaskRCNNConfig()
    params = maskrcnn.init_params(cfg)
    card_params = maskrcnn.tree_map(lambda t: t.to(DEV), params)
    rgb = np.repeat(left[..., None], 3, axis=-1)
    hw = rgb.shape[:2]
    img = torch.from_numpy(rgb)
    t0 = time.perf_counter()
    feats = maskrcnn.resnet_fpn(params, maskrcnn.normalize_image(img), cfg)
    cpu_s = time.perf_counter() - t0
    feats_c = maskrcnn.resnet_fpn(card_params, maskrcnn.normalize_image(img.to(DEV)), cfg)
    feat_err = [rel_err(a, b) for a, b in zip(feats, feats_c)]
    print(f"[11a] MaskRCNN R50-FPN (bf16) at {hw[0]}x{hw[1]}, card vs CPU (CPU {cpu_s:.2f} s): max |d| / "
          f"max |f| per level P2..P6 {[f'{e:.3e}' for e in feat_err]} (tolerance {BF16_TOL}); max |f| "
          f"{[round(float(f.abs().max()), 1) for f in feats]}")
    check(max(feat_err) <= BF16_TOL, f"11a: backbone + FPN differ by {max(feat_err)} > {BF16_TOL}")
    # the rest of the network runs on the CPU's features
    feats_cc = [f.to(DEV) for f in feats]
    levels = maskrcnn.rpn_heads(params, feats)
    level_hw = [f.shape[-2:] for f in feats]
    props, valid = maskrcnn.rpn_select(levels, level_hw, hw, cfg)
    props_c, valid_c = maskrcnn.rpn_select([(a.to(DEV), b.to(DEV)) for a, b in levels], level_hw, hw, cfg)
    d_prop = float((props_c.cpu() - props).abs().max())
    head = maskrcnn.box_head(params, feats, props, valid, hw, cfg)
    head_c = maskrcnn.box_head(card_params, feats_cc, props.to(DEV), valid.to(DEV), hw, cfg)
    head_err = max(rel_err(head[i], head_c[i]) for i in (0, 1, 3))
    sel = maskrcnn.select_boxes(*head[:3], cfg)
    sel_c = maskrcnn.select_boxes(*(t.to(DEV) for t in head[:3]), cfg)
    nms_equal = all(torch.equal(b.cpu(), a) for a, b in zip(sel, sel_c))
    masks = maskrcnn.mask_head(params, feats, sel[0], sel[3], cfg)
    masks_c = maskrcnn.mask_head(card_params, feats_cc, sel[0].to(DEV), sel[3].to(DEV), cfg)
    mask_err = rel_err(masks, masks_c)
    kept = sel[1][sel[2] > 0]
    saturated = float((kept == 1.0).float().mean()) if len(kept) else 0.0
    print(f"[11a] RPN top-k + NMS fed the CPU's level outputs: {int(valid.sum())} proposals, validity "
          f"{'equal' if torch.equal(valid_c.cpu(), valid) else 'DIFFERS'}, max |d| {d_prop:.3e} px (tolerance "
          f"{PROPOSAL_TOL_PX}); box head fed the CPU's proposals max |d| / max |x| {head_err:.3e}, mask head "
          f"fed the CPU's kept boxes {mask_err:.3e} (tolerance {HEAD_TOL}); box NMS fed the CPU's boxes and "
          f"scores {'equal' if nms_equal else 'DIFFERS'}: {len(kept)} kept, labels "
          f"{sel[3][sel[2] > 0].tolist()}, share of kept scores exactly 1.0: {saturated:.4f} on {name}")
    check(torch.equal(valid_c.cpu(), valid) and d_prop <= PROPOSAL_TOL_PX,
          f"11a: RPN proposals differ by {d_prop} px")
    check(head_err <= HEAD_TOL and mask_err <= HEAD_TOL, f"11a: heads differ by {head_err} / {mask_err}")
    check(nms_equal, "11a: the box NMS on the card differs from the CPU's")
    return {"feat_err": feat_err, "proposal_err_px": d_prop, "head_err": head_err, "mask_err": mask_err,
            "kept": len(kept), "saturated_share": saturated, "rgb": rgb}


def phase_pointpillars(name: str) -> dict:
    """11b: PointPillars at full width (default config; seeded random
    weights) over benchmark_detectors.synthetic_scan(): the device pillar
    build on the card against the CPU (the 12,000-pillar cap is hit), the
    bf16 forward, select_detections fed the CPU's outputs; then Detector3D
    with host and device pillar assignment on a scan under the cap."""
    cfg = pointpillars.PointPillarsConfig()
    cpu = pointpillars.Detector3D(cfg=cfg, device="cpu")
    card = pointpillars.Detector3D(params=cpu.params, cfg=cfg, device=DEV)
    scan = benchmark_detectors.synthetic_scan()
    up = cpu.upload(scan)
    pil = pointpillars.build_pillars_from_points(up, cfg)
    pil_c = pointpillars.build_pillars_from_points({k: v.to(DEV) for k, v in up.items()}, cfg)
    exact = {k: torch.equal(pil_c[k].cpu(), pil[k]) for k in ("coords", "mask", "pillar_mask")}
    f_err = float((pil_c["features"].cpu() - pil["features"]).abs().max())
    n_pts, n_pil = int(up["n_pts"].sum()), int(pil["pillar_mask"].sum())
    print(f"[11b] PointPillars pillar build over {len(scan)} points ({n_pts} after the crop, {n_pil} pillars "
          f"kept of a cap of {cfg.max_pillars}): card vs CPU {exact} exact, features max |d| {f_err:.3e} "
          f"(tolerance {PILLAR_FEAT_TOL})")
    check(all(exact.values()) and f_err <= PILLAR_FEAT_TOL, f"11b: pillar build differs: {exact}, {f_err}")
    check(n_pil == cfg.max_pillars, f"11b: {n_pil} pillars, the cap is not hit")
    out = pointpillars.forward(cpu.params, pil, cfg)
    out_c = pointpillars.forward(card.params, {k: v.to(DEV) for k, v in pil.items()}, cfg)
    fwd_err = [rel_err(a, b) for a, b in zip(out, out_c)]
    boxes = pointpillars.decode_boxes(out[1], cpu.anchors)
    sel = pointpillars.select_detections(out[0], boxes, out[2], cfg)
    sel_c = pointpillars.select_detections(out[0].to(DEV), boxes.to(DEV), out[2].to(DEV), cfg)
    sel_box_err = float((sel_c[0].cpu() - sel[0]).abs().max())
    sel_score_err = float((sel_c[1].cpu() - sel[1]).abs().max())
    valid_equal = torch.equal(sel_c[2].cpu(), sel[2])
    kept = sel[1][sel[2] > 0]
    saturated = float((kept == 1.0).float().mean()) if len(kept) else 0.0
    logits = out[0]
    print(f"[11b] forward (bf16 BEV backbone) card vs CPU: max |d| / max |x| of cls, box, dir "
          f"{[f'{e:.3e}' for e in fwd_err]} (tolerance {BF16_TOL}); class logits {float(logits.min()):.4f} .. "
          f"{float(logits.max()):.4f}; select_detections fed the CPU's outputs: validity "
          f"{'equal' if valid_equal else 'DIFFERS'}, boxes max |d| {sel_box_err:.3e}, scores {sel_score_err:.3e}; "
          f"{len(kept)} kept, share of kept scores exactly 1.0: {saturated:.4f} on {name}")
    check(max(fwd_err) <= BF16_TOL, f"11b: forward differs by {max(fwd_err)}")
    check(valid_equal and sel_box_err <= 1e-4 and sel_score_err <= 1e-6,
          f"11b: select_detections differs ({valid_equal}, {sel_box_err}, {sel_score_err})")
    # host (pillarize_sparse) and device assignment under the cap, points
    # off the voxel edges (the host assigns from float points, the device
    # from 2 mm-quantized ones): the same pillars by cell
    small = benchmark_detectors.synthetic_scan(n=10_000, seed=4)
    fx = (small[:, 0] - cfg.pc_range[0]) / cfg.voxel_size[0] % 1.0
    fy = (small[:, 1] - cfg.pc_range[1]) / cfg.voxel_size[1] % 1.0
    small = small[(fx > 0.01) & (fx < 0.99) & (fy > 0.01) & (fy < 0.99)]
    host = pointpillars.Detector3D(params=cpu.params, cfg=cfg, device_assign=False, device=DEV)
    by_cell = []
    for det, build in ((card, pointpillars.build_pillars_from_points), (host, pointpillars.build_pillars_device)):
        p = build(det.upload(small), cfg)
        live = p["pillar_mask"] > 0
        key = p["coords"][live][:, 1].long() * cfg.grid_size[0] + p["coords"][live][:, 0].long()
        order = torch.argsort(key)
        by_cell.append((key[order].cpu(), p["mask"][live][order].cpu(), p["features"][live][order].cpu()))
    (kd, md, fd), (kh, mh, fh) = by_cell
    paths_err = float((fd - fh).abs().max()) if len(fd) == len(fh) else float("inf")
    paths_ok = torch.equal(kd, kh) and torch.equal(md, mh) and paths_err <= PILLAR_FEAT_TOL
    print(f"[11b] Detector3D device_assign True vs False under the cap ({len(kd)} pillars): cells and masks "
          f"{'equal' if paths_ok else 'DIFFER'}, features max |d| {paths_err:.3e}")
    check(paths_ok, "11b: host and device pillar assignment differ under the cap")
    return {"pillar_feat_err": f_err, "fwd_err": fwd_err, "kept": len(kept), "saturated_share": saturated,
            "scan": scan}


def phase_detector_timing(rgb: np.ndarray, scan: np.ndarray, name: str) -> dict:
    """11c: apps.benchmark_detectors on the card (20 iterations); a
    torch.profiler table of one Detector2D and one Detector3D call; one
    dispatch of each under set_sync_debug_mode("error")."""
    rec = benchmark_detectors.main(["--iters", "20"])
    print(f"[11c] benchmark_detectors: PointPillars {rec['pointpillars_ms_per_scan']:.3f} ms per scan (host "
          f"crop {rec['pointpillars_host_crop_ms']:.3f} ms), MaskRCNN {rec['maskrcnn_ms_per_frame']:.3f} ms "
          f"per frame, medians of 20 on {name}")
    det2d = maskrcnn.Detector2D(device=DEV)
    det3d = pointpillars.Detector3D(device=DEV)
    calls = {"Detector2D": (det2d, rgb), "Detector3D": (det3d, scan)}
    prof = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, (det, arg) in calls.items():
        det.make_prediction(arg)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as p:
            t0 = time.perf_counter()
            det.make_prediction(arg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = p.key_averages()
        key, busy = device_ms(events)
        launches = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
        prof[label] = {"wall_ms": wall, "busy_ms": busy, "device_ops": launches, "idle_share": 1 - busy / wall}
        print(f"[11c] profile of one {label}.make_prediction: wall {wall:.3f} ms under the profiler, device "
              f"busy {busy:.3f} ms over {launches} device operations (kernels and copies), idle share "
              f"{1 - busy / wall:.3f}")
        print(events.table(sort_by=key, row_limit=12))
    for label, (det, arg) in calls.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = det.dispatch(arg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        det.collect(handle)
        print(f"[11c] {label}.dispatch under set_sync_debug_mode('error'): no host sync")
    return {"benchmark": {k: v for k, v in rec.items() if k != "device"}, "profile": prof}


def phase_detect_online(tmp: str, name: str) -> dict:
    """11d: apps.dsp_slam.main over mini-KITTI with detect_online on the
    card (full-width MaskRCNN and PointPillars, seeded random weights; phase
    4's random full-width DeepSDF, so the objects that random detections
    make run K1)."""
    with open(mini_kitti_config(tmp)) as f:
        cfg = json.load(f)
    cfg["detection"]["detect_online"] = True
    cfg["deepsdf_dir"] = os.path.join(tmp, "deepsdf")
    cfg_path = os.path.join(tmp, "mini_kitti_online.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(tmp, "online_map")
    seqs = []
    get = KITTISequence.get_frame_detections

    def counted(self, frame_id, image_hw):
        seqs.append(self)
        return get(self, frame_id, image_hw)

    mark = launch_mark()
    t0 = time.perf_counter()
    with mock.patch.object(KITTISequence, "get_frame_detections", counted):
        system = dsp_slam.main(["--sequence_dir", MINI_KITTI, "--config", cfg_path, "--map_dir", out, "--no_loop"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = launches_since(mark)
    nms = counter_totals().get("nms_launches", 0) - mark.get("nms_launches", 0)
    tr = system.tracker
    lost = sum(1 for _, _, l in tr.trajectory if l)
    pipeline = system.local_mapper.object_pipeline
    expected = pipeline.expected_k1_launches()
    n_kf = len(system.map.keyframes)
    seq = seqs[0] if seqs else None
    d2 = seq.detector_2d.dispatches if seq else 0
    d3 = seq.detector_3d.dispatches if seq else 0
    objs = [o for o in system.map.objects.values() if not o.bad]
    print(f"[11d] dsp_slam over mini-KITTI with detect_online on the card ({wall:.1f} s): {len(tr.trajectory)} "
          f"frames, {lost} lost, {n_kf} keyframes, detection calls {len(seqs)}, MaskRCNN dispatches {d2}, "
          f"PointPillars dispatches {d3}, {len(objs)} objects; GN calls {pipeline.dispatches}; K1 launches {k1} "
          f"(expected {expected}), K2 launches {k2} ({tr.n_redone} frames re-tracked), NMS launches {nms} on {name}")
    check(len(tr.trajectory) == 3 and lost == 0, f"11d: {len(tr.trajectory)} frames, {lost} lost")
    check(len(seqs) == n_kf >= 1 and len(set(map(id, seqs))) == 1, f"11d: {len(seqs)} detection calls, {n_kf} keyframes")
    check(d2 == d3 == n_kf, f"11d: detectors dispatched {d2} / {d3} times for {n_kf} keyframes")
    check(k1 == expected, f"11d: K1 launched {k1} times, expected {expected}")
    check(k2 == 3 + tr.n_redone, f"11d: K2 launched {k2} times")
    check(nms == 2 * d2 + d3, f"11d: the NMS kernel launched {nms} times for {d2} + {d3} detector calls")
    cams = np.loadtxt(os.path.join(out, "Cameras.txt")).reshape(-1, 3, 4)
    pts = np.loadtxt(os.path.join(out, "MapPoints.txt")).reshape(-1, 3)
    lines = [ln for ln in open(os.path.join(out, "MapObjects.txt")).read().split("\n") if ln.strip()]
    check(cams.shape[0] == 3 and np.isfinite(cams).all() and len(pts) > 100 and len(lines) % 3 == 0,
          f"11d: map files {cams.shape}, {len(pts)} points, {len(lines)} object lines")
    for i in range(0, len(lines), 3):
        int(lines[i])
        check(len(lines[i + 1].split()) == 12 and len(lines[i + 2].split()) == 64,
              f"11d: MapObjects.txt entry {i // 3} malformed")
    return {"k1_launches": k1, "k2_launches": k2, "nms_launches": nms, "keyframes": n_kf, "objects": len(objs),
            "wall_s": wall}


def phase_nms(rgb: np.ndarray, scan: np.ndarray, name: str) -> dict:
    """11e: the greedy-NMS kernel at the kitti_detect cell's detector
    settings. One Detector2D and one Detector3D call (seeded random weights)
    on 11a's frame and 11b's scan, counted from a mark, record their three
    NMS calls' inputs; each call is replayed: the kernel against the plain
    loop on the CPU and on the card (picks, scores, ok equal), then timed."""
    with open(DETECT_CELL_CONFIG) as f:
        cfg_2d, cfg_3d = detector_configs(DetectionConfig(**json.load(f)["detection"]))
    det2d = maskrcnn.Detector2D(cfg=cfg_2d, device=DEV)
    det3d = pointpillars.Detector3D(cfg=cfg_3d, device=DEV)
    det2d.make_prediction(rgb)
    det3d.make_prediction(scan)
    calls = []

    def recorded(iou, scores, *args, **kwargs):
        calls.append((iou.clone(), scores.clone(), args, kwargs))
        return greedy_nms.greedy_suppress(iou, scores, *args, **kwargs)

    torch.cuda.synchronize()
    mark = counter_totals()
    with mock.patch.object(maskrcnn, "greedy_suppress", recorded), \
            mock.patch.object(pointpillars, "greedy_suppress", recorded):
        det2d.make_prediction(rgb)
        det3d.make_prediction(scan)
    torch.cuda.synchronize()
    launches = counter_totals().get("nms_launches", 0) - mark.get("nms_launches", 0)
    print(f"[11e] one Detector2D and one Detector3D call at {DETECT_CELL_CONFIG}'s settings: {len(calls)} NMS "
          f"calls, nms_launches {launches} on {name}")
    check(len(calls) == 3 and launches == 3, f"11e: {len(calls)} NMS calls, {launches} launches, expected 3")
    shapes = {"rpn": (None, cfg_2d.rpn_post_nms), "rcnn": (cfg_2d.rpn_post_nms, cfg_2d.max_detections),
              "pointpillars": (cfg_3d.nms_pre, cfg_3d.max_detections)}
    out, max_err = {}, 0.0
    for (label, (n_want, k_want)), (iou, scores, args, kwargs) in zip(shapes.items(), calls):
        n, k = scores.shape[0], args[0]
        check(k == k_want and n == (n_want or n), f"11e: {label} NMS of {n} candidates, {k} rounds")

        def kernel():
            return greedy_nms.greedy_suppress(iou, scores, *args, **kwargs)

        got = kernel()
        on_card = greedy_nms.greedy_suppress_plain(iou, scores, *args, **kwargs)
        on_cpu = greedy_nms.greedy_suppress_plain(iou.cpu(), scores.cpu(), *args, **kwargs)
        equal = all(torch.equal(g.cpu(), w) and torch.equal(c.cpu(), w) for g, c, w in zip(got, on_card, on_cpu))
        max_err = max(max_err, float((got[1].cpu() - on_cpu[1]).abs().max()))
        ms = cuda_ms(kernel, 50)
        dev = kernel_device_ms(kernel, 20, "greedy_nms_kernel")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            greedy_nms.greedy_suppress_plain(iou, scores, *args, **kwargs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        kept = int(on_cpu[2].sum())
        # the scores once, each kept pick's overlap row, the outputs (13 bytes a round)
        b_ms, b_by = bound(4 * n + 4 * n * kept + 13 * k, 0.0)
        out[label] = {"n": n, "k": k, "kept": kept, "equal": equal, "ms": ms, "device_ms": dev,
                      "plain_ms": float(np.median(walls)), "bound_ms": b_ms, "bound_by": b_by}
        print(f"[11e] {label} ({n} candidates, {k} rounds, {kept} kept): kernel vs the plain loop on the CPU and "
              f"on the card {'equal' if equal else 'DIFFER'}; kernel {ms:.4f} ms a call back to back (device "
              f"{dev:.4f}, {dev / k * 1e3:.3f} us a round), plain loop on the card {out[label]['plain_ms']:.2f} "
              f"ms (wall, median of 3), bound {b_ms * 1e3:.3f} us ({b_by}) on {name}")
        check(equal, f"11e: the {label} NMS kernel differs from the plain loop")
    return {"launches": launches, "max_abs_err": max_err, "calls": out}


# ---------------------------------------------------------------------------
# phase 12: slice 7 (the decoder fit and the full workload, the detector
# trainers, the vocabulary trainer and the overlays)

# one train_step card vs CPU from the same parameters and batch. Both run f32
# with TF32 off; the weight gradients are sums over the 8192 rows with heavy
# cancellation (the L1 gradient is a sign per row), so the two devices'
# summation orders differ by up to ~1e-4 of a tensor's largest entry (the
# card's first calls: 2.8e-4, 99th percentile 2.0e-4). Each device is held
# against a float64 gradient of the same step instead: the card's largest
# error over the tensors must be as small as the CPU's, within a factor
# and a floor (which tensor errs most differs between the two orders).
FIT_LOSS_TOL = 1e-5           # relative, card vs CPU
FIT_GRAD_FACTOR, FIT_GRAD_FLOOR = 2.0, 1e-4    # of max |d| / max |g64| over the tensors
# the fit must place each shape's surface (radii 0.3 .. 0.7, 0.1 apart)
FIT_RADIUS_TOL = 0.05         # m, along +x in the canonical frame


def grad_errs(ref: list, other: list) -> list:
    """max |d| / max |ref| per tensor."""
    return [rel_err(r.double(), o.double()) for r, o in zip(ref, other)]


def phase_decoder_fit(tmp: str, name: str) -> dict:
    """12a: deepsdf_train.fit_spheres at train_bench_decoder's shapes (the
    canonical decoder, 5 shapes, batch 8192, 600 steps, seed 0); each code's
    surface along +x; one train_step card vs CPU from the same seeded state
    and numpy batch (loss and every gradient), with float32 products
    (matmul_precision "highest"); the steady step at the shipped precision;
    the exported experiment dir through load_torch_checkpoint (equal
    outputs)."""
    cfg = benchmark_slam.BENCH_DECODER
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec, codes, loss = deepsdf_train.fit_spheres(cfg, num_shapes=5, steps=600, batch=8192, seed=0, device=DEV)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    r = torch.linspace(0.05, 0.95, 901, device=DEV)
    radii = []
    for k in range(5):
        sdf = dec(torch.cat([codes[k].expand(len(r), cfg.code_len), r[:, None], torch.zeros(len(r), 2, device=DEV)],
                            dim=-1))
        inside = torch.nonzero(sdf > 0)
        radii.append(float(r[int(inside[0])]) if len(inside) else float("nan"))
    print(f"[12a] fit_spheres (canonical decoder, 5 shapes, batch 8192, 600 steps): {fit_s:.3f} s "
          f"({fit_s / 600 * 1e3:.3f} ms per step incl. the first step's setup), final L1 {loss:.6f}; surfaces "
          f"along +x at {[round(x, 4) for x in radii]} for radii 0.3 .. 0.7 on {name}")
    check(np.isfinite(loss), f"12a: final loss {loss}")
    check(all(abs(x - (0.3 + 0.1 * k)) < FIT_RADIUS_TOL for k, x in enumerate(radii)),
          f"12a: decoded radii {radii}")

    rng = np.random.default_rng(12)
    idx = rng.integers(0, 5, 8192)
    xyz = rng.uniform(-1, 1, (8192, 3)).astype(np.float32)
    batch_np = {"shape_idx": idx, "xyz": xyz,
                "sdf": (np.linalg.norm(xyz, axis=-1) - (0.3 + 0.1 * idx)).astype(np.float32)}
    out = []
    # float32 products on the card too: each device is held to float64 at
    # float32's tolerance (the fit above and the steady step below run the
    # shipped precision)
    cfg_f32 = dataclasses.replace(cfg, matmul_precision="highest")
    for dev, dtype in ((DEV, torch.float32), (torch.device("cpu"), torch.float32), (torch.device("cpu"), torch.float64)):
        st = deepsdf_train.init_state(cfg_f32, 5, seed=0, device=dev)
        st.decoder.to(dtype)
        st.codes.data = st.codes.data.to(dtype)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
        t0 = time.perf_counter()
        step_loss = deepsdf_train.train_step(st, batch, clamp=0.5)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.append((float(step_loss), [p.grad for p in st.decoder.parameters()] + [st.codes.grad], st,
                    (time.perf_counter() - t0) * 1e3))
    (l_g, g_g, st_g, ms_g), (l_c, g_c, _, ms_c), (l_64, g_64, _, _) = out
    l_err = abs(l_g - l_c) / abs(l_c)
    e_card, e_cpu = grad_errs(g_64, g_g), grad_errs(g_64, g_c)
    e_cc = grad_errs(g_c, g_g)
    print(f"[12a] one train_step card vs CPU (seeded state, numpy batch of 8192): loss {l_g:.8f} vs {l_c:.8f} "
          f"(rel {l_err:.3e}; float64 {l_64:.8f}); gradients over {len(g_c)} tensors, max |d| / max |g|: card vs "
          f"CPU up to {max(e_cc):.3e}, card vs float64 up to {max(e_card):.3e}, CPU vs float64 up to "
          f"{max(e_cpu):.3e}; {ms_g:.3f} ms on the card (first step), {ms_c:.1f} ms on the CPU")
    check(l_err <= FIT_LOSS_TOL, f"12a: train_step loss card vs CPU rel {l_err}")
    check(max(e_card) <= max(FIT_GRAD_FACTOR * max(e_cpu), FIT_GRAD_FLOOR),
          f"12a: train_step gradients: card {e_card} vs CPU {e_cpu} from float64")
    # the steady step at the shipped precision, after one step's setup
    st_g = deepsdf_train.init_state(cfg, 5, seed=0, device=DEV)
    deepsdf_train.train_step(st_g, {k: torch.from_numpy(v).to(DEV) for k, v in batch_np.items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        deepsdf_train.train_step(st_g, {k: torch.from_numpy(v).to(DEV) for k, v in batch_np.items()})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3

    exp = os.path.join(tmp, "fitted")
    deepsdf_train.export_reference_format(st_g, exp)
    cfg2, dec2 = deepsdf.load_torch_checkpoint(exp, device=DEV)
    x = torch.from_numpy(rng.normal(0, 0.4, (4096, cfg.in_dim)).astype(np.float32)).to(DEV)
    with torch.no_grad():
        d_exp = float((dec2(x) - st_g.decoder(x)).abs().max())
    print(f"[12a] steady train_step {step_ms:.3f} ms at matmul_precision {cfg.matmul_precision!r} (mean of 20, "
          f"synchronized); export -> "
          f"load_torch_checkpoint: {cfg2 == cfg}, outputs max |d| {d_exp:.3e}")
    check(cfg2 == cfg and d_exp == 0.0, f"12a: exported decoder differs by {d_exp} ({cfg2})")
    return {"fit_s": fit_s, "l1": loss, "radii": radii, "step_ms": step_ms, "loss_rel_err": l_err,
            "grad_err_card_vs_cpu": max(e_cc), "grad_err_card_vs_f64": max(e_card), "grad_err_cpu_vs_f64": max(e_cpu),
            "decoder": dec}


JAX_TPU_FULL_MARKS = {"ate_cm": 1.4, "chamfer_cm": 5.47}     # BENCH_r04, another machine: accuracy marks
FULL_FRAMES = bench.FULL_FRAMES         # bench.py's full workload (bench.py:149-157); 18 warm-up frames
FULL_PROFILE_FRAMES = range(10, 15)     # inside the warm-up, so outside the steady-state record
FULL_CHAMFER_CM = 15.0


def phase_full_arm(name: str) -> dict:
    """12b: the bench entry's `full` arm (benchmark_slam --frames 56), the full workload: both
    detectors at full width on every keyframe inside the measured loop, the
    canonical DeepSDF fitted to spheres at startup (600 steps) so the object
    GN runs K1 on trained weights, live and 64^3 refined chamfer. Frames
    10-14 (inside the warm-up) run under torch.profiler with the detectors'
    calls marked."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    calls, prof = [0], {}
    track = SLAMSystem.track_stereo

    def profiled_track(self, img_l, img_r, timestamp):
        k = calls[0]
        calls[0] += 1
        if k == FULL_PROFILE_FRAMES[0]:
            torch.cuda.synchronize()
            prof["p"] = torch.profiler.profile(activities=acts)
            prof["p"].start()
            prof["t0"] = time.perf_counter()
        out = track(self, img_l, img_r, timestamp)
        if k == FULL_PROFILE_FRAMES[-1]:
            torch.cuda.synchronize()
            prof["wall_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].stop()
        return out

    def marked(label, fn):
        def run(self, *args):
            with torch.profiler.record_function(label):
                return fn(self, *args)
        return run

    mark = launch_mark()
    t0 = time.perf_counter()
    with mock.patch.object(SLAMSystem, "track_stereo", profiled_track), \
            mock.patch.object(maskrcnn.Detector2D, "dispatch", marked("maskrcnn", maskrcnn.Detector2D.dispatch)), \
            mock.patch.object(pointpillars.Detector3D, "dispatch",
                              marked("pointpillars", pointpillars.Detector3D.dispatch)):
        rec = bench.full(DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = launches_since(mark)
    limit = 0.03 * rec["travel_m"]
    disp = rec["detector_dispatches"]
    print(f"[12b] benchmark_slam --frames {FULL_FRAMES} (full workload: Mask R-CNN + PointPillars at full width "
          f"on every keyframe, the fitted canonical DeepSDF; {rec['warmup']} warm-up frames) in {wall:.1f} s: "
          f"{rec['lost_frames']} lost, ATE {rec['ate_rmse_cm']:.4f} cm over {rec['travel_m']:.2f} m (JAX TPU mark "
          f"{JAX_TPU_FULL_MARKS['ate_cm']} cm); {rec['n_keyframes']} keyframes, {rec['n_points']} map points, "
          f"{rec['n_objects']} objects ({rec['n_static']} static, errors "
          f"{[round(e, 4) for e in rec['static_obj_errs_m']]} m; {rec['n_dynamic']} dynamic, "
          f"{rec['dynamic_obj_err_cm']} cm, prediction {rec['dynamic_pred_err_cm']} cm); live mesh chamfer "
          f"{rec['mesh_chamfer_cm']} cm over {rec['n_meshes']} meshes (JAX TPU mark "
          f"{JAX_TPU_FULL_MARKS['chamfer_cm']} cm), 64^3 refined {rec['mesh_chamfer_refined_cm']} cm on {name}")
    print(f"[12b] {rec['value']:.4f} fps mean, {rec['median_fps']:.4f} median, frame ms p95 "
          f"{rec['frame_ms_p95']:.3f}, max {rec['max_frame_ms']:.3f}; decoder fit {rec['decoder_fit']}; detector "
          f"calls {rec['detector_calls']}, dispatches {disp}, boxes collected {rec['detector_boxes']}; GN calls "
          f"{rec['gn_dispatches']}; K1 launches {k1} (expected {rec['expected_k1_launches']}), K2 launches {k2} "
          f"({FULL_FRAMES} frames + {rec['n_redone']} re-tracked); decoder at matmul_precision "
          f"{benchmark_slam.BENCH_DECODER.matmul_precision!r}, compute_dtype "
          f"{benchmark_slam.BENCH_DECODER.compute_dtype}")
    print("[12b] stages, host ms (p50 / p95 / total / count): " + "; ".join(
        f"{k} {v['p50']:.3f} / {v['p95']:.3f} / {v['total']:.3f} / {v['n']}" for k, v in sorted(rec["stage_ms"].items())))
    check(rec["lost_frames"] == 0, f"12b: {rec['lost_frames']} lost frames")
    check(rec["ate_rmse_cm"] / 100 < limit, f"12b: ATE {rec['ate_rmse_cm']} cm >= 3% of {rec['travel_m']} m")
    check(rec["n_static"] >= 1 and max(rec["static_obj_errs_m"]) < 0.35,
          f"12b: static objects {rec['static_obj_errs_m']} (need >= 1, each < 0.35 m)")
    check(rec["n_meshes"] >= 1 and rec["mesh_chamfer_cm"] <= FULL_CHAMFER_CM,
          f"12b: {rec['n_meshes']} meshes, live chamfer {rec['mesh_chamfer_cm']} cm (limit {FULL_CHAMFER_CM})")
    check(disp["maskrcnn"] == disp["pointpillars"] == rec["detector_calls"] >= rec["n_keyframes"] >= 1,
          f"12b: detectors dispatched {disp} for {rec['detector_calls']} detection calls, "
          f"{rec['n_keyframes']} keyframes")
    check(k1 == rec["expected_k1_launches"] > 0, f"12b: K1 launched {k1} times, expected {rec['expected_k1_launches']}")
    check(k2 == FULL_FRAMES + rec["n_redone"], f"12b: K2 launched {k2} times, expected {FULL_FRAMES} + {rec['n_redone']}")

    check("p" in prof, "12b: frames 10-14 were not profiled")
    events = prof["p"].key_averages()
    key, busy = device_ms(events)
    k1_events = [e for e in events if "decoder_fused_kernel" in e.key]
    k1_ms = device_ms(k1_events)[1] if k1_events else 0.0
    total_key = key.replace("self_", "")
    shares = {}
    for label in ("maskrcnn", "pointpillars"):
        rows = [e for e in events if e.key == label]
        shares[label] = getattr(rows[0], total_key) / 1e3 if rows else None
    print(f"[12b] profile of frames {FULL_PROFILE_FRAMES[0]}-{FULL_PROFILE_FRAMES[-1]} (wall {prof['wall_ms']:.3f} ms "
          f"under the profiler): device busy {busy:.3f} ms, idle share {1 - busy / prof['wall_ms']:.3f}; K1 "
          f"{k1_ms:.3f} ms ({k1_ms / max(busy, 1e-9):.3f} of the busy time); device time under the detectors' "
          f"dispatch calls: Mask R-CNN {shares['maskrcnn']} ms, PointPillars {shares['pointpillars']} ms")
    print(events.table(sort_by=key, row_limit=15))
    return {"bench_record": rec, "record": {k: v for k, v in rec.items() if k not in ("ba_solves", "stage_ms")},
            "stage_ms": rec["stage_ms"], "k1_launches": k1, "k2_launches": k2, "wall_s": wall,
            "profile": {"wall_ms": prof["wall_ms"], "busy_ms": busy, "k1_ms": k1_ms, **{f"{k}_ms": v for k, v in
                                                                                    shares.items()}}}


# one Mask R-CNN train_step card vs CPU (float32 backbone, TF32 off)
MR_STEP_LOSS_TOL = 1e-4      # relative
MR_STEP_GRAD_TOL = 1e-3      # max |d| / max |g| per tensor


def step_ms(fn, steps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def phase_closed_loops(name: str) -> dict:
    """12c: the closed loops of tests/test_detector_closed_loop.py (slow
    there) with the port's trainers on the card, under that file's
    assertions (the trainers' `closed_loop_report` / `cross_scene_report`)
    and with deterministic algorithms, so that a seed gives one result in
    every run; one Mask R-CNN train_step card vs CPU; ms per step of each
    trainer."""
    out = {}
    cfg = maskrcnn_train.small_config()
    t0 = time.perf_counter()
    with layers.deterministic():
        params, img, gt, gt_masks = maskrcnn_train.overfit_scene(cfg, steps=600, seed=0, device=DEV)
        det = maskrcnn.Detector2D(params=params, cfg=cfg, device=DEV).make_prediction(img)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rep = maskrcnn_train.closed_loop_report(det["pred_boxes"], det["pred_masks"], gt, gt_masks)
    print(f"[12c] Mask R-CNN closed loop (small config, 600 steps, deterministic, {fit_s:.1f} s with the "
          f"prediction): {rep['detections']} detections for {len(gt)} planted; box IoU "
          f"{[round(x, 4) for x in rep['box_iou']]}, mask IoU {[round(x, 4) for x in rep['mask_iou']]}, best "
          f"overlap of each detection {[round(x, 4) for x in rep['overlap']]}")
    check(rep["found"], f"12c: Mask R-CNN recovered boxes {rep['box_iou']}, masks {rep['mask_iou']}")
    check(rep["clean"], f"12c: a spurious Mask R-CNN detection ({rep['overlap']})")

    # one train_step card vs CPU from the same seeded weights and targets
    rng = np.random.default_rng(0)
    s_img, s_gt, s_masks = maskrcnn_train.make_scene(rng)
    hw = s_img.shape[:2]
    base = maskrcnn.init_params(cfg, torch.Generator().manual_seed(0))
    res = []
    for dev in (DEV, torch.device("cpu")):
        targets = maskrcnn_train.build_targets(np.random.default_rng(1), s_gt, s_masks, hw, cfg, dev)
        p = layers.trainable(base, dev)
        loss, _ = maskrcnn_train.loss_fn(p, torch.from_numpy(s_img).to(dev), targets, hw, cfg)
        loss.backward()
        res.append((loss.item(), [t.grad for t in layers.leaves(p)]))
    l_err = abs(res[0][0] - res[1][0]) / abs(res[1][0])
    g_err = max(grad_errs(res[1][1], res[0][1]))
    opt_p = layers.trainable(base, DEV)
    opt = layers.Trainer(layers.leaves(opt_p), 1e-3)
    t_img = torch.from_numpy(s_img).to(DEV)
    targets = maskrcnn_train.build_targets(np.random.default_rng(1), s_gt, s_masks, hw, cfg, DEV)
    mr_ms = step_ms(lambda: maskrcnn_train.train_step(opt_p, opt, t_img, targets, hw, cfg), 20)
    print(f"[12c] Mask R-CNN loss card vs CPU: {res[0][0]:.8f} vs {res[1][0]:.8f} (rel {l_err:.3e}); gradients "
          f"|d| / max |g| up to {g_err:.3e} over {len(res[0][1])} tensors; "
          f"train_step {mr_ms:.3f} ms (mean of 20, synchronized)")
    check(l_err <= MR_STEP_LOSS_TOL and g_err <= MR_STEP_GRAD_TOL,
          f"12c: Mask R-CNN step card vs CPU: loss {l_err}, gradients {g_err}")
    out["maskrcnn"] = {"fit_s": fit_s, "box_iou": rep["box_iou"], "mask_iou": rep["mask_iou"],
                       "detections": rep["detections"], "step_ms": mr_ms, "loss_rel_err": l_err,
                       "grad_rel_err": g_err}

    pcfg = pointpillars_train.small_config()
    t0 = time.perf_counter()
    with layers.deterministic():
        pparams, scan, pgt = pointpillars_train.overfit_scene(pcfg, steps=640, seed=0, device=DEV)
        boxes = pointpillars.Detector3D(params=pparams, cfg=pcfg, device=DEV).make_prediction(scan)
    torch.cuda.synchronize()
    pfit_s = time.perf_counter() - t0
    prep = pointpillars_train.closed_loop_report(boxes, pgt, pcfg)
    print(f"[12c] PointPillars closed loop (small config, 640 steps, deterministic, {pfit_s:.1f} s with the "
          f"prediction): {prep['detections']} detections for {len(pgt)} planted; centre distances "
          f"{[round(d, 4) for d in prep['dists']]} m, each detection's nearest planted "
          f"{[round(d, 4) for d in prep['far']]} m; size errors w {prep['w_err']:.4f}, l {prep['l_err']:.4f} m")
    check(prep["found"], f"12c: PointPillars recovered {prep['dists']}")
    check(prep["clean"], f"12c: a spurious PointPillars detection ({prep['far']})")
    check(prep["sizes"], f"12c: PointPillars size errors {prep['w_err']}, {prep['l_err']}")

    t0 = time.perf_counter()
    with layers.deterministic():
        bparams, tail = pointpillars_train.fit_synthetic_bn(pcfg, steps=600, seed=0, device=DEV)
        brep = pointpillars_train.cross_scene_report(
            pointpillars.Detector3D(params=bparams, cfg=pcfg, device=DEV).make_prediction, pcfg)
    torch.cuda.synchronize()
    bn_s = time.perf_counter() - t0
    print(f"[12c] PointPillars BN trainer (600 steps, deterministic, {bn_s:.1f} s with the predictions, last "
          f"losses {[round(x, 4) for x in tail]}): {brep['recovered']} of {brep['total']} planted boxes on 4 "
          f"unseen scenes (need {brep['need']})")
    check(brep["ok"], f"12c: BN cross-scene recall {brep['recovered']}/{brep['total']}")
    anchors = pointpillars_train.head_anchors(pcfg)
    sp, tg = pointpillars_train.scene_tensors(scan, pgt, anchors, pcfg, DEV)
    pp = layers.trainable(pointpillars.init_params(pcfg), DEV)
    trainer = layers.Trainer(layers.leaves(pp), 2e-3)
    pp_ms = step_ms(lambda: pointpillars_train.train_step(pp, trainer, sp, tg, pcfg), 20)
    bn = pointpillars_train.init_bn_state(pcfg, DEV)
    for t in pointpillars_train.bn_trainables(bn):
        t.requires_grad_(True)
    bn_tr = layers.Trainer(layers.leaves(pp) + pointpillars_train.bn_trainables(bn), 2e-3)
    bn_ms = step_ms(lambda: pointpillars_train.train_step_bn(pp, bn, bn_tr, sp, tg, pcfg), 20)
    print(f"[12c] PointPillars train_step {pp_ms:.3f} ms, BN train_step {bn_ms:.3f} ms (means of 20 on one scene, "
          f"synchronized; the BN run above also generated a scene per step on the host) on {name}")
    out["pointpillars"] = {"fit_s": pfit_s, "dists_m": prep["dists"], "w_err": prep["w_err"],
                           "l_err": prep["l_err"], "step_ms": pp_ms}
    out["pointpillars_bn"] = {"fit_s": bn_s, "recovered": brep["recovered"], "total": brep["total"],
                              "step_ms": bn_ms}
    return out


def phase_vocabulary(tmp: str, images, name: str) -> dict:
    """12d: apps.train_vocabulary.main over 10 of phase 7's left frames
    written as PNG (branching 4, 3 levels): one K2 launch per image; then
    apps.dsp_slam.main --vocabulary with that file over mini-KITTI."""
    from PIL import Image

    img_dir = os.path.join(tmp, "voc_images")
    os.makedirs(img_dir, exist_ok=True)
    for k, (left, _) in enumerate(images[::3][:10]):
        Image.fromarray(left).save(os.path.join(img_dir, f"{k:06d}.png"))
    voc_path = os.path.join(tmp, "voc12.npz")
    mark = launch_mark()
    t0 = time.perf_counter()
    voc = train_vocabulary.main(["--image_dir", img_dir, "--output", voc_path, "--stride", "1", "--branching", "4",
                                 "--levels", "3"])
    torch.cuda.synchronize()
    voc_s = time.perf_counter() - t0
    k2 = launches_since(mark)[1]
    t0 = time.perf_counter()
    system = dsp_slam.main(["--sequence_dir", MINI_KITTI, "--config", mini_kitti_config(tmp), "--map_dir",
                            os.path.join(tmp, "voc_map"), "--vocabulary", voc_path])
    slam_s = time.perf_counter() - t0
    lost = sum(1 for _, _, l in system.tracker.trajectory if l)
    print(f"[12d] train_vocabulary over 10 frames of 376x1241 ({voc_s:.2f} s): {voc.n_words} words, K2 launches "
          f"{k2}; dsp_slam --vocabulary over mini-KITTI ({slam_s:.2f} s): {len(system.tracker.trajectory)} frames, "
          f"{lost} lost, loop closer attached {system.loop_closer is not None}, {len(system.kf_db.vectors)} "
          f"keyframes indexed on {name}")
    check(k2 == 10 and voc.n_words == 64, f"12d: {k2} K2 launches for 10 images, {voc.n_words} words")
    check(lost == 0 and system.loop_closer is not None and len(system.kf_db.vectors) >= 1,
          "12d: dsp_slam with the trained vocabulary")
    return {"k2_launches": k2, "train_s": voc_s, "slam_s": slam_s}


def phase_overlays(tmp: str, name: str) -> dict:
    """12e: apps.dsp_slam.main --overlay_dir over mini-KITTI on the card
    (pipelined): one PNG per finished frame, each the shape of its frame."""
    from PIL import Image

    out = os.path.join(tmp, "overlays")
    t0 = time.perf_counter()
    dsp_slam.main(["--sequence_dir", MINI_KITTI, "--config", mini_kitti_config(tmp), "--map_dir",
                   os.path.join(tmp, "overlay_map"), "--no_loop", "--pipeline", "--overlay_dir", out])
    wall = time.perf_counter() - t0
    pngs = sorted(os.listdir(out))
    shapes = {np.asarray(Image.open(os.path.join(out, f))).shape for f in pngs}
    print(f"[12e] dsp_slam --overlay_dir --pipeline over mini-KITTI ({wall:.2f} s): {pngs}, shapes {shapes} "
          f"on {name}")
    check(pngs == ["000000.png", "000001.png", "000002.png"] and shapes == {(160, 512, 3)},
          f"12e: overlays {pngs} of shapes {shapes}")
    return {"overlays": len(pngs), "wall_s": wall}


# phase 13: the (dp, tp) mesh (slice 8)
SLICE8_BATCH = 16384          # train_deepsdf's default batch
SLICE8_SHAPES = 8             # train_deepsdf --synthetic's shape count
SLICE8_SEED = 13
SLICE8_LOSS_TOL = 1e-6        # relative, sharded vs one-process step
SLICE8_GRAD_TOL = 1e-5        # max |d| / max |g| per tensor
SLICE8_PARAM_TOL = 1e-6       # absolute
GN_ITER1_TOL = 1e-4           # poses and codes, sharded vs unsharded after one GN iteration


def decoder_spec(dec) -> dict:
    """A decoder as `parallel.dryrun.run_cases` takes it."""
    return {"config": dataclasses.asdict(dec.config), "weights": [w.detach().cpu() for w in dec.weights],
            "biases": [b.detach().cpu() for b in dec.biases]}


def state_tensors(st) -> list:
    return [p.detach() for p in st.decoder.parameters()] + [st.codes.detach()]


def phase_sharded_training(name: str) -> dict:
    """13a: the sharded train_step on a (1, 1) NCCL mesh at train_deepsdf's
    defaults (the canonical decoder, code 64, batch 16384, 8 sphere shapes)
    against the one-process train_step from the same state: the loss of 3
    steps, the first step's gradients, the parameters after steps 1 and 3;
    ms per step of each, in turns."""
    # float32 products: 13d holds the tp = 2 step's gradients to float64
    cfg = deepsdf.DecoderConfig(matmul_precision="highest")
    gen = torch.Generator(device=DEV).manual_seed(SLICE8_SEED)
    batches = [deepsdf_train.make_sphere_dataset(gen, SLICE8_SHAPES, SLICE8_BATCH) for _ in range(3)]
    mesh = mesh_utils.make_mesh(device=DEV)
    check(tuple(mesh.shape) == (1, 1) and dist.get_backend() == "nccl",
          f"13a: mesh {tuple(mesh.shape)} over {dist.get_backend()}")
    start = deepsdf_train.init_state(cfg, SLICE8_SHAPES, seed=SLICE8_SEED, device=DEV)
    spec = {"decoder": decoder_spec(start.decoder), "codes": start.codes.detach().cpu(), "lr": 5e-4, "clamp": 0.1,
            "batches": [{k: v.cpu() for k, v in batches[0].items()}], "tp": None}
    one = deepsdf_train.init_state(cfg, SLICE8_SHAPES, seed=SLICE8_SEED, device=DEV)
    sharded = deepsdf_train.shard_state(start, mesh)
    f64 = deepsdf_train.init_state(cfg, SLICE8_SHAPES, seed=SLICE8_SEED, device=DEV)
    f64.decoder.double()
    f64.codes.data = f64.codes.data.double()
    deepsdf_train.train_step(f64, {k: v.double() if v.is_floating_point() else v for k, v in batches[0].items()})
    grads64 = [p.grad.cpu() for p in f64.decoder.parameters()] + [f64.codes.grad.cpu()]
    errs = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    ref = {}
    # deterministic scatter-adds (the code table's gradient), so that the two
    # paths differ only where the sharding makes them, not in atomics' order
    with layers.deterministic():
        for i, batch in enumerate(batches):
            l_one, l_sh = float(deepsdf_train.train_step(one, batch)), float(deepsdf_train.train_step(sharded, batch))
            errs["loss"] = max(errs["loss"], abs(l_one - l_sh) / abs(l_one))
            if i == 0:
                ws, bs = sharded.decoder.gather([w.grad for w in sharded.decoder.weights],
                                                [b.grad for b in sharded.decoder.biases])
                g_one = [p.grad for p in one.decoder.parameters()] + [one.codes.grad]
                errs["grad"] = max(grad_errs(g_one, ws + bs + [sharded.codes.grad]))
                ref = {"loss": l_one, "grads": [g.detach().cpu().clone() for g in g_one],
                       "params": [t.cpu().clone() for t in state_tensors(one)], "grads64": grads64}
            if i in (0, 2):
                full = deepsdf_train.gather_state(sharded)
                errs["param"] = max([errs["param"]] + [float((a - b).abs().max())
                                                       for a, b in zip(state_tensors(one), state_tensors(full))])
    ms = {"one": [], "sharded": []}
    for path in ("one", "sharded", "sharded", "one"):
        st = one if path == "one" else sharded
        ms[path].append(step_ms(lambda: deepsdf_train.train_step(st, batches[0]), 10))
    ms = {k: float(np.mean(v)) for k, v in ms.items()}
    print(f"[13a] sharded train_step on a (1, 1) NCCL mesh (canonical decoder, batch {SLICE8_BATCH}, "
          f"{SLICE8_SHAPES} shapes) vs one-process: loss rel {errs['loss']:.3e} over 3 steps, gradients "
          f"{errs['grad']:.3e} of the largest, parameters after steps 1 and 3 max |d| {errs['param']:.3e}; "
          f"ms per step sharded {ms['sharded']:.3f}, one-process {ms['one']:.3f} (mean of two turns of 10, "
          f"synchronized) on {name}")
    check(errs["loss"] <= SLICE8_LOSS_TOL and errs["grad"] <= SLICE8_GRAD_TOL and errs["param"] <= SLICE8_PARAM_TOL,
          f"13a: sharded step differs from the one-process step: {errs}")
    return {"errs": errs, "ms": ms, "spec": spec, "ref": ref}


def phase_sharded_gn(decoder, name: str) -> dict:
    """13b: sharded_object_gn on a (1, 1) NCCL mesh at bench_gn's inputs
    (B=8, P=256, R=512, S=50, K=1024) with 12a's fitted canonical decoder
    against the unsharded batched_reconstruct: K1 launched exactly 2 x 10
    times in the 10-iteration call; poses and codes within 1e-4 after one
    iteration and, after 10, as close to a float64 run as phase 5 asks;
    ms per object of each, in turns."""
    B, args = bench_gn_inputs()
    mesh = mesh_utils.make_mesh(tp=1, device=DEV)
    f64 = deepsdf_train.frozen_decoder(decoder).double()
    f64.sdf_and_input_grad = lambda x: decoder_fused.sdf_and_input_grad_plain(list(f64.weights), list(f64.biases), x)
    out = {"spec_args": [a.cpu() for a in args], "ref": {}}
    for iters in (1, 10):
        recon = gn.batched_reconstruct(decoder, gn.GNConfig(code_len=64, num_iterations=iters))
        ref = recon(*args)
        mark = launch_mark()
        got = mesh_utils.sharded_object_gn(mesh, recon, decoder, *args)
        launches = launches_since(mark)[0]
        check(launches == 2 * iters, f"13b: K1 launched {launches} times in {iters} sharded GN iterations")
        d = max(float((got[k] - ref[k]).abs().max()) for k in ("t_cam_obj", "code"))
        out["ref"][iters] = {k: v.cpu() for k, v in ref.items()}
        if iters == 1:
            check(d <= GN_ITER1_TOL, f"13b: sharded GN {d} from unsharded after 1 iteration")
            print(f"[13b] sharded_object_gn (1, 1) vs unsharded after 1 iteration: max |d| {d:.3e}")
            continue
        ref64 = gn.batched_reconstruct(f64, gn.GNConfig(code_len=64, num_iterations=10))(*[a.double() for a in args])
        d64 = {p: max(float((o[k].double() - ref64[k]).abs().max()) for k in ("t_cam_obj", "code"))
               for p, o in (("sharded", got), ("unsharded", ref))}
        bound = TOL_ITER10_FACTOR * d64["unsharded"] + TOL_ITER10_FLOOR
        print(f"[13b] after 10 iterations: sharded vs unsharded max |d| {d:.3e}; vs float64: sharded "
              f"{d64['sharded']:.3e}, unsharded {d64['unsharded']:.3e}; K1 launches {launches}; is_good "
              f"{got['is_good'].tolist()}")
        check(d64["sharded"] <= bound, f"13b: sharded GN {d64['sharded']} from float64 after 10 iterations, bound {bound}")
        out["ref64"] = {k: v.cpu() for k, v in ref64.items()}
        out["launches"], out["d10"] = launches, d
    runs = {"unsharded": [], "sharded": []}
    for path in ("unsharded", "sharded", "sharded", "unsharded"):
        if path == "sharded":
            runs[path].append(cuda_ms(lambda: mesh_utils.sharded_object_gn(mesh, recon, decoder, *args), 3) / B)
        else:
            runs[path].append(cuda_ms(lambda: recon(*args), 3) / B)
    out["ms"] = {k: float(np.mean(v)) for k, v in runs.items()}
    print(f"[13b] GN ms per object at bench_gn shapes (10 iterations, fitted decoder): sharded "
          f"{out['ms']['sharded']:.3f}, unsharded {out['ms']['unsharded']:.3f} on {name}")
    return out


def phase_sharded_extract(tmp: str, decoder, name: str) -> dict:
    """13c: decode_sdf_grid_sharded at 64^3 against decode_sdf_grid; then
    extract_map_objects --shard over a two-object map with 12a's fitted
    decoder, exported: the .ply and pose files equal the unsharded run's."""
    mesh = mesh_utils.make_mesh(tp=1, device=DEV)
    code = torch.from_numpy(np.random.default_rng(13).normal(0, 0.02, 64).astype(np.float32)).to(DEV)
    with torch.no_grad():
        d = float((mesh_mod.decode_sdf_grid_sharded(decoder, code, 64, mesh)
                   - mesh_mod.decode_sdf_grid(decoder, code, 64)).abs().max())
    print(f"[13c] decode_sdf_grid_sharded (1, 1) vs decode_sdf_grid at 64^3: max |d| {d:.3e}")
    check(d <= 1e-6, f"13c: sharded voxel decode differs by {d}")
    map_dir = os.path.join(tmp, "slice8_map")
    os.makedirs(map_dir)
    with open(os.path.join(map_dir, "MapObjects.txt"), "w") as f:
        for obj_id, scale in ((1, 0.0), (2, 0.02)):
            Two = np.eye(4)[:3]
            Two[:, 3] = (obj_id, 0.0, 10.0)
            c = scale * np.random.default_rng(obj_id).normal(size=64)
            f.write(f"{obj_id}\n{' '.join(map(str, Two.ravel()))}\n{' '.join(map(str, c))}\n")
    exp = os.path.join(tmp, "slice8_decoder")
    deepsdf_train.export_reference_format(deepsdf_train.state_from(decoder, torch.zeros(1, 64)), exp)
    cfg_path = os.path.join(tmp, "slice8_config.json")
    SystemConfig(deepsdf_dir=exp).to_json(cfg_path)
    outs = {}
    for mode in ("shard", "plain"):
        out_dir = os.path.join(tmp, f"slice8_meshes_{mode}")
        argv = ["--map_dir", map_dir, "--config", cfg_path, "--output_dir", out_dir, "--device", DEV.type]
        extract_map_objects.main(argv + (["--shard"] if mode == "shard" else []))
        outs[mode] = out_dir
    verts = []
    for obj_id in (1, 2):
        for suffix in (".ply", "_pose.npy"):
            a, b = (open(os.path.join(outs[m], f"{obj_id}{suffix}"), "rb").read() for m in ("shard", "plain"))
            check(a == b, f"13c: extract_map_objects --shard wrote another {obj_id}{suffix}")
        verts.append(len(read_mesh_ply(os.path.join(outs["shard"], f"{obj_id}.ply"))[0]))
    print(f"[13c] extract_map_objects --shard: {verts} vertices, .ply and pose files equal the unsharded run's")
    check(min(verts) > 100, f"13c: meshes of {verts} vertices")
    return {"decode_err": d, "vertices": verts}


def adam_first_step_gap(g_a: list, g_b: list, lr: float) -> list:
    """|p_a - p_b| that Adam's first step (p -= lr g / (|g| + eps)) makes of
    two gradients of one start, per entry."""
    def phi(g):
        g = g.double()
        return g / (g.abs() + 1e-8)

    return [lr * (phi(a) - phi(b)).abs() for a, b in zip(g_a, g_b)]


def phase_two_ranks(tmp: str, train: dict, sharded_gn: dict, decoder, name: str) -> dict:
    """13d: two gloo ranks on the one card (NCCL refuses two ranks on one
    device; gloo carries the CUDA tensors of broadcast, all_reduce and
    all_gather through the host): 13a's first step at tp = 2 against 13a's
    one-process step, and sharded_object_gn at dp = 2 against 13b, with 2
    K1 launches per GN iteration on each rank. Correctness only: no time
    is read from gloo."""
    out_dir = os.path.join(tmp, "slice8_ranks")
    os.makedirs(out_dir)
    spec = {"train": train["spec"]}
    for iters in (1, 10):
        spec[f"gn:{iters}"] = {"decoder": decoder_spec(decoder), "tp": 1, "args": sharded_gn["spec_args"],
                               "gn_config": {"code_len": 64, "num_iterations": iters}}
    torch.save(spec, os.path.join(out_dir, "spec.pt"))
    t0 = time.perf_counter()
    dryrun.spawn(dryrun.run_cases, 2, os.path.join(out_dir, "spec.pt"), out_dir, DEV.type, device=DEV,
                 backend="gloo")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True) for r in range(2)]
    res = {"wall_s": wall, "k1_launches": [r["gn:10"]["k1_launches"] for r in ranks]}
    for r, got in enumerate(ranks):
        t = got["train"]
        loss = abs(t["losses"][0] - train["ref"]["loss"]) / abs(train["ref"]["loss"])
        grad = max(grad_errs(train["ref"]["grads"], t["grads"]))
        # as in 12a: the L1 gradient is a sign per row, so another summation
        # order moves the 16384-row sums; each run is held to float64
        e_tp, e_one = (max(grad_errs(train["ref"]["grads64"], g)) for g in (t["grads"], train["ref"]["grads"]))
        gap = adam_first_step_gap(t["grads"], train["ref"]["grads"], train["spec"]["lr"])
        excess = max(float(((a - b).abs().double() - g).max())
                     for a, b, g in zip(t["params"], train["ref"]["params"], gap))
        d1 = max(float((got["gn:1"][k] - sharded_gn["ref"][1][k]).abs().max()) for k in ("t_cam_obj", "code"))
        d10 = max(float((got["gn:10"][k] - sharded_gn["ref"][10][k]).abs().max()) for k in ("t_cam_obj", "code"))
        d64 = max(float((got["gn:10"][k].double() - sharded_gn["ref64"][k]).abs().max()) for k in ("t_cam_obj", "code"))
        u64 = max(float((sharded_gn["ref"][10][k].double() - sharded_gn["ref64"][k]).abs().max())
                  for k in ("t_cam_obj", "code"))
        print(f"[13d] rank {r} of 2 (gloo on the card): train mesh {t['mesh']}: loss rel {loss:.3e}, gradients "
              f"{grad:.3e} of the largest (from float64: tp = 2 {e_tp:.3e}, 13a's one-process {e_one:.3e}), "
              f"parameters beyond Adam's first-step map of the gradient difference "
              f"{excess:.3e}; GN mesh dp = 2: after 1 iteration max |d| {d1:.3e} from 13b, after 10 {d10:.3e} "
              f"(vs float64 {d64:.3e}, 13b's unsharded {u64:.3e}); K1 launches {got['gn:1']['k1_launches']} + "
              f"{got['gn:10']['k1_launches']}")
        check(t["mesh"] == (1, 2) and loss <= SLICE8_LOSS_TOL and excess <= SLICE8_PARAM_TOL
              and e_tp <= max(FIT_GRAD_FACTOR * e_one, FIT_GRAD_FLOOR),
              f"13d: rank {r}'s tp = 2 step differs from 13a's: loss {loss}, gradients from float64 {e_tp} "
              f"(one-process {e_one}), parameters {excess}")
        check(got["gn:1"]["k1_launches"] == 2 and got["gn:10"]["k1_launches"] == 20,
              f"13d: rank {r} launched K1 {got['gn:1']['k1_launches']} + {got['gn:10']['k1_launches']} times")
        check(d1 <= GN_ITER1_TOL and d64 <= TOL_ITER10_FACTOR * u64 + TOL_ITER10_FLOOR,
              f"13d: rank {r}'s dp = 2 GN differs from 13b: {d1} after 1 iteration, {d64} from float64 after 10")
        res[f"rank{r}"] = {"loss_rel": loss, "grad_err": grad, "grad_err_f64": e_tp, "one_process_grad_err_f64": e_one,
                           "param_excess": excess, "gn_d1": d1, "gn_d10": d10}
    print(f"[13d] two gloo ranks on the card: {wall:.1f} s (spawn and CUDA start included)")
    return res


def phase_mesh(tmp: str, decoder, name: str) -> dict:
    """13a-13c in a one-rank NCCL group that this phase opens and destroys,
    then 13d in two spawned gloo ranks."""
    with mesh_utils.process_group(DEV):
        train = phase_sharded_training(name)
        sharded_gn = phase_sharded_gn(decoder, name)
        extract = phase_sharded_extract(tmp, decoder, name)
    check(not dist.is_initialized(), "13: the one-rank group was not destroyed")
    two = phase_two_ranks(tmp, train, sharded_gn, decoder, name)
    return {"training": {"errs": train["errs"], "ms_per_step": train["ms"]},
            "gn": {"ms_per_object": sharded_gn["ms"], "k1_launches": sharded_gn["launches"],
                   "d10": sharded_gn["d10"]},
            "extract": extract, "two_ranks": two}


# phase 14: the decoder's configuration contract (slice 9)
# the layout train_deepsdf --layers 4 --hidden 256 builds
WIDE_DECODER = deepsdf.DecoderConfig(code_len=64, hidden=(256,) * 4, latent_in=(2,))
# bf16 vs f32 forward, absolute: 2^-8 rounding at each of 8 activations (11a's bf16 bound)
BF16_FORWARD_TOL = 5e-2
GENERIC_SDF_TOL = 1e-5         # the generic path at "highest" vs float64: K1's sdf tolerance (phase 3)
GENERIC_GRAD_TOL = 1e-4        # and its gradient's: 99th percentile of the row error, a few ReLU-boundary rows over


def gn_distance(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in ("t_cam_obj", "code"))


class RowCounter(torch.nn.Module):
    """A decoder whose forward calls (the render grid's decode) record their
    row counts; sdf_and_input_grad goes to the decoder itself."""

    def __init__(self, decoder):
        super().__init__()
        self.decoder = decoder
        self.rows = []

    def forward(self, x):
        self.rows.append(x.shape[0])
        return self.decoder(x)

    def sdf_and_input_grad(self, x):
        return self.decoder.sdf_and_input_grad(x)


def counted_gn(decoder, cfg: gn.GNConfig, args) -> tuple[dict, int, int]:
    """One GN call under torch.profiler: (result, K1 launches by the
    wrapper's count, K1 kernels the profiler saw). The count is exact; the
    profiler is the device's witness, and it may miss a launch of a kernel
    called through ctypes (19 of 20 once, as `kernel_device_ms` says), so
    `k1_counted` holds it to at least one and at most the count."""
    mark = launch_mark()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = gn.batched_reconstruct(decoder, cfg)(*args)
        torch.cuda.synchronize()
    seen = sum(e.count for e in prof.key_averages() if "decoder_fused_kernel" in e.key)
    return out, launches_since(mark)[0], seen


def k1_counted(launches: int, seen: int, expected: int) -> bool:
    """The wrapper launched K1 `expected` times and the profiler saw it on
    the device (or saw none where none was expected)."""
    return launches == expected and (seen == 0 if expected == 0 else 0 < seen <= launches)


def precision_ab(decs: dict, f64_decoder, args, ref64_iter1: dict | None = None) -> dict:
    """The GN at `args` with the same weights at "highest" and "default"
    (`decs`): the two after 1 iteration (k4 = 1e7), and each one's distance
    from `f64_decoder`'s run after 1 iteration and after 10 with k4 = 0."""
    out1 = {p: gn.batched_reconstruct(d, gn.GNConfig(code_len=64, num_iterations=1))(*args) for p, d in decs.items()}
    if ref64_iter1 is None:
        ref64_iter1 = gn.batched_reconstruct(f64_decoder, gn.GNConfig(code_len=64, num_iterations=1))(
            *[a.double() for a in args])
    cfg10 = gn.GNConfig(code_len=64, num_iterations=10, k4=0.0)
    ref10 = gn.batched_reconstruct(f64_decoder, cfg10)(*[a.double() for a in args])
    d64_10 = {p: gn_distance(gn.batched_reconstruct(d, cfg10)(*args), ref10) for p, d in decs.items()}
    r = {"d1": gn_distance(out1["default"], out1["highest"]),
         "d64_iter1": {p: gn_distance(o, ref64_iter1) for p, o in out1.items()},
         "d64_iter10_k4_0": d64_10, "bound10": TOL_ITER10_FACTOR * d64_10["highest"] + TOL_ITER10_FLOOR}
    r["holds"] = r["d1"] <= TOL_ITER1 and d64_10["default"] <= r["bound10"]
    return r


def phase_precision_ab(gn5: dict, fitted, name: str) -> dict:
    """14a: the GN at bench_gn's inputs on the canonical decoder (K1) at
    matmul_precision "highest" and "default", with phase 5's random weights
    and with 12a's decoder fitted to spheres (whose render samples fall in
    the occupancy band, where the grid's sdf matters): after 1 iteration
    (k4 = 1e7) the two within TOL_ITER1; after 10 with k4 = 0 "default" as
    close to a float64 run as phase 5 holds K1 (factor and floor). Either
    all hold and the shipped default may be "default", or the default must
    be "highest". ms per object at each precision, in turns (random
    weights, as phase 5); the render grid's forward per GN call; the
    generic path's time at N = 2048 and 8192."""
    B, args = bench_gn_inputs()
    params_np = canonical_params_np(seed=0)
    decs = {p: deepsdf.params_from_jax(params_np, deepsdf.DecoderConfig(matmul_precision=p), device=DEV)
            for p in ("highest", "default")}
    fitted_decs = {p: deepsdf.DeepSDFDecoder(dataclasses.replace(fitted.config, matmul_precision=p),
                                             list(fitted.weights), list(fitted.biases))
                   for p in ("highest", "default")}
    fitted64 = deepsdf_train.frozen_decoder(fitted).double()
    fitted64.sdf_and_input_grad = lambda x: decoder_fused.sdf_and_input_grad_plain(
        list(fitted64.weights), list(fitted64.biases), x)
    ab = {"random": precision_ab(decs, gn5["f64_decoder"], args, gn5["ref64_iter1"]),
          "fitted": precision_ab(fitted_decs, fitted64, args)}
    holds = all(r["holds"] for r in ab.values())
    shipped = deepsdf.DecoderConfig().matmul_precision
    for weights, r in ab.items():
        print(f"[14a] GN at bench_gn shapes, canonical decoder ({weights} weights) with K1, 'default' (TF32 products) "
              f"vs 'highest' (f32): after 1 iteration (k4 = 1e7) max |d| {r['d1']:.3e} (limit {TOL_ITER1}; vs float64 "
              f"default {r['d64_iter1']['default']:.3e}, highest {r['d64_iter1']['highest']:.3e}); after 10 with "
              f"k4 = 0 vs float64: default {r['d64_iter10_k4_0']['default']:.3e}, highest "
              f"{r['d64_iter10_k4_0']['highest']:.3e} (bound {r['bound10']:.3e})")
    print(f"[14a] TF32 {'holds' if holds else 'moves the GN'}; the shipped default is {shipped!r}")
    check(holds or shipped == "highest", f"14a: TF32 moves the GN ({ab}) but the shipped matmul_precision is {shipped!r}")

    cfg = gn.GNConfig(code_len=64, num_iterations=10)
    runs = {"highest": [], "default": []}
    for p in ("highest", "default", "default", "highest"):
        run = gn.batched_reconstruct(decs[p], cfg)
        runs[p].append(cuda_ms(lambda: run(*args), 3) / B)
    ms = {p: float(np.mean(v)) for p, v in runs.items()}
    _, launches, seen = counted_gn(decs[shipped], cfg, args)
    check(k1_counted(launches, seen, 2 * 10), f"14a: the canonical f32 decoder launched K1 {launches} times "
                                      f"(profiler {seen}), expected 20")
    rows = B * args[3].shape[1] * cfg.num_depth_samples
    grid = torch.rand((rows, 67), device=DEV, generator=torch.Generator(device=DEV).manual_seed(14)) * 2 - 1
    grid_ms = {}
    with torch.no_grad():
        for p in ("highest", "default", "default", "highest"):
            grid_ms.setdefault(p, []).append(cuda_ms(lambda: decs[p](grid), 3) * cfg.num_iterations)
    grid_ms = {p: float(np.mean(v)) for p, v in grid_ms.items()}
    generic_ms = {p: {} for p in decs}
    for n in (2048, 8192):
        x = grid[:n].contiguous()
        for p in ("highest", "default", "default", "highest"):
            generic_ms[p].setdefault(n, []).append(
                cuda_ms(lambda: deepsdf.sdf_and_input_grad_generic(decs[p], x), 10))
    generic_ms = {p: {n: float(np.mean(v)) for n, v in d.items()} for p, d in generic_ms.items()}
    print(f"[14a] GN ms per object (10 iterations, k4 = 1e7; turns highest, default, default, highest): highest "
          f"{ms['highest']:.3f} ({runs['highest'][0]:.3f}, {runs['highest'][1]:.3f}), default {ms['default']:.3f} "
          f"({runs['default'][0]:.3f}, {runs['default'][1]:.3f}); K1 launches {launches} (profiler {seen}); the render "
          f"grid's forward per GN call ({rows} rows x 10): highest {grid_ms['highest']:.3f} ms, default "
          f"{grid_ms['default']:.3f} ms; the generic path (forward + autograd, what JAX runs on a GPU) at N = 2048 / "
          f"8192: highest {generic_ms['highest'][2048]:.4f} / {generic_ms['highest'][8192]:.4f} ms, default "
          f"{generic_ms['default'][2048]:.4f} / {generic_ms['default'][8192]:.4f} ms on {name}")
    return {"ab": ab, "tf32_holds": holds, "shipped": shipped, "gn_ms_per_object": ms, "k1_launches": launches,
            "grid_ms_per_gn": grid_ms, "generic_ms": generic_ms}


def phase_other_decoders(name: str) -> dict:
    """14b: a 4 x 256 decoder (latent_in (2,), as train_deepsdf --layers 4
    --hidden 256 builds it) with seeded weights: its generic path at
    "highest" against a float64 generic run (K1's tolerances), sync-free;
    its GN at bench_gn's inputs finite after 10 iterations with 0 K1
    launches. 14c: the canonical decoder at compute_dtype bfloat16: its
    forward within BF16_FORWARD_TOL of the f32 forward, its GN finite with 0
    K1 launches."""
    B, args = bench_gn_inputs()
    gen = torch.Generator(device=DEV).manual_seed(141)
    x = torch.cat([torch.randn((8192, 64), device=DEV, generator=gen) * 0.02,
                   torch.rand((8192, 3), device=DEV, generator=gen) * 2 - 1], dim=-1)
    cfg10 = gn.GNConfig(code_len=64, num_iterations=10)
    wide_np = canonical_params_np(seed=14, config=WIDE_DECODER)
    wide = {p: deepsdf.params_from_jax(wide_np, dataclasses.replace(WIDE_DECODER, matmul_precision=p), device=DEV)
            for p in ("highest", "default")}
    wide64 = deepsdf.params_from_jax(wide_np, WIDE_DECODER, device=DEV).double()
    sdf64, grad64 = deepsdf.sdf_and_input_grad_generic(wide64, x.double())
    errs = {}
    for p, dec in wide.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sdf, grad = dec.sdf_and_input_grad(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        row = (grad.double() - grad64).abs().amax(dim=1)
        errs[p] = {"sdf": float((sdf.double() - sdf64).abs().max()), "grad_p99": float(torch.quantile(row, 0.99)),
                   "grad_rows_over": int((row > GENERIC_GRAD_TOL).sum()), "grad_max": float(row.max())}
    e = errs["highest"]
    check(e["sdf"] <= GENERIC_SDF_TOL and e["grad_p99"] < GENERIC_GRAD_TOL and e["grad_rows_over"] <= 8,
          f"14b: the generic path at 'highest' is {e} from float64")
    out_w, launches_w, seen_w = counted_gn(wide[deepsdf.DecoderConfig().matmul_precision], cfg10, args)
    finite_w = bool(torch.isfinite(out_w["t_cam_obj"]).all() and torch.isfinite(out_w["code"]).all())
    print(f"[14b] 4 x 256 decoder (latent_in (2,)), generic path on 8192 rows (sync-free) vs float64: 'highest' "
          f"sdf {e['sdf']:.3e}, gradient rows p99 {e['grad_p99']:.3e} (max {e['grad_max']:.3e}, "
          f"{e['grad_rows_over']} over {GENERIC_GRAD_TOL}); 'default' sdf {errs['default']['sdf']:.3e}, p99 "
          f"{errs['default']['grad_p99']:.3e}; GN 10 iterations at bench_gn shapes: finite {finite_w}, is_good "
          f"{out_w['is_good'].tolist()}, K1 launches {launches_w} (profiler {seen_w})")
    check(finite_w and k1_counted(launches_w, seen_w, 0),
          f"14b: GN finite {finite_w}, K1 launches {launches_w} / {seen_w}")

    canon_np = canonical_params_np(seed=0)
    f32 = deepsdf.params_from_jax(canon_np, deepsdf.DecoderConfig(matmul_precision="highest"), device=DEV)
    bf16 = deepsdf.params_from_jax(canon_np, deepsdf.DecoderConfig(compute_dtype=torch.bfloat16), device=DEV)
    with torch.no_grad():
        d_fwd = float((bf16(x) - f32(x)).abs().max())
    sdf_b, grad_b = bf16.sdf_and_input_grad(x)
    sdf_f, grad_f = f32.sdf_and_input_grad(x)
    d_gen = float((sdf_b - sdf_f).abs().max())
    g_rel = float((grad_b - grad_f).norm() / grad_f.norm())
    out_b, launches_b, seen_b = counted_gn(bf16, cfg10, args)
    finite_b = bool(torch.isfinite(out_b["t_cam_obj"]).all() and torch.isfinite(out_b["code"]).all())
    print(f"[14c] bf16 canonical decoder: forward (torch.mm out_dtype=float32, bf16 tensor cores) vs the f32 "
          f"forward max |d| {d_fwd:.3e} (limit {BF16_FORWARD_TOL}); generic path (f32 products of bf16-rounded "
          f"operands) sdf {d_gen:.3e}, gradient {g_rel:.3e} of the f32 gradient's norm; GN 10 iterations finite "
          f"{finite_b}, is_good {out_b['is_good'].tolist()}, K1 launches {launches_b} (profiler {seen_b}) on {name}")
    check(d_fwd <= BF16_FORWARD_TOL and d_gen <= BF16_FORWARD_TOL, f"14c: bf16 forward {d_fwd}, generic {d_gen}")
    check(finite_b and k1_counted(launches_b, seen_b, 0),
          f"14c: GN finite {finite_b}, K1 launches {launches_b} / {seen_b}")
    return {"wide_generic_err": errs, "wide_k1_launches": launches_w, "bf16_forward_err": d_fwd,
            "bf16_generic_sdf_err": d_gen, "bf16_generic_grad_rel": g_rel, "bf16_k1_launches": launches_b}


def phase_render_eval_fraction(name: str) -> dict:
    """14d: GNConfig.render_eval_fraction at bench_gn's inputs on phase 5's
    canonical decoder: a fraction whose cap is the most valid samples an
    object has (so it truncates none) gives the uncapped GN's result
    exactly after one iteration; at
    0.5 the GN decodes B * int(R * S / 2) rows per iteration and ends finite
    after 10, with K1's 20 launches; ms per object of each, in turns."""
    B, args = bench_gn_inputs()
    R, S = args[3].shape[1], gn.GNConfig().num_depth_samples
    dec = deepsdf.params_from_jax(canonical_params_np(seed=0), device=DEV)
    aux = losses.render_loss(dec, args[3], args[4], args[5], args[6], lie.inverse_sim3(args[0]), args[7])[3]
    k_none = n_valid = int(aux["n_valid_query"].max())
    fraction_none = (k_none + 0.5) / (R * S)        # int(R * S * fraction) is k_none
    check(int(R * S * fraction_none) == k_none < R * S, f"14d: fraction {fraction_none} does not give {k_none}")
    base1 = gn.GNConfig(code_len=64, num_iterations=1)
    uncapped = gn.batched_reconstruct(dec, base1)(*args)
    counter = RowCounter(dec)
    capped = gn.batched_reconstruct(counter, dataclasses.replace(base1, render_eval_fraction=fraction_none))(*args)
    equal = all(torch.equal(capped[k], uncapped[k]) for k in uncapped)
    diff = gn_distance(capped, uncapped)
    print(f"[14d] render_eval_fraction {fraction_none:.6f} (cap {k_none} of {R * S} samples, the most valid samples "
          f"of an object): decoded rows {counter.rows}; one GN iteration equals the uncapped one: {equal} "
          f"(max |d| {diff:.3e})")
    check(counter.rows == [B * k_none] and equal, f"14d: capped GN rows {counter.rows}, equal {equal} ({diff})")

    cfg = gn.GNConfig(code_len=64, num_iterations=10, render_eval_fraction=0.5)
    counter = RowCounter(dec)
    out, launches, seen = counted_gn(counter, cfg, args)
    finite = bool(torch.isfinite(out["t_cam_obj"]).all() and torch.isfinite(out["code"]).all())
    want = [B * int(R * S * 0.5)] * 10
    runs = {"uncapped": [], "0.5": []}
    for path in ("uncapped", "0.5", "0.5", "uncapped"):
        run = gn.batched_reconstruct(dec, cfg if path == "0.5" else dataclasses.replace(cfg, render_eval_fraction=None))
        runs[path].append(cuda_ms(lambda: run(*args), 3) / B)
    ms = {k: float(np.mean(v)) for k, v in runs.items()}
    print(f"[14d] render_eval_fraction 0.5: decoded rows per iteration {sorted(set(counter.rows))} over "
          f"{len(counter.rows)} iterations (expected {want[0]} x 10); finite {finite}, is_good {out['is_good'].tolist()}, "
          f"K1 launches {launches} (profiler {seen}); GN ms per object: 0.5 {ms['0.5']:.3f}, uncapped "
          f"{ms['uncapped']:.3f} on {name}")
    check(counter.rows == want and finite and k1_counted(launches, seen, 2 * 10),
          f"14d: rows {counter.rows}, finite {finite}, K1 launches {launches} / {seen}")
    return {"n_valid": n_valid, "fraction_none": fraction_none, "equal": equal, "ms_per_object": ms}


def phase_decoder_contract(gn5: dict, fitted, name: str) -> dict:
    """14a-14d on phase 5's float64 run and 12a's fitted decoder."""
    ab = phase_precision_ab(gn5, fitted, name)
    other = phase_other_decoders(name)
    fraction = phase_render_eval_fraction(name)
    return {"precision_ab": ab, "other_decoders": other, "render_eval_fraction": fraction}


# ---------------------------------------------------------------------------
# phase 15: the bench entry (`python -m dspslam_tpu_torch.apps.bench`)

# K1 launches of the entry's gn arm: a warm-up and GN_REPS timed calls, two
# per GN iteration
BENCH_GN_K1 = (bench.GN_REPS + 1) * 2 * bench.GN_ITERATIONS


def phase_bench(prior: dict, prior_seconds: dict, name: str) -> dict:
    """15: `apps.bench.main([])` on the card, with the records of the arms
    that phases 12b (full), 9a (mono_freiburg, paced) and 10a (long_loop) ran
    through the entry's functions reused, so no benchmark_slam argv runs
    twice; the entry runs ab, mono_redwood and gn itself, each with K1 and
    K2 counted from 0. Its line: every arm's keys present and finite, no
    `_error` key, fps > 0, 0 lost frames, the ATE of both A/B arms < 3% of
    travel, the long loop's ATE after <= 10% of before, the paced drop rate
    in [0, 1]; K1 launched 11 x 20 times in the gn arm and as the object GN
    calls need in ab, K2 once per extracted frame in ab and mono_redwood."""
    counted = {}

    def counting(arm, run):
        def wrapped(device):
            mark = launch_mark()
            rec = run(device)
            k1, k2 = launches_since(mark)
            counted[arm] = {"record": rec, "k1": k1, "k2": k2}
            return rec
        return wrapped

    arms = {arm: (counting(arm, run), keys) for arm, (run, keys) in bench.ARMS.items()}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.dict(bench.ARMS, arms), contextlib.redirect_stdout(buf):
        code = bench.main([], prior=prior)
    wall = time.perf_counter() - t0
    details_text, line_text = buf.getvalue().splitlines()[-2:]
    details, line = json.loads(details_text), json.loads(line_text)
    print(f"[15] python -m dspslam_tpu_torch.apps.bench (arms {sorted(prior)} from phases 12b, 9a and 10a) in "
          f"{wall:.1f} s, exit code {code}, on {name}:")
    print(details_text)
    print(line_text)

    records = {**prior, **{arm: c["record"] for arm, c in counted.items()}}
    errors = {k: v for k, v in line.items() if k.endswith("_error")}
    check(code == 0 and not errors and set(counted) == set(bench.ARMS) - set(prior),
          f"15: exit code {code}, errors {errors}, arms run {sorted(counted)}")
    for arm, (_, keys) in bench.ARMS.items():
        for key, value in keys(records).items():
            got = line.get(key, details.get(key))
            check(key in line or key in details, f"15: {arm}'s key {key} is missing from the line")
            if isinstance(value, (str, dict)):
                continue
            check(got is not None and bool(np.isfinite(got)), f"15: {arm}'s {key} is {got}")
    check(min(line["value"], line["mono_fps_redwood"], line["mono_fps_freiburg"]) > 0, "15: an fps is not > 0")
    check(line["lost_frames"] == line["lost_frames_points_only"] == line["mono_redwood_lost_after_init"]
          == line["mono_freiburg_lost_after_init"] == 0, "15: lost frames")
    for ate, travel in (("ate_joint_cm", "travel_m"), ("ate_points_only_cm", "travel_m_points_only")):
        check(line[ate] / 100 < 0.03 * line[travel], f"15: {ate} {line[ate]} cm >= 3% of {line[travel]} m")
    check(line["ate_after_loop_cm"] <= 0.1 * line["ate_before_loop_cm"] and line["loops_closed"] == 1,
          f"15: long loop {line['ate_before_loop_cm']} -> {line['ate_after_loop_cm']} cm")
    check(0.0 <= line["mono_freiburg_paced_drop_rate"] <= 1.0, f"15: drop rate {line['mono_freiburg_paced_drop_rate']}")

    ab, redwood, gn_arm = counted["ab"], counted["mono_redwood"], counted["gn"]
    check(gn_arm["k1"] == BENCH_GN_K1 and gn_arm["k2"] == 0,
          f"15 gn: K1 launched {gn_arm['k1']} times (expected {BENCH_GN_K1}), K2 {gn_arm['k2']}")
    rec = ab["record"]
    check(ab["k1"] == rec["expected_k1_launches"] > 0 and ab["k2"] == rec["frames"] + rec["n_redone"],
          f"15 ab: K1 {ab['k1']} (expected {rec['expected_k1_launches']}), K2 {ab['k2']} (expected "
          f"{rec['frames']} + {rec['n_redone']})")
    rec = redwood["record"]
    check(redwood["k1"] == 0 and redwood["k2"] == rec["frames_tracked"] + rec["n_redone"],
          f"15 mono_redwood: K1 {redwood['k1']}, K2 {redwood['k2']} (expected {rec['frames_tracked']} + "
          f"{rec['n_redone']})")
    launches = {arm: {"k1": c["k1"], "k2": c["k2"]} for arm, c in counted.items()}
    entry_s = sum(details["arm_seconds"].values()) + sum(prior_seconds.values())
    print(f"[15] launches by arm {launches}; A/B ATE joint {line['ate_joint_cm']:.4f} cm vs points-only "
          f"{line['ate_points_only_cm']:.4f} cm, object error {line['obj_err_joint_cm']} vs "
          f"{line['obj_err_points_only_cm']} cm; Redwood {line['mono_fps_redwood']:.4f} fps mean "
          f"({line['mono_fps_redwood_median']:.4f} median); gn {line['gn_recon_ms_per_object']:.3f} ms per object "
          f"by wall clock (phase 5's CUDA events beside it); the whole entry's arms {entry_s:.1f} s "
          f"({details['arm_seconds']} here, {prior_seconds} in their phases) on {name}")
    return {"line": line, "arm_seconds": {**prior_seconds, **details["arm_seconds"]}, "launches": launches,
            "entry_seconds": entry_s, "wall_s": wall}


def main():
    # cuBLAS is deterministic (phase 12c) only with a fixed workspace
    # configuration, read when the process makes its first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    t_mark = [t_start]

    def seconds(label: str):
        # wall seconds of the phases since the previous mark: what to cut
        # when the smoke nears its time limit
        now = time.perf_counter()
        print(f"[{label}] {now - t_mark[0]:.1f} s (smoke at {now - t_start:.1f} s)")
        t_mark[0] = now

    name = card()
    print(name)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(lambda mod: mod.build(), (decoder_fused, fast_score, greedy_nms)))
    print(f"[2] K1, K2 and greedy NMS builds (three nvcc, in parallel, sm_90a): {time.perf_counter() - t0:.2f} s "
          f"-> {', '.join(os.path.relpath(so) for so in libs)}")

    dec = deepsdf.params_from_jax(canonical_params_np(seed=1), device=DEV)
    k1 = phase_kernel(dec, libs[0], name)
    seconds("2-3")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(tmp)
        seconds("4")
        gn5 = phase_gn(name)
        ms = gn5["ms"]
        seconds("5")

        system_cfg = SystemConfig.from_json(KITTI_CONFIG)
        params = tracking.tracker_from_system_config(system_cfg, device="cpu").orb_params
        t0 = time.perf_counter()
        world, poses, baseline = kitti_turn_sequence(system_cfg.camera)
        images = render_stereo_u8(world, poses, baseline)
        print(f"[7] rendered {len(images)} stereo pairs at {images[0][0].shape} in "
              f"{time.perf_counter() - t0:.1f} s (before any timing)")
        k2 = phase_fast(images[0], params, libs[1], name)
        seconds("6")
        trk = phase_tracking(system_cfg, images, poses, name)
        phase_sync_free(trk["pipelined"]["tracker"], images)
        phase_profile(system_cfg, images, trk["pipelined"]["wall_ms"])
        seconds("7")

        phase_slam_accuracy(name)
        seconds("8a")
        slam = phase_slam_k1(system_cfg, os.path.join(tmp, "deepsdf"), images, poses, name)
        phase_mapping_sync_free(slam["system"])
        phase_cli(tmp, name)
        seconds("8b-8c")

        k2_mono = phase_mono_fast(name)
        mono = phase_mono_tracking(name)
        mono_prof = phase_mono_profile(name)
        seconds("9a")
        mono_obj = phase_mono_objects(name)
        phase_mono_cli(tmp, name)
        rgbd_launches = phase_rgbd(name)
        seconds("9b-9d")

        t10 = time.perf_counter()
        loop = phase_long_loop(name)
        reloc = phase_relocalization(system_cfg, images, poses, params, name)
        drain_8b = [x * 1e3 for x in slam["timer"].samples["keyframe_drain"]]
        loop_slam = phase_loop_slam(system_cfg, os.path.join(tmp, "deepsdf"), images, poses, reloc["voc"],
                                    drain_8b, name)
        cg = phase_pose_graph_cg(name)
        ckpt = phase_checkpoint(tmp, name)
        print(f"[10] slice 5 phases: {time.perf_counter() - t10:.1f} s")

        t11 = time.perf_counter()
        mrcnn = phase_maskrcnn(images[0][0], name)
        pillars = phase_pointpillars(name)
        rgb, scan = mrcnn.pop("rgb"), pillars.pop("scan")
        timing = phase_detector_timing(rgb, scan, name)
        online = phase_detect_online(tmp, name)
        nms = phase_nms(rgb, scan, name)
        t11 = time.perf_counter() - t11
        print(f"[11] slice 6 phases: {t11:.1f} s")
        seconds("10-11")

        t12 = time.perf_counter()
        fit = phase_decoder_fit(tmp, name)
        full = phase_full_arm(name)
        loops = phase_closed_loops(name)
        vocab = phase_vocabulary(tmp, images, name)
        overlays = phase_overlays(tmp, name)
        t12 = time.perf_counter() - t12
        print(f"[12] slice 7 phases: {t12:.1f} s")
        seconds("12")

        t13 = time.perf_counter()
        fitted = fit.pop("decoder")
        slice8 = phase_mesh(tmp, fitted, name)
        slice8["seconds"] = time.perf_counter() - t13
        print(f"[13] slice 8 phases: {slice8['seconds']:.1f} s")
        seconds("13")

        t14 = time.perf_counter()
        slice9 = phase_decoder_contract(gn5, fitted, name)
        slice9["seconds"] = time.perf_counter() - t14
        print(f"[14] slice 9 phases: {slice9['seconds']:.1f} s")
        seconds("14")

        prior = {"full": full.pop("bench_record"), "mono_freiburg": mono["pipelined"], "paced": mono["paced"],
                 "long_loop": loop["record"]}
        prior_s = {"full": full["wall_s"], "mono_freiburg": mono["seconds"]["pipelined"],
                   "paced": mono["seconds"]["paced"], "long_loop": loop["seconds"]}
        slice10 = phase_bench(prior, prior_s, name)
        seconds("15")

    slice5 = {
        "long_loop": {k: loop["record"][k] for k in ("ate_before_loop_cm", "ate_after_loop_cm",
                                                      "loops_closed", "loop_kfs", "loop_wall_s")},
        "pose_graph_ms": loop["pose_graph_ms"], "pose_graph_busy_ms": loop["pose_graph_busy_ms"],
        "gba_ms": loop["gba_ms"],
        "reloc_back_at": reloc["back"], "reloc_ate_m": reloc["ate"],
        "insert_keyframe_ms": loop_slam["insert_ms"], "loop_slam_drain_ms": loop_slam["drain_ms"],
        "cg_ms": cg["ms"], "cg_wall_ms": cg["wall_ms"], "cg_iters": cg["cg_iters"],
    }
    print(json.dumps({"slice5": slice5}))
    print(json.dumps({"slice6": {"maskrcnn": mrcnn, "pointpillars": pillars, **timing,
                                 "online": online, "nms": nms, "seconds": t11}}))
    print(json.dumps({"slice7": {"decoder_fit": fit, "full_arm": {k: full[k] for k in ("record", "stage_ms",
                                                                                      "profile", "wall_s")},
                                 "closed_loops": loops, "vocabulary": vocab, "overlays": overlays,
                                 "seconds": t12}}))
    print(json.dumps({"slice8": slice8}))
    print(json.dumps({"slice9": slice9}))
    print(json.dumps({"slice10": {"card": name, **slice10}}))
    print(name)
    kernels = [{
        "name": "decoder_fused", "route": "cuda", "source": SRC, "replaces": REPLACES,
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["times"][8192]["kernel"], "plain_ms": k1["times"][8192]["plain"],
        "bound_ms": k1["times"][8192]["bound"], "bound_by": k1["times"][8192]["bound_by"],
        "library_ms": None,
        "device_ms": k1["times"][8192]["device"], "cluster": k1["times"][8192]["width"],
        "ms_2048": k1["times"][2048]["kernel"], "device_ms_2048": k1["times"][2048]["device"],
        "plain_ms_2048": k1["times"][2048]["plain"], "bound_ms_2048": k1["times"][2048]["bound"],
        "cluster_2048": k1["times"][2048]["width"],
        "ms_by_cluster": {n: {cw: k1["times"][n][cw] for cw in decoder_fused.WIDTHS}
                          for n in (2048, 8192)},
        "tf32_hgmma_instructions": sum(c["tf32"] for c in k1["tensor"].values()),
        "gn_ms_per_object": ms["kernel"], "gn_plain_ms_per_object": ms["plain"],
        "slam_launches": slam["k1_launches"], "slam_keyframe_drain_share": slam["k1_share"],
        "mono_launches": mono_obj["k1_launches"], "mono_keyframe_drain_share": mono_obj["k1_share"],
        "mono_gn_ms": mono_obj["gn_ms"],
        "loop_slam_launches": loop_slam["k1_launches"],
        "detector_slam_launches": online["k1_launches"],
        "full_arm_launches": full["k1_launches"], "full_arm_profile_k1_ms": full["profile"]["k1_ms"],
        "sharded_gn_launches": {"13b": slice8["gn"]["k1_launches"], "13d": slice8["two_ranks"]["k1_launches"]},
        "decoder_contract_launches": {"canonical_f32": slice9["precision_ab"]["k1_launches"],
                                      "wide_4x256": slice9["other_decoders"]["wide_k1_launches"],
                                      "bf16": slice9["other_decoders"]["bf16_k1_launches"]},
        "gn_ms_per_object_by_precision": slice9["precision_ab"]["gn_ms_per_object"],
        "generic_path_ms": slice9["precision_ab"]["generic_ms"],
        "bench_launches": {"full": full["k1_launches"], "ab": slice10["launches"]["ab"]["k1"],
                           "gn": slice10["launches"]["gn"]["k1"]},
    }, {
        "name": "fast_score", "route": "cuda", "source": K2_SRC, "replaces": K2_REPLACES,
        "launches": trk["launches"], "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"]["kernel"], "plain_ms": k2["ms"]["plain"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
        "device_ms": k2["device_ms"], "frame_ms": k2["frame_ms"]["kernel"],
        "frame_device_ms": k2["device_frame_ms"], "frame_host_ms": k2["host_frame_ms"],
        "frame_plain_ms": k2["frame_ms"]["plain"],
        "frame_bound_ms": k2["frame_bound_ms"],
        "instructions_per_pixel": k2["instructions_per_pixel"],
        "tracking_ms_per_frame": {f: trk[f]["median_ms"] for f in ("non-pipelined", "pipelined")},
        "slam_launches": slam["k2_launches"],
        "mono_launches": mono["launches"], "rgbd_launches": rgbd_launches,
        "mono_frame_ms": k2_mono["ms"], "mono_frame_device_ms": k2_mono["device_ms"],
        "mono_frame_plain_ms": k2_mono["plain_ms"], "mono_frame_bound_ms": k2_mono["bound_ms"],
        "mono_max_abs_err": k2_mono["max_abs_err"],
        "mono_fps": {f: {"mean": mono[f]["value"], "median": mono[f]["median_fps"]}
                     for f in ("pipelined", "non-pipelined")},
        "mono_busy_ms_per_frame": mono_prof["busy_ms_per_frame"],
        "loop_launches": {"relocalization": reloc["k2_launches"], "loop_slam": loop_slam["k2_launches"],
                          "checkpoint": ckpt["k2_launches"]},
        "detector_slam_launches": online["k2_launches"],
        "full_arm_launches": full["k2_launches"], "vocabulary_launches": vocab["k2_launches"],
        "bench_launches": {"full": full["k2_launches"], "ab": slice10["launches"]["ab"]["k2"],
                           "mono_redwood": slice10["launches"]["mono_redwood"]["k2"],
                           "mono_freiburg": mono["k2"]["pipelined"], "paced": mono["k2"]["paced"]},
    }, {
        "name": "greedy_nms", "route": "cuda", "source": NMS_SRC, "replaces": NMS_REPLACES,
        "launches": online["nms_launches"], "cell_launches": nms["launches"], "max_abs_err": nms["max_abs_err"],
        "ms": nms["calls"]["rpn"]["ms"], "plain_ms": nms["calls"]["rpn"]["plain_ms"],
        "bound_ms": nms["calls"]["rpn"]["bound_ms"], "bound_by": nms["calls"]["rpn"]["bound_by"],
        "library_ms": None, "device_ms": nms["calls"]["rpn"]["device_ms"], "by_call": nms["calls"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
