"""Smoke test of the PyTorch port on one CUDA card: builds kernels K1 and K2
from the repository's sources, checks each against its plain PyTorch
version, drives single-frame object reconstruction, stereo tracking,
object SLAM in stereo, mono and RGB-D, and place recognition with loop
closing through their entry points, and times them.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. K1's and K2's builds (one nvcc each, started together, sm_90a);
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
     run with FAST bound to K2's plain version, one chained frame program
     free of host syncs (`torch.cuda.set_sync_debug_mode("error")`), the
     steady-state ms per frame and a `torch.profiler` table of the
     pipelined steady state;
  8. stereo object SLAM (slice 3) through its entry points:
     a. `apps.benchmark_slam.main` (light workload: GT-derived sphere
        detections, the sphere decoder, pipelined tracking, async joint BA)
        at KITTI intrinsics, 376x1241, 2000 features, 8 levels, 40 frames
        through a 30-degree turn: 0 lost frames, ATE < 3% of travel, every
        static object within 0.35 m of a true sphere centre, an applied
        local BA solve with a camera-object edge inlier; then the
        points-only BA arm (`--ba_no_objects`) as the A/B;
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
     a. `apps.benchmark_slam.main(["--mono", "--mono_profile", "freiburg"])`
        over 40 frames of a strafe with a 20-degree view yaw, pipelined then
        not: two-view initialization within the first 10 frames, 0 frames
        lost after it, Sim(3)-aligned ATE < 3% of travel, K2 once per
        extracted frame (re-tracked frames included); mean and median fps,
        p99 frame ms, stage times; one `--paced` run's drop rate at 25 fps;
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
     d. `SLAMSystem.track_rgbd`, fused and pipelined, over 24 frames of 9a's
        sequence with its rendered depth images: 0 lost frames, ATE < 3% of
        travel, one K2 launch per frame.
 10. place recognition, relocalization and loop closing (slice 5) through
     their entry points:
     a. `apps.benchmark_slam.main(["--long_loop"])`: 201 keyframes of the
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
The last lines are a JSON summary of slice 5's numbers, the card, a JSON
summary of the kernels (K1's and K2's `slam_launches` count phase 8b,
their `mono_launches` phases 9b and 9a, `loop_slam_launches` /
`loop_launches` phase 10) and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
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
from scipy.spatial import cKDTree

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")

from dspslam_tpu_torch.apps import (  # noqa: E402
    benchmark_slam, dsp_slam, dsp_slam_mono, extract_map_objects, reconstruct_frame,
)
from dspslam_tpu_torch.backend import ba, pose_graph  # noqa: E402
from dspslam_tpu_torch.config import SystemConfig  # noqa: E402
from dspslam_tpu_torch.datasets.kitti import KITTISequence  # noqa: E402
from dspslam_tpu_torch.datasets.mono import build_mono_detection  # noqa: E402
from dspslam_tpu_torch.datasets.synthetic import (  # noqa: E402
    blob_images, kitti_turn_sequence, render_stereo_u8,
)
from dspslam_tpu_torch.detect import offline  # noqa: E402
from dspslam_tpu_torch.frontend import matcher, orb, undistort  # noqa: E402
from dspslam_tpu_torch.kernels import _nvcc, decoder_fused, fast_score  # noqa: E402
from dspslam_tpu_torch.models import deepsdf  # noqa: E402
from dspslam_tpu_torch.objects.mono_pipeline import MonoObjectPipeline  # noqa: E402
from dspslam_tpu_torch.place import loop_closing  # noqa: E402
from dspslam_tpu_torch.place.vocabulary import Vocabulary  # noqa: E402
from dspslam_tpu_torch.shape import gn  # noqa: E402
from dspslam_tpu_torch.slam import frame_step, keyframe_step, state_io, tracking  # noqa: E402
from dspslam_tpu_torch.slam import map as slam_map_mod  # noqa: E402
from dspslam_tpu_torch.slam.system import SLAMSystem  # noqa: E402
from dspslam_tpu_torch.utils.evaluation import ate_rmse  # noqa: E402
from dspslam_tpu_torch.utils.timing import StageTimer  # noqa: E402
from dspslam_tpu_torch.utils.io import read_mesh_ply  # noqa: E402

DEV = torch.device("cuda")
SRC = "dspslam_tpu_torch/csrc/decoder_fused.cu"
REPLACES = "dspslam_tpu/ops/pallas/decoder_kernel.py:106"
K2_SRC = "dspslam_tpu_torch/csrc/fast_score.cu"
K2_REPLACES = "dspslam_tpu/ops/pallas/fast_kernel.py:41"
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


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown"


def canonical_params_np(seed: int) -> dict:
    """He-normal (in, out) weights and zero biases, as the JAX pytree."""
    rng = np.random.default_rng(seed)
    dims = deepsdf.DecoderConfig().layer_dims()
    return {
        "w": [(rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(np.float32) for i, o in dims],
        "b": [np.zeros((o,), np.float32) for _, o in dims],
    }


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
    torch.profiler over `reps` calls of `fn`."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    check(bool(events), f"the profiler saw no {kernel} launch")
    return device_ms(events)[1] / reps


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
    decoder_fused.sdf_and_input_grad.launches = 0
    summary = reconstruct_frame.main(["--synthetic", "--config", cfg_path, "--output_dir", out_dir])
    launches = decoder_fused.sdf_and_input_grad.launches
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
    """bench.py::bench_gn's inputs (B=8, P=256, R=512), seeded with numpy."""
    B, P, R = 8, 256, 512
    rng = np.random.default_rng(0)
    t = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    t[:, :3, :3] *= 2.0
    t[:, 2, 3] = 8.0
    dirs = rng.normal(size=(B, P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = (dirs * 1.0 + np.array([0, 0, 8.0])).astype(np.float32)
    rays = rng.normal(0, 0.05, (B, R, 3)).astype(np.float32) + np.array([0, 0, 1.0], np.float32)
    args = [t, pts, np.ones((B, P), np.float32), rays, np.ones((B, R), np.float32),
            np.full((B, R), 8.0, np.float32), np.ones((B, R), np.float32),
            np.zeros((B, 64), np.float32)]
    return B, [torch.from_numpy(a).to(DEV) for a in args]


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
    for iters in (1, 10):
        cfg = gn.GNConfig(code_len=64, num_iterations=iters)
        out = {p: gn.batched_reconstruct(decs[p], cfg)(*args) for p in decs}
        ref = gn.batched_reconstruct(f64_dec, cfg)(*[a.double() for a in args])
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
    return ms


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
    before = fast_score.fast_score_maps.launches
    outs = fast_score.fast_score_maps(levels, t_lo, t_hi, orb.BOOST)
    torch.cuda.synchronize()
    check(fast_score.fast_score_maps.launches == before + 1, "K2 took more than one launch for a frame")
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


def phase_tracking(system_cfg, images, poses, name: str) -> dict:
    n = len(images)
    travel = float(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1).sum())
    out = {"launches": 0}
    for pipelined in (False, True):
        form = "pipelined" if pipelined else "non-pipelined"
        # the main path: counts from 0 just before, read just after
        fast_score.fast_score_maps.launches = 0
        decoder_fused.sdf_and_input_grad.launches = 0
        tr, walls, steady = run_tracker(system_cfg, images, pipelined)
        launches = fast_score.fast_score_maps.launches
        check(decoder_fused.sdf_and_input_grad.launches == 0, "K1 ran on the tracking path")
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
        # the same drive with FAST bound to K2's plain version
        with mock.patch.object(fast_score, "fast_score_maps", fast_score.fast_score_maps_plain):
            ref, _, _ = run_tracker(system_cfg, images, pipelined)
        dT = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(tr.trajectory, ref.trajectory))
        check(len(ref.trajectory) == n and dT <= 1e-4, f"{form}: K2 and plain paths differ by {dT}")
        med = float(np.median(walls[5:])) * 1e3
        print(f"[7] {form}: K2 vs plain-FAST run, max |d T_cw| over {n} frames {dT:.3e}; "
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


def phase_slam_accuracy(name: str) -> dict:
    """8a: the port's benchmark_slam (stereo arm, light workload) at KITTI
    intrinsics, 376x1241, 2000 features, 8 levels, 40 frames through the
    30-degree turn: joint BA, pipelined tracking, async BA; then the
    points-only BA arm (--ba_no_objects) as the A/B."""
    fast_score.fast_score_maps.launches = 0
    decoder_fused.sdf_and_input_grad.launches = 0
    rec = benchmark_slam.main(["--frames", "40"])
    k2, k1 = fast_score.fast_score_maps.launches, decoder_fused.sdf_and_input_grad.launches
    limit = 0.03 * rec["travel_m"]
    print(f"[8a] benchmark_slam, 40 frames (joint BA): {rec['lost_frames']} lost, ATE "
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
    ab = benchmark_slam.main(["--frames", "40", "--ba_no_objects"])
    print(f"[8a] A/B: ATE joint BA {rec['ate_rmse_cm']:.4f} cm vs points-only {ab['ate_rmse_cm']:.4f} cm; "
          f"static object error {rec['obj_center_err_cm']} vs {ab['obj_center_err_cm']} cm; "
          f"{ab['lost_frames']} lost points-only")
    return {"joint": rec, "points_only": ab}


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
    system.attach_telemetry(timer)
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
    fast_score.fast_score_maps.launches = 0
    decoder_fused.sdf_and_input_grad.launches = 0
    kf_frames = []
    for k, (left, right) in enumerate(images):
        n_kf = len(system.map.keyframes)
        system.track_stereo(left, right, 0.1 * k)
        if len(system.map.keyframes) != n_kf:
            kf_frames.append(k)
    system.flush()
    torch.cuda.synchronize()
    k1, k2 = decoder_fused.sdf_and_input_grad.launches, fast_score.fast_score_maps.launches
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
    return {"k1_launches": k1, "k2_launches": k2, "system": system, "k1_share": k1_ms / max(busy, 1e-9)}


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


MONO_FRAMES = 40
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
    before = fast_score.fast_score_maps.launches
    outs = fast_score.fast_score_maps(levels, t_lo, t_hi, orb.BOOST)
    torch.cuda.synchronize()
    check(fast_score.fast_score_maps.launches == before + 1, "K2 took more than one launch for a mono frame")
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
    930.2, 4000 features, 8 levels), pipelined then not: two-view
    initialization within the first 10 frames, 0 frames lost after it,
    Sim(3)-aligned ATE < 3% of travel, K2 once per extracted frame; then one
    --paced run's drop rate at 25 fps."""
    out = {"launches": 0}
    base = ["--mono", "--mono_profile", "freiburg", "--frames", str(MONO_FRAMES)]
    for pipelined in (True, False):
        form = "pipelined" if pipelined else "non-pipelined"
        # the main path: counts from 0 just before, read just after
        fast_score.fast_score_maps.launches = 0
        decoder_fused.sdf_and_input_grad.launches = 0
        rec = benchmark_slam.main(base + ([] if pipelined else ["--no_pipeline"]))
        k2, k1 = fast_score.fast_score_maps.launches, decoder_fused.sdf_and_input_grad.launches
        out["launches"] += k2
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
        check(k2 == rec["frames_tracked"] + rec["n_redone"],
              f"9a {form}: K2 launched {k2} times, expected {rec['frames_tracked']} + {rec['n_redone']}")
        check(k1 == 0, f"9a {form}: K1 ran on the mono tracking path")
        out[form] = rec
    paced = benchmark_slam.main(base + ["--paced"])
    print(f"[9a] mono pipelined, paced at 25 fps: drop rate {paced['drop_rate']:.4f} "
          f"({paced['frames_tracked']} frames tracked of {paced['frames']}), {paced['value']:.3f} fps mean on "
          f"the frames it took, {paced['lost_after_init']} lost after initialization on {name}")
    out["paced"] = paced
    return out


def phase_mono_profile(name: str) -> dict:
    """9a: 4 steady pipelined mono frames at Freiburg's camera under
    torch.profiler (device activity); the Hamming matrices at 4000 features (the
    initialization's 4000 x 4000 window match and a projection search
    against LOCAL_POINT_CAP points), timed and with their peak memory; one
    chained mono program under set_sync_debug_mode("error")."""
    world, cam, poses = benchmark_slam.mono_sequence("freiburg", 20)
    imgs = [np.clip(world.render_pose(T), 0, 255).astype(np.uint8) for T in poses[:20]]
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

    fast_score.fast_score_maps.launches = 0
    decoder_fused.sdf_and_input_grad.launches = 0
    system, _, events = sphere_run(scene, deepsdf_factory, profile_recon=True)
    k1, k2 = decoder_fused.sdf_and_input_grad.launches, fast_score.fast_score_maps.launches
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
    """9d: SLAMSystem.track_rgbd fused and pipelined over the first 24
    frames of the mono arm's 40-frame sequence (its view yaw starts at
    frame 13) with the true depth images (Freiburg's camera, bf = 0.5 fx,
    the mono arm's 25 px motion search): 0 lost frames, ATE < 3% of travel,
    one K2 launch per frame."""
    n = 24
    world, cam, poses = benchmark_slam.mono_sequence("freiburg", MONO_FRAMES)
    w, h, fx, cx, cy = cam
    frames = [(np.clip(world.render_pose(T), 0, 255).astype(np.uint8), world.depth_map_pose(T))
              for T in poses[:n]]
    travel = float(np.linalg.norm(np.diff(poses[:n, :3, 3], axis=0), axis=1).sum())
    launches = 0
    for pipelined in (False, True):
        form = "pipelined" if pipelined else "fused"
        system = SLAMSystem(
            tracker_cfg=tracking.TrackerConfig(fx=fx, fy=fx, cx=cx, cy=cy, bf=fx * 0.5, width=w, height=h,
                                               min_init_features=400, max_frames_between_kf=5,
                                               search_radius_motion=25.0, pipelined=pipelined),
            orb_params=orb.ORBParams(n_features=4000, n_levels=8), device=DEV)
        fast_score.fast_score_maps.launches = 0
        t0 = time.perf_counter()
        for k, (img, depth) in enumerate(frames):
            system.track_rgbd(img, depth, 0.1 * k)
        system.flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
        k2 = fast_score.fast_score_maps.launches
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
    """10a: benchmark_slam --long_loop (201 keyframes, one loop, a vocabulary
    trained in-process) on the card; the essential-graph and global-BA
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

    fast_score.fast_score_maps.launches = 0
    decoder_fused.sdf_and_input_grad.launches = 0
    with mock.patch.object(loop_closing.LoopCloser, "_dispatch_global_ba", capture_dispatch), \
            mock.patch.object(pose_graph, "optimize_pose_graph", around_launches(spans["pose_graph"], capture_solve)), \
            mock.patch.object(ba, "bundle_adjust", around_launches(spans["gba"], ba.bundle_adjust)):
        rec = benchmark_slam.main(["--long_loop"])
    torch.cuda.synchronize()
    k1, k2 = decoder_fused.sdf_and_input_grad.launches, fast_score.fast_score_maps.launches
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
    return {"record": rec, "pose_graph_ms": pg_ms, "gba_ms": gba_ms, "pose_graph_busy_ms": busy}


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
    fast_score.fast_score_maps.launches = 0
    t0 = time.perf_counter()
    for k, (left, right) in enumerate(images):
        if k in BLACKOUT:
            left = right = blank
        system.track_stereo(left, right, 0.1 * k)
    system.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = fast_score.fast_score_maps.launches
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
    system.attach_telemetry(timer)
    closer = system.loop_closer
    insert = closer.insert_keyframe
    insert_ms = []

    def timed_insert(kf):
        t0 = time.perf_counter()
        out = insert(kf)
        insert_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    closer.insert_keyframe = timed_insert
    fast_score.fast_score_maps.launches = 0
    decoder_fused.sdf_and_input_grad.launches = 0
    for k, (left, right) in enumerate(images):
        system.track_stereo(left, right, 0.1 * k)
    system.flush()
    torch.cuda.synchronize()
    k1, k2 = decoder_fused.sdf_and_input_grad.launches, fast_score.fast_score_maps.launches
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
    fast_score.fast_score_maps.launches = 0
    system = dsp_slam.main(["--sequence_dir", MINI_KITTI, "--config", cfg, "--map_dir", out,
                            "--vocabulary", voc_path, "--save_state", state])
    k2 = fast_score.fast_score_maps.launches
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


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda mod: mod.build(), (decoder_fused, fast_score)))
    print(f"[2] K1 and K2 builds (two nvcc, in parallel, sm_90a): {time.perf_counter() - t0:.2f} s "
          f"-> {', '.join(os.path.relpath(so) for so in libs)}")

    dec = deepsdf.params_from_jax(canonical_params_np(seed=1), device=DEV)
    k1 = phase_kernel(dec, libs[0], name)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(tmp)
        ms = phase_gn(name)

        system_cfg = SystemConfig.from_json(KITTI_CONFIG)
        params = tracking.tracker_from_system_config(system_cfg, device="cpu").orb_params
        t0 = time.perf_counter()
        world, poses, baseline = kitti_turn_sequence(system_cfg.camera)
        images = render_stereo_u8(world, poses, baseline)
        print(f"[7] rendered {len(images)} stereo pairs at {images[0][0].shape} in "
              f"{time.perf_counter() - t0:.1f} s (before any timing)")
        k2 = phase_fast(images[0], params, libs[1], name)
        trk = phase_tracking(system_cfg, images, poses, name)
        phase_sync_free(trk["pipelined"]["tracker"], images)
        phase_profile(system_cfg, images, trk["pipelined"]["wall_ms"])

        phase_slam_accuracy(name)
        slam = phase_slam_k1(system_cfg, os.path.join(tmp, "deepsdf"), images, poses, name)
        phase_mapping_sync_free(slam["system"])
        phase_cli(tmp, name)

        k2_mono = phase_mono_fast(name)
        mono = phase_mono_tracking(name)
        mono_prof = phase_mono_profile(name)
        mono_obj = phase_mono_objects(name)
        phase_mono_cli(tmp, name)
        rgbd_launches = phase_rgbd(name)

        t10 = time.perf_counter()
        loop = phase_long_loop(name)
        reloc = phase_relocalization(system_cfg, images, poses, params, name)
        drain_8b = [x * 1e3 for x in slam["system"].telemetry.samples["keyframe_drain"]]
        loop_slam = phase_loop_slam(system_cfg, os.path.join(tmp, "deepsdf"), images, poses, reloc["voc"],
                                    drain_8b, name)
        cg = phase_pose_graph_cg(name)
        ckpt = phase_checkpoint(tmp, name)
        print(f"[10] slice 5 phases: {time.perf_counter() - t10:.1f} s")

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
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
