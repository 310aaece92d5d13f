"""Detector inference latency on the card.

Port of dspslam_tpu/apps/benchmark_detectors.py. The reference prints
per-frame detector timings inline (kitti_sequence.py:101-109 for Mask
R-CNN, :162-167 for the 3D detector); this measures the same for the
port's detectors: PointPillars on a synthetic 120k-point LiDAR scan (host
crop + quantize, on-device pillar assignment, network, boxes fetched) and
Mask R-CNN ResNet50-FPN at KITTI resolution (scores fetched). Each call is
timed between synchronised points (its results on the host). Random
weights: latency depends on the architecture, not the weights.

Usage:  python -m dspslam_tpu_torch.apps.benchmark_detectors [--iters 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..slam.map import entry_device, to_torch


def synthetic_scan(n: int = 120_000, seed: int = 0) -> np.ndarray:
    """KITTI-like Velodyne scan: ground disk + scattered structures."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(2.5, 69.0, n)
    th = rng.uniform(-np.pi, np.pi, n)
    x = r * np.cos(th)
    y = r * np.sin(th)
    z = np.where(
        rng.uniform(size=n) < 0.7,
        rng.normal(-1.7, 0.05, n),                   # ground
        rng.uniform(-1.5, 1.5, n),                   # structure
    )
    i = rng.uniform(0, 1, n)
    return np.stack([x, y, z, i], -1).astype(np.float32)


def bench_pointpillars(iters: int, device, cfg=None, scan=None):
    """The production path (Detector3D defaults): host crop + quantize,
    points-only upload, on-device pillar assignment and network, synced by
    the boxes fetch. Returns (median ms per scan, median host crop ms)."""
    from ..detect import pointpillars as pp

    det = pp.Detector3D(cfg=cfg or pp.PointPillarsConfig(), device=device)
    scan = synthetic_scan() if scan is None else scan
    det.make_prediction(scan)                         # warm-up
    t_total, t_host = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        det.collect(det.dispatch(scan))               # crop + upload + net + fetch
        t_total.append(time.perf_counter() - t0)
        t1 = time.perf_counter()
        pp.crop_quantize_points(scan, det.cfg)        # host share, measured alone
        t_host.append(time.perf_counter() - t1)
    return float(np.median(t_total)) * 1e3, float(np.median(t_host)) * 1e3


def bench_maskrcnn(iters: int, device, cfg=None, hw=(376, 1248)):
    """detect() on a seeded random RGB frame already on the device, synced
    by the scores fetch. Returns the median ms per frame."""
    from ..detect import maskrcnn as mr

    cfg = cfg or mr.MaskRCNNConfig()
    params = mr.init_params(cfg, device=device)
    img = to_torch(np.random.default_rng(1).uniform(0, 255, (*hw, 3)).astype(np.float32), device)
    mr.detect(params, img, hw, cfg)["scores"].cpu()   # warm-up + sync
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        mr.detect(params, img, hw, cfg)["scores"].cpu()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = entry_device(args.device, "benchmark_detectors")

    pp_ms, pp_host_ms = bench_pointpillars(args.iters, device)
    mr_ms = bench_maskrcnn(args.iters, device)
    rec = {
        "pointpillars_ms_per_scan": pp_ms,
        "pointpillars_host_crop_ms": pp_host_ms,
        "maskrcnn_ms_per_frame": mr_ms,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
