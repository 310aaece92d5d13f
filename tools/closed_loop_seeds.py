"""Run a detector's closed loop (tests/test_detector_closed_loop.py) over
several seeds and print, per seed, what its assertions see (the trainers'
`closed_loop_report`).

The Mask R-CNN loop overfits one planted scene (600 steps) and the
PointPillars loop one planted scan (320 steps in the JAX package, 640 in
the port, whose SECONDFPN deblocks are transposed convolutions); the
report says whether
every planted instance was found, whether a detection was spurious and, for
PointPillars, the size errors. Either package's trainer can run (`--package
jax` needs the JAX package and runs on the CPU; the port runs on `--device`,
the card unless `--device cpu` is asked for), and what the port changed in
the trainers can be set back (`--refresh 100`, the JAX trainer's Mask R-CNN
mining interval, ROADMAP R8; `--no_regress_ignored`, PointPillars targets
as the JAX trainer builds them, R9). `--deterministic` trains the port with
deterministic algorithms, as chip_smoke.py phase 12c does, and `--repeat`
runs each seed that many times.

    python tools/closed_loop_seeds.py maskrcnn --seeds 0 1 2 3 [--refresh 100] [--device cpu]
    python tools/closed_loop_seeds.py maskrcnn --seeds 0 --deterministic --repeat 2
    python tools/closed_loop_seeds.py pointpillars --seeds 0 1 2 3 [--no_regress_ignored] [--package jax]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dspslam_tpu_torch.detect import layers, maskrcnn_train as tmt, pointpillars_train as tppt  # noqa: E402
from dspslam_tpu_torch.slam.map import entry_device  # noqa: E402


def maskrcnn_seed(args, seed: int) -> str:
    kw = {} if args.refresh is None else {"refresh": args.refresh}
    if args.package == "jax":
        from dspslam_tpu.detect import maskrcnn as mr
        from dspslam_tpu.detect import maskrcnn_train as mt

        params, img, gt, masks = mt.overfit_scene(mt.small_config(), steps=600, seed=seed, **kw)
        out = mr.Detector2D(params=params, cfg=mt.small_config()).make_prediction(img)
    else:
        from dspslam_tpu_torch.detect import maskrcnn as mr

        params, img, gt, masks = tmt.overfit_scene(tmt.small_config(), steps=600, seed=seed, device=args.device,
                                                   **kw)
        out = mr.Detector2D(params=params, cfg=tmt.small_config(), device=args.device).make_prediction(img)
    rep = tmt.closed_loop_report(np.asarray(out["pred_boxes"]), np.asarray(out["pred_masks"]), gt, masks)
    return (f"{rep['detections']} detections; best box IoU per instance {[round(x, 4) for x in rep['box_iou']]}, "
            f"mask IoU {[round(x, 4) for x in rep['mask_iou']]}; each detection's best IoU "
            f"{[round(x, 4) for x in rep['overlap']]}; found {rep['found']}, no spurious {rep['clean']}")


def pointpillars_seed(args, seed: int) -> str:
    cfg = tppt.small_config()
    if args.package == "jax":
        from dspslam_tpu.detect import pointpillars_train as pt
        from dspslam_tpu.detect.pointpillars import Detector3D

        if args.no_regress_ignored:
            raise SystemExit("--no_regress_ignored sets back the port's trainer; the JAX trainer has no band")
        params, scan, gt = pt.overfit_scene(pt.small_config(), steps=320, seed=seed)
        boxes = Detector3D(params=params, cfg=pt.small_config()).make_prediction(scan)
    else:
        from dspslam_tpu_torch.detect.pointpillars import Detector3D

        params, scan, gt = tppt.overfit_scene(cfg, steps=640, seed=seed, device=args.device,
                                              regress_band=not args.no_regress_ignored)
        boxes = Detector3D(params=params, cfg=cfg, device=args.device).make_prediction(scan)
    rep = tppt.closed_loop_report(np.asarray(boxes), gt, cfg)
    return (f"{rep['detections']} detections; planted boxes' nearest detection "
            f"{[round(d, 3) for d in rep['dists']]} m; each detection's nearest planted box "
            f"{[round(d, 2) for d in rep['far']]} m; size errors w {rep['w_err']:.3f} l {rep['l_err']:.3f}; "
            f"found {rep['found']}, no spurious {rep['clean']}, sizes {rep['sizes']}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("detector", choices=("maskrcnn", "pointpillars"))
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--repeat", type=int, default=1, help="runs of each seed")
    p.add_argument("--package", choices=("torch", "jax"), default="torch")
    p.add_argument("--device", default="cuda", help="the port's device (cuda raises without a card)")
    p.add_argument("--deterministic", action="store_true", help="the port with deterministic algorithms")
    p.add_argument("--refresh", type=int, default=None, help="Mask R-CNN's mining interval (the trainer's default)")
    p.add_argument("--no_regress_ignored", action="store_true",
                   help="the port's PointPillars trainer without regress_ignored (the JAX trainer's targets)")
    args = p.parse_args(argv)
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        # cuBLAS reads its workspace configuration (needed for determinism)
        # at its first handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        args.device = entry_device(args.device, "closed_loop_seeds")
    run = maskrcnn_seed if args.detector == "maskrcnn" else pointpillars_seed
    for seed in args.seeds:
        for k in range(args.repeat):
            t0 = time.perf_counter()
            with layers.deterministic() if args.deterministic else contextlib.nullcontext():
                line = run(args, seed)
            print(f"{args.package} {args.detector} seed {seed} run {k} (refresh {args.refresh}, no_regress_ignored "
                  f"{args.no_regress_ignored}, deterministic {args.deterministic}): "
                  f"{line}; {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
