"""The long loop's ATE spread over repeated runs, by the global BA's dtype.

Runs `benchmark_slam --long_loop`'s street loop (201 keyframes, one loop)
through the port's LoopCloser `--runs` times for each dtype, alternating
float32 and float64 (`place.loop_closing.GBA_DTYPE`), and prints one JSON
line per run: the ATE RMSE before the loop, after the loop correction and
essential graph (before the global BA lands), and after the global BA;
then a summary line per dtype (min / median / max after the global BA).

    python tools/long_loop_spread.py [--runs 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dspslam_tpu_torch.datasets.street_loop import StreetLoopWorld  # noqa: E402
from dspslam_tpu_torch.place import loop_closing  # noqa: E402
from dspslam_tpu_torch.place.vocabulary import Vocabulary  # noqa: E402
from dspslam_tpu_torch.slam.map import entry_device  # noqa: E402


def one_run(device, dtype) -> dict:
    loop_closing.GBA_DTYPE = dtype
    world = StreetLoopWorld(street_len=100)
    slam_map, kfs, truth = world.build()
    voc = Vocabulary.train(world.lmk_desc, branching=6, levels=2, seed=1, device=device)
    closer = loop_closing.LoopCloser(slam_map, voc, [world.fx, world.fy, world.cx, world.cy, world.fx * 0.4],
                                     fix_scale=True, min_matches=12, device=device)

    def ate_cm():
        return float(np.sqrt(np.mean(world.pose_errors(slam_map, kfs, truth) ** 2))) * 100

    rec = {"gba_dtype": str(dtype).replace("torch.", "")}
    apply = closer._apply_global_ba

    def measured_apply(pending):
        rec["ate_before_gba_cm"] = ate_cm()
        apply(pending)

    closer._apply_global_ba = measured_apply
    snap = kfs[-(world.revisit_len + 1)].id
    t0 = time.perf_counter()
    for kf in kfs:
        closer.insert_keyframe(kf)
        if kf.id == snap:
            rec["ate_before_loop_cm"] = ate_cm()
    closer.flush()
    rec.update(ate_after_cm=ate_cm(), loops_closed=closer.loops_closed, wall_s=time.perf_counter() - t0)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = entry_device(args.device, "long_loop_spread")
    after = {torch.float32: [], torch.float64: []}
    for _ in range(args.runs):
        for dtype in after:
            rec = one_run(device, dtype)
            after[dtype].append(rec["ate_after_cm"])
            print(json.dumps(rec), flush=True)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for dtype, v in after.items():
        print(json.dumps({"gba_dtype": str(dtype).replace("torch.", ""), "runs": len(v), "min_cm": min(v),
                          "median_cm": float(np.median(v)), "max_cm": max(v), "device": name}))
    loop_closing.GBA_DTYPE = torch.float64


if __name__ == "__main__":
    main()
