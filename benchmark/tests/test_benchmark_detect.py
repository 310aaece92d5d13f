"""The detect cell on the CPU: its tiny run prints the contract's line and
is correct with both detectors checked; each planted detector fault fails
its own number; the detectors' operation counts match a hand count; the
new metrics' readers on a hand-made run."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark import detflops, manifest
from benchmark.tests.test_benchmark_span_metrics import fake_run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DET_NUMBERS = ("det2d_feat_gap", "det2d_head_gap", "det2d_select_miss", "det3d_pillar_miss", "det3d_net_gap",
               "det3d_select_miss")

# kitti_full's tiny overrides (tiny.py) and small detectors: the networks'
# widths cut, a 188 x 620 frame resized to 58 x 192 and padded to 64 x 192,
# a 16-beam scan
DETECTORS = {
    "detector_2d": {"num_classes": 4, "stage_blocks": [1, 1, 1, 1], "stem_channels": 16, "fpn_channels": 32,
                    "fc_dim": 64, "rpn_pre_nms": 64, "rpn_post_nms": 64, "max_detections": 10,
                    "test_scale": [192, 64]},
    "detector_3d": {"pc_range": [0.0, -10.24, -3.0, 20.48, 10.24, 1.0], "voxel_size": [0.32, 0.32, 4.0],
                    "max_pillars": 1024, "max_points_per_pillar": 16, "pfn_channels": 32,
                    "backbone_layers": [1, 1, 1], "backbone_channels": [32, 64, 64], "fpn_channels": [16, 16, 16],
                    "nms_pre": 64, "max_detections": 10},
}


def tiny_detect(trace: int = 0, variant: str | None = None, seed: int = 3_000_000_017):
    code = ("import sys\n"
            "from benchmark import manifest, run\n"
            "from benchmark.tests import tiny\n"
            "bench = manifest.load('.')\n"
            "cfg = manifest.config(bench, 'kitti_04_12_online', '.')\n"
            "ov = tiny.overrides('kitti_full', cfg)\n"
            f"ov['config']['detection'].update({DETECTORS!r})\n"
            "ov['mix']['lidar'] = {'beams': 16, 'azimuths': 360}\n"
            "ov['mix']['check']['det_spacing'] = 1\n"
            f"sys.exit(run.main(['--workload', 'kitti_detect', '--seed', '{seed}', '--seconds', '10', '--trace',"
            f" '{trace}', '--device', 'cpu'], ov, variant={variant!r}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", (0, 1))
def test_tiny_run_is_correct_with_both_detectors_checked(trace):
    proc, line = tiny_detect(trace)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0, line["checks"]
    bench = manifest.load(ROOT)
    if trace == 0:
        assert set(line["metrics"]) == {m["name"] for m in manifest.end_to_end(bench, "kitti_detect")}
    else:       # the CPU has no device trace and no peak: the span metrics alone
        assert set(line["metrics"]) == {"detect_ms", "det2d_enqueue_ms", "det3d_enqueue_ms"}
    assert set(DET_NUMBERS) <= set(line["checks"])
    detail = json.loads(proc.stdout.strip().splitlines()[-2])
    numbers, counts = detail["numbers"], detail["setup_breakdown"]["window_counts"]
    assert numbers["det2d_proposals"] == 64 and numbers["det2d_rcnn_picks"] >= 1 and numbers["det3d_picks"] >= 1
    # rounds enqueued: 64 RPN + 10 R-CNN per keyframe
    assert counts["det2d_nms_rounds"] > 0 and counts["det2d_nms_rounds"] % (64 + 10) == 0
    assert counts["det3d_points"] > 0
    assert "dspslam_tpu" not in proc.stderr.replace("dspslam_tpu_torch", "")


@pytest.mark.parametrize("fault,number", [("det2d.feat", "det2d_feat_gap"), ("det2d.head", "det2d_head_gap"),
                                          ("det2d.select", "det2d_select_miss"),
                                          ("det3d.pillar", "det3d_pillar_miss"), ("det3d.net", "det3d_net_gap"),
                                          ("det3d.select", "det3d_select_miss")])
def test_a_planted_detector_fault_fails_its_number(fault, number):
    _, line = tiny_detect(variant=fault)
    assert line["correct"] is False
    failed = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert failed == {number}, line["checks"]


def test_detector_flops_match_a_hand_count():
    cfg_2d = {"stage_blocks": [1, 1, 1, 1], "stem_channels": 4, "fpn_channels": 8, "anchor_scales": [8.0],
              "anchor_ratios": [0.5, 1.0, 2.0], "num_classes": 2, "fc_dim": 16, "roi_size": 7, "mask_roi_size": 14,
              "rpn_post_nms": 10, "max_detections": 5, "test_scale": None}
    stem = 2 * 3 * 4 * 49 * 32 * 32
    stage1 = 2 * 4 * 4 * 256 + 2 * 4 * 4 * 9 * 256 + 2 * 4 * 16 * 256 + 2 * 4 * 16 * 256
    stage2 = 2 * 16 * 8 * 256 + 2 * 8 * 8 * 9 * 64 + 2 * 8 * 32 * 64 + 2 * 16 * 32 * 64
    stage3 = 2 * 32 * 16 * 64 + 2 * 16 * 16 * 9 * 16 + 2 * 16 * 64 * 16 + 2 * 32 * 64 * 16
    stage4 = 2 * 64 * 32 * 16 + 2 * 32 * 32 * 9 * 4 + 2 * 32 * 128 * 4 + 2 * 64 * 128 * 4
    fpn = 2 * 8 * (16 * 256 + 32 * 64 + 64 * 16 + 128 * 4) + 2 * 8 * 8 * 9 * (256 + 64 + 16 + 4)
    rpn = (2 * 8 * 8 * 9 + 2 * 8 * 3 + 2 * 8 * 12) * (256 + 64 + 16 + 4 + 1)
    box = 2 * 10 * (8 * 49 * 16 + 16 * 16 + 16 * 3 + 16 * 8)
    mask = 5 * (4 * 2 * 8 * 8 * 9 * 196 + 2 * 8 * 8 * 4 * 196 + 2 * 8 * 2 * 784)
    backbone = stem + stage1 + stage2 + stage3 + stage4
    assert detflops.maskrcnn_flops(cfg_2d, (64, 64)) == backbone + fpn + rpn + box + mask
    cfg_3d = {"pc_range": [0.0, -2.56, -3.0, 2.56, 2.56, 1.0], "voxel_size": [0.32, 0.32, 4.0], "max_pillars": 20,
              "max_points_per_pillar": 4, "pfn_channels": 4, "backbone_layers": [1, 1, 1],
              "backbone_strides": [2, 2, 2], "backbone_channels": [4, 8, 8], "fpn_upsample": [1, 2, 4],
              "fpn_channels": [2, 2, 2], "anchor_rotations": [0.0, 1.57]}
    pfn = 2 * 20 * 4 * 10 * 4                        # a 16 x 8 grid: blocks at 8 x 4, 4 x 2, 2 x 1
    block0 = 2 * 2 * 4 * 4 * 9 * 32 + 2 * 4 * 2 * 1 * 32
    block1 = 2 * 4 * 8 * 9 * 8 + 2 * 8 * 8 * 9 * 8 + 2 * 8 * 2 * 4 * 8
    block2 = 2 * 2 * 8 * 8 * 9 * 2 + 2 * 8 * 2 * 16 * 2
    heads = 2 * 6 * 2 * (1 + 7 + 2) * 32
    assert detflops.pointpillars_flops(cfg_3d) == pfn + block0 + block1 + block2 + heads
    # the cell's configuration: about 340 and 70 GFLOP
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", "kitti_04_12_online.json")))["detection"]
    assert detflops.maskrcnn_input(cfg["detector_2d"], (376, 1241)) == (416, 1344)
    assert 330e9 < detflops.maskrcnn_flops(cfg["detector_2d"], (376, 1241)) < 350e9
    assert 60e9 < detflops.pointpillars_flops(cfg["detector_3d"]) < 75e9


def test_detect_readers_on_a_hand_made_run():
    spans = {"detect": [(1.0, 1.3), (3.0, 3.5), (5.0, 5.1)], "det2d_dispatch": [(1.0, 1.2), (3.0, 3.4)],
             "det3d_dispatch": [(1.2, 1.25), (3.4, 3.43)]}
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", "kitti_04_12_online.json")))
    per = detflops.keyframe_flops(cfg["detection"]["detector_2d"], cfg["detection"]["detector_3d"], (376, 1241))
    # the whole window untraced, then a trace that stopped at 2 s: the spans begun before it are left out
    for t1, detect, d2, d3 in ((None, [0.3, 0.5, 0.1], [0.2, 0.4], [0.05, 0.03]), (2.0, [0.5, 0.1], [0.4], [0.03])):
        run = fake_run(spans, t1)
        run.device, run.config = types.SimpleNamespace(type="cuda"), cfg
        assert manifest.reader("detect_ms")(run) == pytest.approx(1e3 * np.mean(detect))
        assert manifest.reader("det2d_enqueue_ms")(run) == pytest.approx(1e3 * np.mean(d2))
        assert manifest.reader("det3d_enqueue_ms")(run) == pytest.approx(1e3 * np.mean(d3))
        assert manifest.reader("detect_mfu")(run) == pytest.approx(100 * per * len(detect) / sum(detect) / 989e12)
    run = fake_run(spans)
    run.device, run.config = types.SimpleNamespace(type="cpu"), cfg
    assert manifest.reader("detect_mfu")(run) is None
    # a program without the spans (the parent of this cell): nothing to read
    run = fake_run({})
    run.device, run.config = types.SimpleNamespace(type="cuda"), cfg
    assert all(manifest.reader(m)(run) is None for m in ("detect_ms", "det2d_enqueue_ms", "det3d_enqueue_ms",
                                                         "detect_mfu"))
