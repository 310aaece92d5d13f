"""The port's benchmark_slam `--workload full` on the CPU, at a small size:
6 frames of the KITTI-shaped street turn (376 x 1241) with a narrow decoder
(code 64, 4 x 128) fitted to spheres for 20 steps, and small Mask R-CNN and
PointPillars configs in the loop. The card runs the arm at full width over
bench.py's 56 frames (chip_smoke.py phase 12b) with the accuracy gates.

Here: the run loses no frame, each detector is dispatched once per
keyframe that asked for detections, the JSON record carries the JAX
benchmark's keys with the mean fps first, and `make_velodyne_scan` equals
the JAX package's exactly from the same numpy generator.
"""

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.apps import benchmark_slam
from dspslam_tpu_torch.detect import maskrcnn, pointpillars
from dspslam_tpu_torch.models import deepsdf
from torch_threads import one_torch_thread  # noqa: F401

# the JAX benchmark's JSON keys (dspslam_tpu/apps/benchmark_slam.py:690-716)
JAX_KEYS = {
    "metric", "value", "unit", "vs_baseline", "median_fps", "max_frame_ms", "frame_ms_p95", "ate_rmse_cm",
    "workload", "turn_deg", "mesh_chamfer_cm", "n_meshes", "meshes_skipped", "obj_center_err_cm", "n_objects",
    "ba_objects", "mesh_chamfer_refined_cm", "dynamic_obj_err_cm", "dynamic_pred_err_cm", "n_dynamic", "stage_ms",
}
SMALL_2D = maskrcnn.MaskRCNNConfig(num_classes=4, stage_blocks=(1, 1, 1, 1), stem_channels=8, fpn_channels=32,
                                   fc_dim=64, rpn_pre_nms=64, rpn_post_nms=16, max_detections=5)
SMALL_3D = pointpillars.PointPillarsConfig(max_pillars=2000, backbone_layers=(1, 1, 1),
                                           backbone_channels=(16, 32, 64), fpn_channels=(32, 32, 32), nms_pre=32,
                                           max_detections=8)


@pytest.fixture(scope="module")
def record():
    built = []

    def small_detectors(device):
        built.append((maskrcnn.Detector2D(cfg=SMALL_2D, device=device),
                      pointpillars.Detector3D(cfg=SMALL_3D, device=device)))
        return built[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(benchmark_slam, "BENCH_DECODER",
                   deepsdf.DecoderConfig(code_len=64, hidden=(128,) * 4, latent_in=(2,)))
        mp.setattr(benchmark_slam, "build_detectors", small_detectors)
        rec = benchmark_slam.main(["--device", "cpu", "--frames", "6", "--warmup", "3", "--mlp_steps", "20"])
    return rec, built[0]


def test_full_arm_runs_the_detectors_per_keyframe(record):
    rec, (det2d, det3d) = record
    assert rec["workload"] == "detectors+mlp" and rec["lost_frames"] == 0
    assert rec["detector_calls"] >= rec["n_keyframes"] >= 2
    assert rec["detector_dispatches"] == {"maskrcnn": rec["detector_calls"], "pointpillars": rec["detector_calls"]}
    assert det2d.dispatches == det3d.dispatches == rec["detector_calls"]
    assert {"detector_dispatch", "detector_collect", "upload_enqueue"} <= set(rec["stage_ms"])
    assert rec["decoder_fit"]["steps"] == 20 and np.isfinite(rec["decoder_fit"]["l1"])
    assert rec["n_objects"] >= 1 and sum(rec["gn_dispatches"].values()) >= 1


def test_full_arm_record_has_jax_keys_mean_first(record):
    rec, _ = record
    assert JAX_KEYS <= set(rec)
    assert list(rec)[:4] == ["metric", "value", "unit", "median_fps"]
    assert rec["value"] == pytest.approx(1e3 / rec["mean_frame_ms"])
    assert rec["mesh_chamfer_refined_cm"] is not None


def test_velodyne_scan_equals_jax():
    from dspslam_tpu.apps import benchmark_slam as jbs

    traj = benchmark_slam.make_benchmark_trajectory(8)
    world = benchmark_slam.build_world(z_travel=3.4)
    spheres = np.vstack([benchmark_slam.place_spheres(traj), benchmark_slam.dynamic_sphere_traj(traj, 7)[3][None]])
    a = benchmark_slam.make_velodyne_scan(traj[3], world, spheres, np.random.default_rng(1))
    b = jbs.make_velodyne_scan(traj[3], world, spheres, np.random.default_rng(1))
    assert a.dtype == np.float32 and a.shape[1] == 4 and len(a) > 40000
    np.testing.assert_array_equal(a, b)


def test_full_arm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        benchmark_slam.main(["--frames", "2", "--workload", "full"])
