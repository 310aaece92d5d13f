"""The port's SLAM benchmark on the CPU. The stereo arm (`--workload legacy`): 7
frames of the KITTI-shaped street turn (376 x 1241, 2000 features, 8
levels, GT-derived sphere detections, the sphere decoder, pipelined
tracking, async joint BA). The card runs it over 20 frames in
chip_smoke.py phase 8a with the same checks: 0 lost frames, ATE < 3% of
travel, static objects within 0.35 m of a true sphere centre, a local BA
solve with a camera-object edge inlier; mean fps is reported first, the
median beside it. The mono arm (`--mono`) at a quarter of Freiburg's
camera over 10 frames: it initializes, loses no frame after that and
reports mean fps first (phase 9a runs it at full size).
"""

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.apps import benchmark_slam
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def record():
    return benchmark_slam.main(["--device", "cpu", "--frames", "7", "--warmup", "3", "--workload", "legacy"])


def test_tracks_maps_and_reconstructs(record):
    assert record["lost_frames"] == 0
    assert record["ate_rmse_cm"] / 100 < 0.03 * record["travel_m"]
    assert record["n_static"] >= 1 and max(record["static_obj_errs_m"]) < 0.35
    assert any(b["edge_inliers"] >= 1 for b in record["ba_solves"])
    assert record["mesh_chamfer_cm"] is not None and record["n_keyframes"] >= 2


def test_reports_mean_fps_first(record):
    keys = list(record)
    assert keys[:4] == ["metric", "value", "unit", "median_fps"]
    assert record["value"] == pytest.approx(1e3 / record["mean_frame_ms"])
    assert record["median_fps"] == pytest.approx(1e3 / record["median_frame_ms"])
    assert {"track", "keyframe_drain", "result_fetch"} <= set(record["stage_ms"])


def test_evaluation_helpers_match_jax(tmp_path):
    """chamfer_distance, sample_sphere, rpe and load_kitti_trajectory, the
    benchmark's host metrics, against the JAX package's."""
    from dspslam_tpu.utils import evaluation as jev
    from dspslam_tpu_torch.utils import evaluation as tev

    rng = np.random.default_rng(4)
    a, b = tev.sample_sphere([1.0, 2.0, 3.0], 1.0, 300), tev.sample_sphere([1.0, 2.0, 3.1], 1.2, 200)
    np.testing.assert_array_equal(a, jev.sample_sphere([1.0, 2.0, 3.0], 1.0, 300))
    assert tev.chamfer_distance(a, b) == jev.chamfer_distance(a, b) > 0.1
    est = np.tile(np.eye(4), (12, 1, 1))
    est[:, 0, 3] = np.arange(12) * 0.5 + rng.normal(0, 0.01, 12)
    gt = est.copy()
    gt[:, 0, 3] = np.arange(12) * 0.5
    assert tev.rpe(est, gt, delta=2) == jev.rpe(est, gt, delta=2)
    path = tmp_path / "Cameras.txt"
    np.savetxt(path, est[:, :3, :].reshape(12, 12))
    np.testing.assert_array_equal(tev.load_kitti_trajectory(str(path)), jev.load_kitti_trajectory(str(path)))


@pytest.fixture(scope="module")
def mono_record():
    """The mono arm at a quarter of Freiburg's camera (240 x 135, fx 232.55),
    4000 features, 8 levels, 10 frames; accuracy is checked at full size on
    the card (chip_smoke.py phase 9a)."""
    return benchmark_slam.main(["--mono", "--mono_profile", "freiburg", "--mono_downscale", "4",
                                "--frames", "10", "--warmup", "4", "--device", "cpu"])


def test_mono_arm_initializes_and_tracks(mono_record):
    r = mono_record
    assert (r["width"], r["height"], r["downscale"]) == (240, 135, 4)
    assert r["fx"] == pytest.approx(930.2 / 4)
    assert r["init_frame"] is not None and r["init_frame"] < 5
    assert r["lost_after_init"] == 0 and r["frames_tracked"] == 10 and r["pipelined"]
    assert r["n_keyframes"] >= 3 and r["ate_rmse_cm"] is not None


def test_mono_arm_reports_mean_fps_first(mono_record):
    r = mono_record
    assert list(r)[:4] == ["metric", "value", "unit", "median_fps"]
    assert r["metric"] == "mono_slam_fps_freiburg"
    assert r["value"] == pytest.approx(1e3 / r["mean_frame_ms"])
    assert r["median_fps"] == pytest.approx(1e3 / r["median_frame_ms"])
    assert r["frame_ms_p99"] >= r["median_frame_ms"]
    assert {"track", "result_fetch"} <= set(r["stage_ms"]) and "drop_rate" not in r


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    for argv in (["--frames", "2"], ["--mono", "--frames", "2"]):
        with pytest.raises(RuntimeError, match="cuda"):
            benchmark_slam.main(argv)
