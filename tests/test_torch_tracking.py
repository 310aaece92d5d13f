"""The stereo tracking slice as a whole: dspslam_tpu's Tracker and the PyTorch
port's Tracker(device="cpu") over the same LayeredWorld street turn
(160 x 480, fx 400, 0.4 m baseline, 8 frames of forward_turn_trajectory,
ORBParams(n_features=500, n_levels=1)), non-pipelined and pipelined.

Checked per frame: the same State and lost flag, and T_cw within 1e-3 (f32
pose GN over 2 stages x 40 iterations whose normal equations sum in another
order, feeding discrete inlier decisions); at the end: the same keyframe and
map-point counts, and translation error against the ground truth < 3 cm.

    python tests/test_torch_tracking.py [xla|pallas]

runs the JAX tracker over chip_smoke.py's full-width KITTI-shaped sequence
on the CPU and prints its lost frames and ATE, the check that the sequence
is trackable before the port is held to it on the card. The default, "auto",
takes the arc-min FAST response on the CPU; "pallas" takes the two-tier
response of the card's kernel K2 (the Pallas kernel in interpret mode).
"""

import pathlib

import numpy as np
import pytest
import torch

from dspslam_tpu.frontend import orb as jorb
from dspslam_tpu.slam import tracking as jtr
from dspslam_tpu.slam.map import Map as JMap
from dspslam_tpu_torch.config import SystemConfig
from dspslam_tpu_torch.datasets.synthetic import (
    LayeredWorld,
    forward_turn_trajectory,
    kitti_turn_sequence,
    render_stereo_u8,
)
from dspslam_tpu_torch.frontend import orb as torb
from dspslam_tpu_torch.slam import map as tmap
from dspslam_tpu_torch.slam import tracking as ttr
from dspslam_tpu_torch.utils.evaluation import ate_rmse

H, W, FX, BASELINE = 160, 480, 400.0, 0.4
KITTI_CONFIG = pathlib.Path(__file__).resolve().parents[1] / "configs" / "kitti_00_02.json"


@pytest.fixture(scope="module")
def sequence():
    world = LayeredWorld(
        W, H, FX, depths=(40.0, 26.0, 16.0), coverage=(1.0, 0.32, 0.22),
        ground_height=1.5, max_ground_depth=40.0, x_range=(-2.0, 10.0), seed=12,
        yaw_max=np.radians(40.0), z_range=(0.0, 12.0),
    )
    poses = forward_turn_trajectory(8, step=0.35, turn_start=2, turn_frames=16,
                                    total_yaw=np.radians(35.0))
    return poses, render_stereo_u8(world, poses, BASELINE)


def _config(mod, pipelined):
    return mod.TrackerConfig(
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=FX * BASELINE, width=W, height=H,
        min_init_features=150, max_frames_between_kf=3, search_radius_motion=50.0,
        pipelined=pipelined,
    )


def _run(tracker, images):
    for k, (l, r) in enumerate(images):
        tracker.process_stereo(l, r, 0.1 * k)
    tracker.flush()
    return tracker


@pytest.fixture(scope="module", params=[False, True], ids=["fused", "pipelined"])
def both(request, sequence):
    poses, images = sequence
    jt = _run(jtr.Tracker(_config(jtr, request.param), JMap(),
                          jorb.ORBParams(n_features=500, n_levels=1)), images)
    tt = _run(ttr.Tracker(_config(ttr, request.param), tmap.Map(),
                          torb.ORBParams(n_features=500, n_levels=1), device="cpu"), images)
    return poses, jt, tt


def test_same_states_and_lost_flags(both):
    _, jt, tt = both
    assert len(tt.trajectory) == len(jt.trajectory) == 8
    assert [l for _, _, l in tt.trajectory] == [l for _, _, l in jt.trajectory]
    assert not any(l for _, _, l in tt.trajectory)
    assert tt.state.name == jt.state.name == "OK"


def test_same_map(both):
    _, jt, tt = both
    assert len(tt.map.keyframes) == len(jt.map.keyframes) >= 2
    assert len(tt.map.points) == len(jt.map.points) > 100


def test_poses_match_jax(both):
    _, jt, tt = both
    for (ta, Ta, _), (tb, Tb, _) in zip(jt.trajectory, tt.trajectory):
        assert ta == tb
        assert np.abs(np.asarray(Ta) - Tb).max() <= 1e-3


def test_tracks_the_ground_truth(both):
    poses, _, tt = both
    est = np.stack([np.linalg.inv(T) for _, T, _ in tt.trajectory])
    assert np.abs(est[:, :3, 3] - poses[:, :3, 3]).max() < 0.03


def test_frames_carry_host_features(both):
    """Pipelined frames are born with device features; the host copy has
    uint32 descriptors, as the JAX package's."""
    _, jt, tt = both
    kf = max(tt.map.keyframes.values(), key=lambda k: k.id)
    assert kf.feats["desc"].dtype == np.uint32 and kf.feats["desc"].shape[1] == 8
    dev = kf.feats_torch("cpu")
    assert dev["desc"].dtype == torch.int32
    np.testing.assert_array_equal(dev["desc"].numpy().view(np.uint32), kf.feats["desc"])


def test_tracker_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ttr.Tracker(ttr.TrackerConfig(), tmap.Map())


def test_tracker_from_system_config_takes_dsp_slam_settings():
    sc = SystemConfig.from_json(str(KITTI_CONFIG))
    tr = ttr.tracker_from_system_config(sc, pipelined=True, device="cpu")
    cfg, p = tr.cfg, tr.orb_params
    assert (cfg.fx, cfg.bf, cfg.width, cfg.height) == (718.856, 386.1448, 1241, 376)
    assert cfg.max_frames_between_kf == 10 and cfg.pipelined
    assert (p.n_features, p.n_levels, p.fast_threshold, p.min_threshold) == (2000, 8, 20, 7)
    assert p.cell_size == jorb.ORBParams().cell_size


def _kitti_jax_check(fast_backend="auto"):
    """The JAX tracker over chip_smoke.py's phase-7 sequence, on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sc = SystemConfig.from_json(str(KITTI_CONFIG))
    cam = sc.camera
    world, poses, baseline = kitti_turn_sequence(cam)
    images = render_stereo_u8(world, poses, baseline)
    for pipelined in (False, True):
        cfg = jtr.TrackerConfig(
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.baseline_fx,
            width=cam.width, height=cam.height, th_depth=cam.depth_threshold,
            max_frames_between_kf=int(cam.fps),
            dist_coeffs=(cam.k1, cam.k2, cam.p1, cam.p2, cam.k3), pipelined=pipelined,
        )
        params = jorb.ORBParams(
            n_features=sc.orb.n_features, scale_factor=sc.orb.scale_factor,
            n_levels=sc.orb.n_levels, fast_threshold=sc.orb.ini_th_fast,
            min_threshold=sc.orb.min_th_fast, fast_backend=fast_backend,
        )
        tr = _run(jtr.Tracker(cfg, JMap(), params), images)
        est = np.stack([np.linalg.inv(T) for _, T, _ in tr.trajectory])
        print(f"JAX tracker (CPU, fast_backend={fast_backend}), pipelined={pipelined}: {len(tr.trajectory)} frames, "
              f"{sum(l for _, _, l in tr.trajectory)} lost, state {tr.state.name}, "
              f"{len(tr.map.keyframes)} keyframes, ATE {ate_rmse(est, poses)['rmse']:.4f} m "
              f"over {0.35 * (len(poses) - 1):.2f} m")


if __name__ == "__main__":
    import sys

    _kitti_jax_check(*sys.argv[1:])
