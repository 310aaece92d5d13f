"""RGB-D tracking as a whole: dspslam_tpu's SLAMSystem and the PyTorch port's
SLAMSystem(device="cpu") over tests/test_rgbd.py's scene (240 x 640, a far
plane at 10 m and near patches at 5 m with their depth image, 8 frames
strafing 0.12 m; ORB 500 features, 3 levels), fused (the steady state as
one frame program, the depth lookup on the device) and pipelined.

Checked: the same keyframes (by the frame that made them) and lost flags,
T_cw within 1e-3 per frame, the map-point count within 2 of JAX's, and the
port's accuracy as test_rgbd.py checks it (x within 5 cm RMS, both depth
layers in the map). Found on this CPU: T_cw within 1.2e-4 and one map
point more than JAX at the third keyframe: the frame before it tracks with
one inlier decision split, after local BA's f32 solves (summed in another
order) moved the map by ~1e-7.
"""

import sys

import numpy as np
import pytest
import torch

from dspslam_tpu.frontend import orb as jorb
from dspslam_tpu.slam import system as jsystem
from dspslam_tpu.slam import tracking as jtracking
from dspslam_tpu_torch.frontend import orb as torb
from dspslam_tpu_torch.slam import system as tsystem
from dspslam_tpu_torch.slam import tracking as ttracking

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import test_rgbd as rgbd_scene  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: with parallel
    test workers, each worker's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["fused", "pipelined"])
def rgbd(request):
    s = rgbd_scene
    world = s.world_and_depth(seed=9)
    frames = [s.render_rgbd(world, k * 0.12) for k in range(8)]

    def make(sysmod, trmod, orbmod, kw):
        cfg = trmod.TrackerConfig(fx=s.FX, fy=s.FY, cx=s.CX, cy=s.CY, bf=s.BF, width=s.W, height=s.H,
                                  min_init_features=150, max_frames_between_kf=3,
                                  pipelined=request.param == "pipelined")
        return sysmod.SLAMSystem(tracker_cfg=cfg, orb_params=orbmod.ORBParams(n_features=500, n_levels=3), **kw)

    def drive(system):
        for k, (img, depth) in enumerate(frames):
            system.track_rgbd(img, depth, 0.1 * k)
        system.flush()
        return system

    js = drive(make(jsystem, jtracking, jorb, {}))
    ts = drive(make(tsystem, ttracking, torb, {"device": "cpu"}))
    return request.param, js, ts


def test_rgbd_matches_jax(rgbd):
    _, js, ts = rgbd
    assert ts.state.name == js.state.name == "OK"
    assert len(ts.tracker.trajectory) == len(js.tracker.trajectory) == 8
    assert [kf.seq_idx for _, kf in sorted(ts.map.keyframes.items())] == \
        [kf.seq_idx for _, kf in sorted(js.map.keyframes.items())]
    assert abs(len(ts.map.points) - len(js.map.points)) <= 2
    for (ta, Ta, la), (tb, Tb, lb) in zip(js.tracker.trajectory, ts.tracker.trajectory):
        assert ta == tb and la == lb
        assert np.abs(np.asarray(Ta) - Tb).max() <= 1e-3
    est = np.asarray([(-T[:3, :3].T @ T[:3, 3])[0] for _, T, _ in ts.tracker.trajectory])
    assert np.sqrt(np.mean((est - np.arange(8) * 0.12) ** 2)) < 0.05
    z = np.stack([p.position for p in ts.map.points.values()])[:, 2]
    assert (np.abs(z - rgbd_scene.FAR_Z) < 0.5).sum() > 50 and (np.abs(z - rgbd_scene.NEAR_Z) < 0.5).sum() > 5



def test_rgbd_modular_path_with_a_lens():
    """A camera with lens coefficients stays on the modular path: the depth
    lookup at the raw pixels, then host undistortion (the port alone: the
    undistortion is tests/test_torch_orb.py's exact copy)."""
    s = rgbd_scene
    world = s.world_and_depth(seed=9)
    cfg = ttracking.TrackerConfig(fx=s.FX, fy=s.FY, cx=s.CX, cy=s.CY, bf=s.BF, width=s.W, height=s.H,
                                  min_init_features=150, max_frames_between_kf=3,
                                  dist_coeffs=(1e-4, 0.0, 0.0, 0.0, 0.0))
    system = tsystem.SLAMSystem(tracker_cfg=cfg, orb_params=torb.ORBParams(n_features=500, n_levels=3),
                                device="cpu")
    for k in range(6):
        system.track_rgbd(*s.render_rgbd(world, k * 0.12), 0.1 * k)
    assert system.state.name == "OK"
    est = np.asarray([(-T[:3, :3].T @ T[:3, 3])[0] for _, T, _ in system.tracker.trajectory])
    assert np.sqrt(np.mean((est - np.arange(6) * 0.12) ** 2)) < 0.05
