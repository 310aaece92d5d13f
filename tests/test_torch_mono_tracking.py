"""Monocular tracking as a whole: dspslam_tpu's SLAMSystem and the PyTorch
port's SLAMSystem(device="cpu") over tests/test_mono_slam.py's scene (240 x
640, a far plane and large textured near patches, 10 frames strafing
0.12 m; ORB 600 features, 4 levels) in three forms: "fused" (the steady state as one frame program),
"pipelined" (one frame in flight) and "modular" (a camera with a small lens
coefficient, k1 = 1e-4, which keeps every frame on the modular path and
undistorts keypoints on the host).

Checked: the same two-view initialization (the frame it happens at and its
two keyframes), the same keyframes (by the frame that made them), the same
map-point count, the same lost flags, and T_cw within 1e-3 per frame (the
mono gauge is the same in both packages because the initialization picks
the same frame pair and matches: window matching and the initializer are
exact, tests/test_torch_mono.py). Found on this CPU: within 4e-6. The
port must also pass test_mono_slam.py's own trajectory check.
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
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import test_mono_slam as mono_scene  # noqa: E402


def _mono_config(mod, form):
    s = mono_scene
    return mod.TrackerConfig(fx=s.FX, fy=s.FY, cx=s.CX, cy=s.CY, width=s.W, height=s.H,
                             max_frames_between_kf=3, search_radius_motion=40.0,
                             pipelined=form == "pipelined",
                             dist_coeffs=(1e-4, 0.0, 0.0, 0.0, 0.0) if form == "modular" else (0.0,) * 5)


@pytest.fixture(scope="module", params=["fused", "pipelined", "modular"])
def mono(request):
    world = mono_scene.textured_world()
    images = [mono_scene.render(world, k * 0.12) for k in range(10)]

    def make(sysmod, trmod, orbmod, kw):
        return sysmod.SLAMSystem(tracker_cfg=_mono_config(trmod, request.param),
                                 orb_params=orbmod.ORBParams(n_features=600, n_levels=4), **kw)

    def drive(system):
        for k, img in enumerate(images):
            system.track_mono(img, timestamp=0.1 * k)
        system.flush()
        return system

    js = drive(make(jsystem, jtracking, jorb, {}))
    ts = drive(make(tsystem, ttracking, torb, {"device": "cpu"}))
    return request.param, js, ts


def test_mono_matches_jax(mono):
    _, js, ts = mono
    assert ts.state.name == js.state.name == "OK"
    assert len(ts.tracker.trajectory) == len(js.tracker.trajectory) == 10
    assert [kf.seq_idx for _, kf in sorted(ts.map.keyframes.items())] == \
        [kf.seq_idx for _, kf in sorted(js.map.keyframes.items())]
    assert len(ts.map.points) == len(js.map.points)
    for (ta, Ta, la), (tb, Tb, lb) in zip(js.tracker.trajectory, ts.tracker.trajectory):
        assert ta == tb and la == lb
        assert np.abs(np.asarray(Ta) - Tb).max() <= 1e-3
    kfs = [kf for _, kf in sorted(ts.map.keyframes.items())]
    # the two-view initialization's two keyframes come from one track call
    assert len(kfs) >= 3 and kfs[0].seq_idx == kfs[1].seq_idx
    assert len(ts.map.points) > 80


def test_mono_trajectory_is_a_strafe(mono):
    """tests/test_mono_slam.py's check on the port: the motion runs along +x
    (up to the mono scale) in near-constant steps."""
    _, _, ts = mono
    est = np.asarray([-T[:3, :3].T @ T[:3, 3] for _, T, lost in ts.tracker.trajectory if not lost])
    total = est[-1] - est[0]
    assert abs(total[0]) > 5 * abs(total[1]) and abs(total[0]) > 5 * abs(total[2])
    dx = np.diff(est[:, 0])
    dx = dx[np.abs(dx) > 1e-6]
    assert len(dx) >= 5 and np.std(dx) / abs(np.mean(dx)) < 0.2


def test_tracker_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ttracking.Tracker(ttracking.TrackerConfig(), ttracking.Map())
