"""The mono throughput composition pin, the port's form of
tests/test_mono_throughput_composition.py: the mono benchmark's
configuration (pipelined tracking, async keyframes and local BA) over
tests/test_mono_slam.py's scene (240 x 640, 24 frames strafing 0.12 m, ORB
600 features, 4 levels, a keyframe at least every 3 frames), counting the
blocking result fetches per tracked frame. Every device result the tracker
and the local mapper read passes through `tracking._host_result` (a wait on
the result's CUDA event on the card), so the pin counts its calls.

Steady frames (from frame 6, after the initialization and the first
keyframes) fetch once for the tracked frame and at most once more for the
one deferred mapping result a poll applies; frames with that second fetch
stay the minority; keyframes do not cascade (3-10 over the 24 frames).
"""

import sys

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.frontend import orb as torb
from dspslam_tpu_torch.slam import local_mapping as tlocal
from dspslam_tpu_torch.slam import system as tsystem
from dspslam_tpu_torch.slam import tracking as ttracking

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import test_mono_slam as mono_scene  # noqa: E402

N_FRAMES = 24
WARMUP = 6


@pytest.fixture(scope="module")
def counted_run():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    s = mono_scene
    world = s.textured_world()
    system = tsystem.SLAMSystem(
        tracker_cfg=ttracking.TrackerConfig(fx=s.FX, fy=s.FY, cx=s.CX, cy=s.CY, width=s.W, height=s.H,
                                            max_frames_between_kf=3, search_radius_motion=40.0,
                                            pipelined=True),
        orb_params=torb.ORBParams(n_features=600, n_levels=4),
        local_mapper_cfg=tlocal.LocalMapperConfig(fx=s.FX, fy=s.FY, cx=s.CX, cy=s.CY, async_ba=True,
                                                  async_keyframe=True),
        device="cpu")
    real = ttracking._host_result
    count = [0]

    def counting(host, event):
        count[0] += 1
        return real(host, event)

    counts = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttracking, "_host_result", counting)
        mp.setattr(tlocal, "_host_result", counting)
        for k in range(N_FRAMES):
            count[0] = 0
            system.track_mono(s.render(world, k * 0.12), timestamp=0.1 * k)
            counts.append(count[0])
    torch.set_num_threads(n)
    return system, np.asarray(counts)


def test_tracks_to_the_end(counted_run):
    system, _ = counted_run
    assert system.state.name == "OK"
    assert not any(lost for _, _, lost in system.tracker.trajectory[WARMUP:])


def test_steady_frame_does_at_most_two_fetches(counted_run):
    _, counts = counted_run
    steady = counts[WARMUP:]
    assert steady.max() <= 2 and steady.min() >= 1, steady.tolist()


def test_apply_frames_are_the_minority(counted_run):
    _, counts = counted_run
    assert counts[WARMUP:].mean() <= 1.7, counts.tolist()


def test_keyframes_do_not_cascade(counted_run):
    system, _ = counted_run
    assert 3 <= len(system.map.keyframes) <= 10
