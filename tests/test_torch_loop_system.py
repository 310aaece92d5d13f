"""Loop closing inside the PyTorch port's SLAMSystem, and the slice's entry
points defaulting to the card.

* tests/test_loop_closing.py::test_full_system_loop_closer_no_false_positives
  through the port (device="cpu"): a drift-free stereo out-and-back (x = 0
  to 8 m and back at 0.4 m per frame, 640 x 240 frames of a layered world,
  600 ORB features over 3 levels, a K=8, L=3 vocabulary trained on the
  world's own imagery) with `enable_loop_closing` closes no loop, stays
  tracked, ends within 1.6 m of the start, and keeps its keyframe graph
  consistent (Map.check_invariants).
* LoopCloser, Relocalizer, `benchmark_slam --long_loop` and
  `extract_map_objects` run on cuda unless told otherwise, and raise
  without a card.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401


def test_full_system_loop_closer_no_false_positives():
    from dspslam_tpu_torch.datasets.synthetic import LayeredWorld
    from dspslam_tpu_torch.frontend import orb
    from dspslam_tpu_torch.place.vocabulary import Vocabulary
    from dspslam_tpu_torch.slam.system import SLAMSystem
    from dspslam_tpu_torch.slam.tracking import State, TrackerConfig

    FX, CX, CY, BASELINE, H, W = 500.0, 320.0, 120.0, 0.4, 240, 640
    world = LayeredWorld(W, H, FX, cx=CX, cy=CY, x_range=(-1.0, 9.0), seed=12)
    params = orb.ORBParams(n_features=600, n_levels=3)
    descs = []
    for x in (0.0, 3.0, 6.0):
        f = orb.extract(torch.from_numpy(np.ascontiguousarray(world.render(x))), params)
        descs.append(f["desc"].numpy().view(np.uint32)[f["valid"].numpy() > 0])
    voc = Vocabulary.train(np.concatenate(descs), branching=8, levels=3, seed=3)
    cfg = TrackerConfig(fx=FX, fy=FX, cx=CX, cy=CY, bf=FX * BASELINE, width=W, height=H,
                        min_init_features=150, max_frames_between_kf=3, search_radius_motion=50.0)
    system = SLAMSystem(tracker_cfg=cfg, orb_params=params, device="cpu")
    system.enable_loop_closing(voc)
    xs = list(np.arange(0, 8.0, 0.4)) + list(np.arange(8.0, -0.01, -0.4))
    for k, x in enumerate(xs):
        system.track_stereo(world.render(x), world.render(x, BASELINE), 0.1 * k)
    system.flush()
    assert system.state == State.OK
    assert system.loop_closer.loops_closed == 0, "false loop closure on a drift-free out-and-back"
    assert system.map_changed() and not system.map_changed()   # True once, then quiet
    T = system.tracker.trajectory[-1][1]
    assert abs(float((-T[:3, :3].T @ T[:3, 3])[0])) < 1.6
    system.map.check_invariants()
    assert set(system.kf_db.vectors) <= set(system.map.keyframes)
    assert all(system.map.keyframes[k].bow is not None for k in system.kf_db.vectors)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the error raised without a card")
def test_entry_points_default_to_the_card(tmp_path):
    from dspslam_tpu_torch.apps import benchmark_slam, extract_map_objects
    from dspslam_tpu_torch.place.loop_closing import LoopCloser
    from dspslam_tpu_torch.slam.relocalization import Relocalizer

    for call in (lambda: LoopCloser(None, None, [1.0] * 5),
                 lambda: Relocalizer(None, None, None, [1.0] * 5),
                 lambda: benchmark_slam.main(["--long_loop"]),
                 lambda: extract_map_objects.main(["--map_dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
