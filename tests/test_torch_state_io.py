"""Map checkpoints: dspslam_tpu.slam.state_io and the PyTorch port's.

* A checkpoint the JAX package writes (its SLAMSystem over 5 stereo frames
  of tests/test_relocalization.py's two-layer world, x = 0..0.6 m) loads in
  the port with the same keyframes, poses, observation graph and
  covisibility, and the port's system continues on it: relocalized in the
  loaded map at x = 0.45 m, then tracked to x = 0.9 m, within 8 cm of the
  truth, with new keyframes minting ids past the loaded ones.
* The port's own checkpoint round-trips, and JAX's `load_state` reads it.
* Fault R2: the port saves and restores each object's
  `last_measured_kf_id`, `last_measured_frame_id` and `n_shape_refinements`,
  so a loaded dynamic object's prediction horizon and refinement bound
  equal those of the uninterrupted map; a JAX checkpoint (without them)
  loads each object as created at its reference keyframe.
"""

import sys

import numpy as np
import pytest
import torch

from dspslam_tpu.slam import state_io as jstate
from dspslam_tpu_torch.slam import state_io as tstate

sys.path.insert(0, "tests")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_maps(a, b):
    assert set(a.keyframes) == set(b.keyframes)
    assert set(a.points) == set(b.points)
    for kf_id, kf in a.keyframes.items():
        other = b.keyframes[kf_id]
        np.testing.assert_array_equal(kf.T_cw, other.T_cw)
        np.testing.assert_array_equal(kf.map_point_ids, other.map_point_ids)
        assert kf.covis == other.covis and kf.parent == other.parent
        assert kf.children == other.children and kf.loop_edges == other.loop_edges
        for key in ("xy", "desc", "valid"):
            np.testing.assert_array_equal(kf.feats[key], other.feats[key])
    for p_id, p in a.points.items():
        assert p.observations == b.points[p_id].observations
        np.testing.assert_array_equal(p.position, b.points[p_id].position)


def test_jax_checkpoint_loads_and_continues_in_port(tmp_path):
    from test_relocalization import BASELINE, BF, CX, CY, FX, FY, H, W, render, textured_world

    from dspslam_tpu.frontend import orb as jorb
    from dspslam_tpu.slam import system as jsystem
    from dspslam_tpu.slam import tracking as jtracking
    from dspslam_tpu_torch.frontend import orb as torb
    from dspslam_tpu_torch.place.vocabulary import Vocabulary
    from dspslam_tpu_torch.slam.system import SLAMSystem
    from dspslam_tpu_torch.slam.tracking import State, TrackerConfig

    world = textured_world()
    kw = dict(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, width=W, height=H, min_init_features=150,
              max_frames_between_kf=2, search_radius_motion=40.0)
    js = jsystem.SLAMSystem(tracker_cfg=jtracking.TrackerConfig(**kw),
                            orb_params=jorb.ORBParams(n_features=500, n_levels=3))
    for k, x in enumerate(np.arange(0, 0.61, 0.15)):
        js.track_stereo(render(world, x), render(world, x, BASELINE), 0.1 * k)
    path = str(tmp_path / "jax_state.npz")
    jstate.save_state(js.map, path)

    loaded = tstate.load_state(path)
    _same_maps(jstate.load_state(path), loaded)
    loaded.check_invariants()
    n_kf = len(loaded.keyframes)
    assert n_kf >= 2

    # continue: the port's system on the loaded map, relocalized in it
    params = torb.ORBParams(n_features=500, n_levels=3)
    system = SLAMSystem(tracker_cfg=TrackerConfig(**kw), orb_params=params, device="cpu")
    system.map = system.tracker.map = system.local_mapper.map = loaded
    descs = np.concatenate([kf.feats["desc"][kf.feats["valid"] > 0] for kf in loaded.keyframes.values()])
    voc = Vocabulary.train(descs, branching=6, levels=2)
    system.attach_vocabulary(voc)
    for kf_id, kf in loaded.keyframes.items():
        system.kf_db.add(kf_id, voc.bow_vector(kf.feats["desc"], kf.feats["valid"]))
    system.tracker.state = State.LOST
    system.tracker.ref_kf = loaded.keyframes[max(loaded.keyframes)]
    for k, x in enumerate(np.arange(0.45, 0.91, 0.15)):
        system.track_stereo(render(world, x), render(world, x, BASELINE), 1.0 + 0.1 * k)
        assert system.state == State.OK, f"lost at x={x}"
        T = system.tracker.trajectory[-1][1]
        np.testing.assert_allclose(-T[:3, :3].T @ T[:3, 3], [x, 0.0, 0.0], atol=0.08)
    system.flush()
    new_ids = set(system.map.keyframes) - set(jstate.load_state(path).keyframes)
    assert new_ids and min(new_ids) > max(jstate.load_state(path).keyframes)
    system.map.check_invariants()

    # the port's checkpoint of the continued map round-trips, in both packages
    path2 = str(tmp_path / "port_state.npz")
    tstate.save_state(system.map, path2)
    _same_maps(tstate.load_state(path2), jstate.load_state(path2))


def _object_map(M, stamp=True):
    feats = {"xy": np.zeros((4, 2), np.float32), "desc": np.zeros((4, 8), np.uint32),
             "angle": np.zeros(4, np.float32), "level": np.zeros(4, np.int32),
             "sigma2": np.ones(4, np.float32), "response": np.zeros(4, np.float32),
             "valid": np.ones(4, np.float32)}
    m = M.Map()
    kfs = []
    for t in range(3):
        kf = M.KeyFrame(M.Frame(float(t), dict(feats)))
        m.add_keyframe(kf)
        kfs.append(kf)
    obj = M.MapObject(np.eye(4, dtype=np.float32), np.zeros(8, np.float32), kfs[0].id)
    obj.dynamic = True
    obj.velocity = np.array([0.5, 0.0, 0.0], np.float32)
    obj.observations = {kfs[0].id: 0, kfs[1].id: 0}
    if stamp:
        obj.last_measured_kf_id, obj.last_measured_frame_id = kfs[1].id, kfs[1].frame_id
        obj.n_shape_refinements = 2
    m.add_object(obj)
    return m, kfs, obj


def test_r2_object_fields_round_trip(tmp_path):
    """Save, load, continue: the horizon of the constant-velocity prediction
    (frames since the last measured keyframe) and the refinement count
    equal the uninterrupted map's."""
    from dspslam_tpu_torch.objects.pipeline import ObjectPipeline
    from dspslam_tpu_torch.slam import map as tmap

    m, kfs, obj = _object_map(tmap)
    path = str(tmp_path / "r2.npz")
    tstate.save_state(m, path)
    loaded = tstate.load_state(path)
    lobj = loaded.objects[obj.id]
    for key in ("last_measured_kf_id", "last_measured_frame_id", "n_shape_refinements"):
        assert getattr(lobj, key) == getattr(obj, key)
    assert [kf.frame_id for kf in loaded.keyframes.values()] == [kf.frame_id for kf in kfs]

    # a keyframe of the continued session; its frame id follows the loaded ones
    new_kf = tmap.KeyFrame(tmap.Frame(9.0, dict(kfs[0].feats)))
    assert new_kf.frame_id > kfs[-1].frame_id
    loaded.add_keyframe(new_kf)

    class _Pipe:
        map = loaded

    horizon = ObjectPipeline._horizon(_Pipe, lobj, new_kf, 1.0)
    _Pipe.map = m
    assert horizon == ObjectPipeline._horizon(_Pipe, obj, new_kf, 1.0) == new_kf.frame_id - kfs[1].frame_id
    # the refinement bound (ObjectPipeline: refine while n < max_shape_refinements)
    for bound in (2, 3):
        assert (lobj.n_shape_refinements < bound) == (obj.n_shape_refinements < bound)
    assert lobj.n_shape_refinements == obj.n_shape_refinements == 2


def test_r2_jax_checkpoint_defaults(tmp_path):
    """A JAX checkpoint has none of the three fields: each object loads as
    the object pipeline creates one at its reference keyframe."""
    from dspslam_tpu.slam import map as jmap

    m, kfs, obj = _object_map(jmap, stamp=False)
    path = str(tmp_path / "jax_r2.npz")
    jstate.save_state(m, path)
    lobj = tstate.load_state(path).objects[obj.id]
    assert lobj.last_measured_kf_id == kfs[0].id
    assert lobj.last_measured_frame_id == -1          # JAX saves no keyframe frame ids
    assert lobj.n_shape_refinements == 0
    np.testing.assert_array_equal(lobj.velocity, obj.velocity)
    assert lobj.dynamic


def test_resume_and_continue_mints_fresh_ids(tmp_path):
    from dspslam_tpu_torch.slam import map as tmap
    from dspslam_tpu_torch.slam.map import Frame, KeyFrame, MapObject, MapPoint

    m, kfs, obj = _object_map(tmap)
    p = MapPoint(np.zeros(3, np.float32), np.zeros(8, np.uint32), kfs[0].id)
    m.add_point(p)
    m.add_observation(p, kfs[0], 0)
    path = str(tmp_path / "state.npz")
    tstate.save_state(m, path)
    loaded = tstate.load_state(path)
    kf2 = KeyFrame(Frame(1.0, dict(kfs[0].feats)))
    p2 = MapPoint(np.ones(3, np.float32), np.zeros(8, np.uint32), kf2.id)
    obj2 = MapObject(np.eye(4, dtype=np.float32), np.zeros(8, np.float32), kf2.id)
    assert kf2.id not in loaded.keyframes and p2.id not in loaded.points
    assert obj2.id not in loaded.objects
    assert p2.id != p.id and obj2.id != obj.id
