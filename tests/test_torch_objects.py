"""The object stage: the association and dynamic-object cases of
tests/test_dynamic_objects.py on the PyTorch port (each verdict also checked
against dspslam_tpu's), one keyframe through dspslam_tpu's ObjectPipeline
and the port's with the sphere decoder (code 8, k4 = 0), and the port's
repair of fault R3 (ROADMAP section 3).

Pipeline tolerances: object poses (Sim(3) T_wo) and codes within 1e-4, the
pose-only measurement T_co within 1e-4 (f32 GN whose normal equations sum
in another order).
"""

import numpy as np
import pytest
import torch

from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu.objects import association as jassoc
from dspslam_tpu.objects import pipeline as jpipe
from dspslam_tpu.objects.detections import Detection as JDetection
from dspslam_tpu.shape import gn as jgn
from dspslam_tpu.slam import map as jmap
from dspslam_tpu_torch.models import deepsdf as tdeepsdf
from dspslam_tpu_torch.objects import association as tassoc
from dspslam_tpu_torch.objects import pipeline as tpipe
from dspslam_tpu_torch.objects.detections import Detection as TDetection
from dspslam_tpu_torch.shape import gn as tgn
from dspslam_tpu_torch.slam import map as tmap

CODE = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: with parallel
    test workers, each worker's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_kf(mod, T_cw=np.eye(4, dtype=np.float32)):
    feats = {
        "xy": np.zeros((10, 2), np.float32), "desc": np.zeros((10, 8), np.uint32),
        "angle": np.zeros(10, np.float32), "level": np.zeros(10, np.int32),
        "sigma2": np.ones(10, np.float32), "response": np.zeros(10, np.float32),
        "valid": np.ones(10, np.float32),
    }
    f = mod.Frame(0.0, feats)
    f.T_cw = T_cw
    return mod.KeyFrame(f)


def make_detection(det_cls, t_cam, n_pts=100):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t_cam
    return det_cls(T_cam_obj=T, scale=1.0, box_size=np.ones(3, np.float32),
                   surface_points=np.zeros((n_pts, 3), np.float32))


def _obj(mod, t=(0.0, 0.0, 0.0), observations=None, dynamic=False, velocity=None):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    o = mod.MapObject(T, np.zeros(CODE, np.float32), 0)
    if observations is not None:
        o.observations = dict(observations)
    o.dynamic = dynamic
    if velocity is not None:
        o.velocity = np.asarray(velocity, np.float32)
    return o


def _T(t=(0, 0, 0), R=None):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    if R is not None:
        T[:3, :3] = R
    return T


YAW_180 = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float32)


@pytest.mark.parametrize("T_co, observations, verdict", [
    (_T((0.05, 0.0, 0.02)), None, "static"),
    (_T((2.0, 0.0, 0.5)), {0: 0}, "dynamic"),
    (_T((2.0, 0.0, 0.5)), {0: 0, 1: 0, 2: 0}, "disassociate"),
    (_T(R=YAW_180), {0: 0, 1: 0, 2: 0}, "disassociate"),
], ids=["static_small_motion", "young_moving_goes_dynamic", "mature_jump_disassociates",
        "rotation_only_jump_caught_by_log_gate"])
def test_motion_classification(T_co, observations, verdict):
    eye = np.eye(4, dtype=np.float32)
    t = tassoc.classify_measurement(_obj(tmap, observations=observations), T_co, eye)
    j = jassoc.classify_measurement(_obj(jmap, observations=observations), T_co, eye)
    assert t == j == verdict


def test_dynamic_update_sets_velocity_and_pose():
    obj = _obj(tmap, observations={0: 0})
    tassoc.update_dynamic_object(obj, _T((2.0, 0.0, 0.5)), np.eye(4, dtype=np.float32), frame_gap=2.0)
    np.testing.assert_allclose(obj.velocity, [1.0, 0.0, 0.25], atol=1e-6)
    np.testing.assert_allclose(obj.T_wo[:3, 3], [2.0, 0.0, 0.5], atol=1e-6)


def test_velocity_prediction_enables_association():
    obj = _obj(tmap, (0.0, 0.0, 10.0), dynamic=True, velocity=[6.0, 0.0, 0.0])
    kf = make_kf(tmap)
    kf.detections = [make_detection(TDetection, [6.0, 0.0, 10.0])]
    assoc, _, _ = tassoc.associate_detections_centroid(kf, [obj], np.eye(4, dtype=np.float32), 1.0)
    assert assoc == {0: obj}
    kf2 = make_kf(tmap)
    kf2.detections = [make_detection(TDetection, [6.0, 0.0, 10.0])]
    assoc2, new2, _ = tassoc.associate_detections_centroid(
        kf2, [_obj(tmap, (0.0, 0.0, 10.0))], np.eye(4, dtype=np.float32), 1.0)
    assert assoc2 == {} and new2 == [0]


def test_best_detection_wins_conflict():
    obj = _obj(tmap, (0.0, 0.0, 8.0))
    kf = make_kf(tmap)
    kf.detections = [make_detection(TDetection, [1.5, 0.0, 8.0]),
                     make_detection(TDetection, [0.2, 0.0, 8.0])]
    assoc, new_idx, _ = tassoc.associate_detections_centroid(kf, [obj], np.eye(4, dtype=np.float32))
    assert assoc == {1: obj} and 0 in new_idx


def _pipe(slam_map, **kw):
    dec = tdeepsdf.SphereDecoder(tdeepsdf.make_sphere_params(code_len=CODE))
    cfg = tgn.GNConfig(code_len=CODE, num_iterations=2, pose_only_iterations=3)
    return tpipe.ObjectPipeline(slam_map, dec, cfg, max_detections=4, max_surface_points=64,
                                max_rays=32, extract_meshes=False, **kw)


def _sphere_detection(center, n_pts=64, seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_pts, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    det = make_detection(TDetection, center, n_pts=n_pts)
    det.surface_points = (np.asarray(center, np.float32) + 0.5 * dirs).astype(np.float32)
    return det


def _dynamic_setup(frame0=100, measured=True):
    m = tmap.Map()
    pipe = _pipe(m)
    obj = _obj(tmap, (0.0, 0.0, 10.0), dynamic=True, velocity=[0.5, 0.0, 0.0])
    m.add_object(obj)
    m.n_dynamic_objects = 1
    kf0 = make_kf(tmap)
    kf0.frame_id = frame0
    m.add_keyframe(kf0)
    kf0.object_associations[0] = obj.id
    obj.observations[kf0.id] = 0
    if measured:
        obj.last_measured_kf_id = kf0.id
    pipe.last_kf_frame_id = frame0
    return m, pipe, obj, kf0


def test_fast_mover_stays_associated_across_10_frame_gap():
    m, pipe, obj, kf0 = _dynamic_setup(measured=False)
    kf1 = make_kf(tmap)
    kf1.frame_id = 110
    m.add_keyframe(kf1)
    center = np.array([5.0, 0.0, 10.0], np.float32)
    kf1.detections = [_sphere_detection(center)]
    pending = pipe.dispatch_keyframe(kf1, [kf0.id, kf1.id])
    assert kf1.object_associations.get(0) == obj.id
    pipe.apply_keyframe(kf1, pending)
    np.testing.assert_allclose(obj.T_wo[:3, 3], center, atol=0.15)
    np.testing.assert_allclose(obj.velocity, [0.5, 0.0, 0.0], atol=0.02)
    assert m.n_dynamic_objects == 1 and pipe.dispatches["measure"] == 1


def test_sparse_observation_does_not_stamp_last_measured():
    m, pipe, obj, kf0 = _dynamic_setup()
    kf = make_kf(tmap)
    kf.frame_id = 101
    m.add_keyframe(kf)
    kf.detections = [make_detection(TDetection, [0.5, 0.0, 10.0], n_pts=tassoc.MIN_PTS_ASSOCIATED - 1)]
    pipe.apply_keyframe(kf, pipe.dispatch_keyframe(kf, [kf0.id, kf.id]))
    assert obj.observations.get(kf.id) == 0 and obj.last_measured_kf_id == kf0.id
    np.testing.assert_allclose(obj.T_wo[:3, 3], [0.0, 0.0, 10.0])


def test_dynamic_updates_accumulate_prediction_error():
    m, pipe, obj, kf0 = _dynamic_setup()
    kf = make_kf(tmap)
    kf.frame_id = 101
    m.add_keyframe(kf)
    kf.detections = [_sphere_detection([0.5, 0.0, 10.0])]
    pipe.apply_keyframe(kf, pipe.dispatch_keyframe(kf, [kf0.id, kf.id]))
    assert obj.last_measured_kf_id == kf.id and obj.last_measured_frame_id == 101
    assert len(pipe.dyn_pred_errs) == 1 and pipe.dyn_pred_errs[0] < 0.15


def test_dynamic_object_culled_when_unobserved():
    m = tmap.Map()
    pipe = _pipe(m)
    obj = _obj(tmap, dynamic=True, observations={0: 0})
    m.add_object(obj)
    m.n_dynamic_objects = 1
    kf = make_kf(tmap)
    while kf.id < 3:
        kf = make_kf(tmap)
    m.add_keyframe(kf)
    pipe.apply_keyframe(kf, None)
    assert obj.bad and m.n_dynamic_objects == 0


def test_r3_prediction_horizon_is_the_gap_since_the_last_measurement():
    """Fault R3: the object was measured at frame 100, went unmeasured at
    the keyframe of frame 105, and is seen again at frame 110 where it has
    moved 0.5 m/frame x 10 frames. The prediction (GN warm start, and the
    prediction error the benchmark reports) and the velocity estimate use
    the 10 frames since the measurement. The JAX package uses the 5 frames
    since the previous keyframe: prediction 2.5 m short, velocity doubled."""
    results = {}
    for name, mod, det_cls, make_pipe in (
        ("torch", tmap, TDetection, _pipe),
        ("jax", jmap, JDetection, lambda m: jpipe.ObjectPipeline(
            m, jdeepsdf.sphere_decoder_fn, jdeepsdf.make_sphere_params(code_len=CODE),
            jgn.GNConfig(code_len=CODE, num_iterations=2, pose_only_iterations=3),
            max_detections=4, max_surface_points=64, max_rays=32, extract_meshes=False)),
    ):
        m = mod.Map()
        pipe = make_pipe(m)
        obj = _obj(mod, (0.0, 0.0, 10.0), dynamic=True, velocity=[0.5, 0.0, 0.0])
        m.add_object(obj)
        m.n_dynamic_objects = 1
        kf0 = make_kf(mod)
        kf0.frame_id = 100
        m.add_keyframe(kf0)
        kf0.object_associations[0] = obj.id
        obj.observations[kf0.id] = 0
        obj.last_measured_kf_id = kf0.id
        pipe.last_kf_frame_id = 105          # a keyframe without this object
        kf = make_kf(mod)
        kf.frame_id = 110
        m.add_keyframe(kf)
        center = np.array([5.0, 0.0, 10.0], np.float32)
        det = _sphere_detection(center)
        kf.detections = [det_cls(**{f: getattr(det, f) for f in
                                    ("T_cam_obj", "scale", "box_size", "surface_points")})]
        pipe.apply_keyframe(kf, pipe.dispatch_keyframe(kf, [kf0.id, kf.id]))
        results[name] = (obj, pipe)
    obj, pipe = results["torch"]
    assert pipe.dyn_pred_errs[0] < 0.15                      # predicted 10 frames ahead
    np.testing.assert_allclose(obj.velocity, [0.5, 0.0, 0.0], atol=0.02)
    np.testing.assert_allclose(obj.T_wo[:3, 3], center, atol=0.15)
    assert obj.last_measured_frame_id == 110
    jobj, jp = results["jax"]
    assert jp.dyn_pred_errs[0] > 2.0                         # the reference's 5-frame horizon
    assert jobj.velocity[0] > 0.8


# ---------------------------------------------------------------------------
# one keyframe through both pipelines


def _fields(center, rng, n=120, with_rays=True):
    d = rng.normal(size=(200, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d[(d @ (-center / np.linalg.norm(center))) > 0.1][:n]
    pts = (center + d).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] *= 2.0 * (1 + rng.uniform(-0.05, 0.05))
    T[:3, 3] = center + rng.normal(0, 0.05, 3)
    uv = pts[:, :2] / pts[:, 2:3]
    rays = np.concatenate([uv, np.ones((len(uv), 1))], -1).astype(np.float32)
    bg = (center / np.linalg.norm(center))[None] + rng.normal(0, 0.4, (40, 3))
    bg[:, 2] = np.abs(bg[:, 2]) + 0.5
    bg = (bg / bg[:, 2:3]).astype(np.float32)
    return dict(T_cam_obj=T, scale=2.0, box_size=np.full(3, 2.0, np.float32), surface_points=pts,
                rays=np.concatenate([rays, bg]), depth=pts[:, 2].copy(), num_foreground=len(rays))


@pytest.fixture(scope="module")
def one_keyframe():
    """Keyframe 1 of a map holding one static object seen at keyframe 0:
    its detection associates (pose-only GN + warm-started refine) and two
    new detections reconstruct (joint GN), in both packages."""
    rng = np.random.default_rng(11)
    T_cw = _T((0.3, 0.0, -0.5))
    centers = [np.array([1.0, 0.5, 7.0]), np.array([-2.0, 0.3, 9.0]), np.array([3.0, 0.4, 12.0])]
    fields = [_fields(c, rng) for c in centers]
    cfg = dict(code_len=CODE, k4=0.0, num_iterations=6, pose_only_iterations=5, max_grad_points=128)
    out = {}
    for name, mod, det_cls in (("jax", jmap, JDetection), ("torch", tmap, TDetection)):
        m = mod.Map()
        if name == "jax":
            pipe = jpipe.ObjectPipeline(m, jdeepsdf.sphere_decoder_fn,
                                        jdeepsdf.make_sphere_params(code_len=CODE), jgn.GNConfig(**cfg),
                                        max_detections=4, max_surface_points=128, max_rays=256,
                                        extract_meshes=True, voxels_dim=17)
        else:
            pipe = tpipe.ObjectPipeline(m, tdeepsdf.SphereDecoder(tdeepsdf.make_sphere_params(code_len=CODE)),
                                        tgn.GNConfig(**cfg), max_detections=4, max_surface_points=128,
                                        max_rays=256, extract_meshes=True, voxels_dim=17)
        kf0 = make_kf(mod, _T())
        kf0.frame_id = 0
        m.add_keyframe(kf0)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, :3] *= 2.0
        T_wo[:3, 3] = np.linalg.inv(T_cw)[:3, :3] @ (centers[0] + 0.08) + np.linalg.inv(T_cw)[:3, 3]
        obj = mod.MapObject(T_wo, np.full(CODE, 0.02, np.float32), kf0.id)
        obj.observations[kf0.id] = 0
        kf0.object_associations[0] = obj.id
        m.add_object(obj)
        pipe.last_kf_frame_id = 0
        kf1 = make_kf(mod, T_cw)
        kf1.frame_id = 4
        m.add_keyframe(kf1)
        kf1.detections = [det_cls(**f) for f in fields]
        pipe.apply_keyframe(kf1, pipe.dispatch_keyframe(kf1, [kf0.id, kf1.id]))
        pipe.collect_meshes()
        out[name] = (m, pipe, kf1, obj)
    return out


def test_keyframe_through_pipeline_matches_jax(one_keyframe):
    jm, _, jkf, jobj = one_keyframe["jax"]
    tm, tp, tkf, tobj = one_keyframe["torch"]
    jl = sorted((o for o in jm.objects.values() if not o.bad), key=lambda o: o.T_wo[0, 3])
    tl = sorted((o for o in tm.objects.values() if not o.bad), key=lambda o: o.T_wo[0, 3])
    assert len(tl) == len(jl) == 3
    for a, b in zip(jl, tl):
        assert np.abs(a.T_wo - b.T_wo).max() <= 1e-4
        assert np.abs(a.code - b.code).max() <= 1e-4
        assert b.vertices is not None and len(b.vertices) > 30
    assert np.abs(jkf.detections[0].T_co_se3_measured - tkf.detections[0].T_co_se3_measured).max() <= 1e-4
    assert tobj.n_shape_refinements == jobj.n_shape_refinements == 1
    assert sorted(tkf.object_associations) == sorted(jkf.object_associations) == [0, 1, 2]
    assert tp.dispatches == {"measure": 1, "recon": 1, "refine": 1}
    assert tp.expected_k1_launches() == 5 + 2 * 6 * 2
