"""Monocular object SLAM as a whole, and the mono composition pin.

dspslam_tpu's SLAMSystem with its MonoObjectPipeline and the PyTorch port's
(device="cpu") over tests/test_mono_objects.py's scene (240 x 640, a
textured radius-0.8 sphere before two depth layers, 26 frames strafing
0.15 m; ORB 800 features, 4 levels; the sphere decoder with code 8, k4 = 0,
8 GN iterations; reconstruction from the 5th keyframe, every 2nd). Both
runs start their entity ids from 0, so the member points' set order is the
same in both.

Checked: the same keyframes and lost flags; T_cw within 5e-3 per frame;
the same number of live objects; each object's member points within 1% of
JAX's; its centre within 1e-3 and its code within 2e-3 (map units); and the
port's own accuracy as test_mono_objects.py checks it (centre within
0.5 R after gauge alignment, a mesh). Found on this CPU: T_cw within
1.2e-3 to 1.6e-3 (the summation order of the run's CPU kernels moves it),
452 member points against 453, centre 2.5e-4 and code 8.3e-4 apart. The
first keyframe after the initialization triangulates one point more (the
port's float64 DLT against JAX's f32 eigh, ROADMAP §3); local BA's f32
solves, summed in another order and with the object's camera-object edges
from the first reconstruction on, carry that on.

The flip test holds the port's one B = 2 GN call over a first
reconstruction's two candidate poses against the JAX package's two calls.
"""

import itertools
import sys

import numpy as np
import pytest

from dspslam_tpu.frontend import orb as jorb
from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu.objects import cuboid as jcuboid
from dspslam_tpu.objects.mono_pipeline import MonoObjectPipeline as JMono
from dspslam_tpu.shape import gn as jgn
from dspslam_tpu.slam import map as jmap
from dspslam_tpu.slam import system as jsystem
from dspslam_tpu.slam import tracking as jtracking
from dspslam_tpu_torch.frontend import orb as torb
from dspslam_tpu_torch.models import deepsdf as tdeepsdf
from dspslam_tpu_torch.objects.detections import Detection as TDetection
from dspslam_tpu_torch.objects import mono_pipeline as tmono
from dspslam_tpu_torch.objects.mono_pipeline import MonoObjectPipeline as TMono
from dspslam_tpu_torch.shape import gn as tgn
from dspslam_tpu_torch.slam import map as tmap
from dspslam_tpu_torch.slam import system as tsystem
from dspslam_tpu_torch.slam import tracking as ttracking
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import test_mono_objects as scene  # noqa: E402

CODE_LEN = 8
GN_KW = dict(code_len=CODE_LEN, k4=0.0, num_iterations=8, max_grad_points=256)
PIPE_KW = dict(max_surface_points=128, max_rays=256, extract_meshes=True, voxels_dim=17,
               warmup_kfs=5, recon_every=2)
DET_FIELDS = ("T_cam_obj", "scale", "box_size", "surface_points", "rays", "depth", "num_foreground",
              "mask", "bbox")


def _port_detection(det):
    return TDetection(**{f: getattr(det, f) for f in DET_FIELDS})


def _restart_ids(map_mod):
    for cls in (map_mod.Frame, map_mod.KeyFrame, map_mod.MapPoint, map_mod.MapObject):
        cls._ids = itertools.count()


@pytest.fixture(scope="module")
def both():
    world = scene.layered_background()
    images = [scene.render(world, k * scene.STEP) for k in range(scene.N_FRAMES)]
    dets = [scene.make_detection(k * scene.STEP) for k in range(scene.N_FRAMES)]

    def config(mod):
        return mod.TrackerConfig(fx=scene.FX, fy=scene.FY, cx=scene.CX, cy=scene.CY, width=scene.W,
                                 height=scene.H, max_frames_between_kf=3, search_radius_motion=40.0)

    def drive(system):
        for k, img in enumerate(images):
            system.track_mono(img, timestamp=k * 0.1)
        system.flush()
        return system

    _restart_ids(jmap)
    js = drive(jsystem.SLAMSystem(
        tracker_cfg=config(jtracking), orb_params=jorb.ORBParams(n_features=800, n_levels=4),
        object_pipeline_factory=lambda m: JMono(m, jdeepsdf.sphere_decoder_fn,
                                                jdeepsdf.make_sphere_params(code_len=CODE_LEN),
                                                jgn.GNConfig(**GN_KW), **PIPE_KW),
        detection_source=lambda i: dets[i]))
    _restart_ids(tmap)
    decoder = tdeepsdf.SphereDecoder(tdeepsdf.make_sphere_params(code_len=CODE_LEN))
    ts = drive(tsystem.SLAMSystem(
        tracker_cfg=config(ttracking), orb_params=torb.ORBParams(n_features=800, n_levels=4),
        object_pipeline_factory=lambda m: TMono(m, decoder, tgn.GNConfig(**GN_KW), **PIPE_KW),
        detection_source=lambda i: [_port_detection(d) for d in dets[i]], device="cpu"))
    return js, ts


def _reconstructed(system):
    return sorted((o for o in system.map.objects.values() if not o.bad and o.has_valid_pose),
                  key=lambda o: o.id)


def test_tracking_matches_jax(both):
    js, ts = both
    assert ts.state.name == js.state.name == "OK"
    assert [kf.seq_idx for _, kf in sorted(ts.map.keyframes.items())] == \
        [kf.seq_idx for _, kf in sorted(js.map.keyframes.items())]
    assert len(ts.tracker.trajectory) == len(js.tracker.trajectory) == scene.N_FRAMES
    for (_, Ta, la), (_, Tb, lb) in zip(js.tracker.trajectory, ts.tracker.trajectory):
        assert la == lb and np.abs(np.asarray(Ta) - Tb).max() <= 5e-3


def test_objects_match_jax(both):
    js, ts = both
    jo, to = _reconstructed(js), _reconstructed(ts)
    assert len(to) == len(jo) >= 1
    assert len([o for o in ts.map.objects.values() if not o.bad]) == \
        len([o for o in js.map.objects.values() if not o.bad])
    for a, b in zip(jo, to):
        assert abs(len(b.point_ids) - len(a.point_ids)) <= 0.01 * len(a.point_ids)
        assert np.abs(b.T_wo[:3, 3] - np.asarray(a.T_wo)[:3, 3]).max() <= 1e-3
        assert np.abs(b.code - np.asarray(a.code)).max() <= 2e-3
        assert abs(b.scale - a.scale) <= 1e-3


def test_object_at_world_pose_with_mesh(both):
    """test_mono_objects.py's accuracy checks on the port."""
    _, ts = both
    obj = max(_reconstructed(ts), key=lambda o: len(o.point_ids))
    s = scene._gauge_scale(ts)
    assert np.linalg.norm(obj.T_wo[:3, 3] / s - scene.SPHERE_C) < 0.5 * scene.SPHERE_R
    r = obj.scale * (0.5 + 0.3 * float(obj.code[0])) / s
    assert 0.5 * scene.SPHERE_R < r < 1.6 * scene.SPHERE_R
    assert obj.vertices is not None and len(obj.vertices) > 0
    pipeline = ts.local_mapper.object_pipeline
    assert pipeline.gn_calls >= 1 and pipeline.gn_batches[0] == 2
    assert pipeline.expected_k1_launches() == 2 * 8 * pipeline.gn_calls


def test_flip_call_picks_jax_candidate():
    """A first reconstruction tries the PCA seed and its 180-degree flip: the
    port's one B = 2 call gives JAX's two calls' losses (within 1e-3
    relative) and poses, and keeps the same candidate. The decoder is
    tests/test_torch_shape.py's small sphere-like network with weight noise
    0.05, so that the two candidates end at different losses."""
    import jax.numpy as jnp
    from test_torch_shape import SMALL, sphere_like_params

    params = sphere_like_params(seed=1, noise=0.05)
    rng = np.random.default_rng(3)
    d = rng.normal(size=(300, 3))
    pts_w = (scene.SPHERE_C + scene.SPHERE_R * d / np.linalg.norm(d, axis=1, keepdims=True)
             + rng.normal(0, 0.02, (300, 3))).astype(np.float32)
    pts_w = pts_w[(pts_w - scene.SPHERE_C)[:, 2] < 0.2]          # the side the camera sees
    det = scene.make_detection(0.3)[0]

    class KF:
        T_cw = np.eye(4, dtype=np.float32)
        T_cw[0, 3] = -0.3

    seed = jcuboid.floor_scale_to_domain(jcuboid.compute_cuboid_pca(pts_w)["T_wo_sim3"], pts_w)
    cands = [seed, jcuboid.flipped_pose(seed)]
    code = np.zeros(CODE_LEN, np.float32)
    jp = JMono(jmap.Map(), jdeepsdf.make_decoder_fn(jdeepsdf.DecoderConfig(**SMALL)),
               {k: [jnp.asarray(a) for a in v] for k, v in params.items()}, jgn.GNConfig(**GN_KW), **PIPE_KW)
    ref = [jp._run_gn(KF, det, pts_w, T, code) for T in cands]
    tp = TMono(tmap.Map(), tdeepsdf.params_from_jax(params, tdeepsdf.DecoderConfig(**SMALL)),
               tgn.GNConfig(**GN_KW), **PIPE_KW)
    out = tp._run_gn(KF, _port_detection(det), pts_w, cands, code)
    assert tp.gn_calls == 1 and tp.gn_batches == [2]
    for r, o in zip(ref, out):
        assert o["is_good"] == r["is_good"]
        assert abs(o["loss"] - r["loss"]) <= 1e-3 * abs(r["loss"])
        assert np.abs(o["t_cam_obj"] - r["t_cam_obj"]).max() <= 1e-3
    j_best = 0 if ref[0]["loss"] <= ref[1]["loss"] else 1
    assert abs(ref[0]["loss"] - ref[1]["loss"]) > 1e-2 * abs(ref[j_best]["loss"])   # a real choice
    assert tmono.best_of(out) is out[j_best]
