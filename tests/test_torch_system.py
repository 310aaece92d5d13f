"""Object-aware stereo SLAM as a whole: dspslam_tpu's SLAMSystem and the
PyTorch port's SLAMSystem(device="cpu") over tests/test_slam_objects.py's
scene (240 x 640, a far plane and near posts, two radius-1 spheres, 8 frames
dollying 0.15 m; ORB 600 features, 4 levels; the sphere decoder with code 8,
k4 = 0, 8 GN iterations), fed the same seeded detections.

Checked: the same keyframes (by the frame that made them); T_cw within 1e-3
per frame (f32 pose GN and local BA whose sums run in another order, feeding
discrete inlier decisions); the same number of live objects, each T_wo
within 1e-2 m of JAX's; `save_map`'s three files parse; and the port's own
accuracy: objects within 0.35 m of a true sphere centre
(test_slam_objects.py:205).
"""

import os

import numpy as np
import pytest
import torch

from dspslam_tpu.frontend import orb as jorb
from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu.objects.detections import Detection as JDetection
from dspslam_tpu.objects.pipeline import ObjectPipeline as JPipeline
from dspslam_tpu.shape import gn as jgn
from dspslam_tpu.slam import system as jsystem
from dspslam_tpu.slam import tracking as jtracking
from dspslam_tpu_torch.frontend import orb as torb
from dspslam_tpu_torch.models import deepsdf as tdeepsdf
from dspslam_tpu_torch.objects.detections import Detection as TDetection
from dspslam_tpu_torch.objects.pipeline import ObjectPipeline as TPipeline
from dspslam_tpu_torch.shape import gn as tgn
from dspslam_tpu_torch.slam import system as tsystem
from dspslam_tpu_torch.slam import tracking as ttracking

FX = FY = 500.0
CX, CY = 320.0, 120.0
BASELINE = 0.4
H, W = 240, 640
PLANE_Z, NEAR_Z = 10.0, 5.0
CODE_LEN = 8
SPHERES_W = np.array([[1.0, 0.6, 6.0], [2.5, 0.4, 7.5]], np.float32)
RADIUS = 1.0
STEP = 0.15
N_FRAMES = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: with parallel
    test workers, each worker's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def textured_world(seed=0):
    rng = np.random.default_rng(seed)
    far = rng.normal(80, 10, (H, 3 * W)).astype(np.float32)
    for _ in range(350):
        y, x = rng.integers(10, H - 20), rng.integers(10, 3 * W - 20)
        s = rng.integers(4, 12)
        far[y: y + s, x: x + s] = rng.uniform(150, 230)
    near = np.full((H, 6 * W), np.nan, np.float32)
    for _ in range(220):
        y, x = rng.integers(10, H - 30), rng.integers(10, 6 * W - 30)
        s = rng.integers(6, 14)
        near[y: y + s, x: x + s] = rng.uniform(40, 250)
    return far, near


def render(world, cam_x, baseline_m=0.0):
    far, near = world
    sf = int(round(FX * (cam_x + baseline_m) / PLANE_Z))
    sn = int(round(FX * (cam_x + baseline_m) / NEAR_Z))
    img = far[:, W + sf: 2 * W + sf].copy()
    crop = near[:, W + sn: W + sn + W]
    m = ~np.isnan(crop)
    img[m] = crop[m]
    return img


def detection_fields(cam_x, rng):
    """test_slam_objects.make_detections as constructor fields."""
    out = []
    for c_w in SPHERES_W:
        c = c_w - np.array([cam_x, 0, 0], np.float32)
        d = rng.normal(size=(160, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = d[(d @ (-c / np.linalg.norm(c))) > 0.1][:120]
        pts = (c + RADIUS * d).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] *= 2.0 * (1 + rng.uniform(-0.05, 0.05))
        T[:3, 3] = c + rng.normal(0, 0.05, 3)
        uv = pts[:, :2] / pts[:, 2:3]
        rays = np.concatenate([uv, np.ones((len(uv), 1))], -1).astype(np.float32)
        bg_dir = (c / np.linalg.norm(c))[None, :] + rng.normal(0, 0.35, (60, 3))
        bg_dir[:, 2] = np.abs(bg_dir[:, 2]) + 0.5
        bg = (bg_dir / bg_dir[:, 2:3]).astype(np.float32)
        bg = bg[np.linalg.norm(np.cross(bg / np.linalg.norm(bg, axis=-1, keepdims=True), c),
                               axis=-1) > RADIUS * 1.15][:40]
        out.append(dict(T_cam_obj=T, scale=2.0, box_size=np.full(3, 2.0, np.float32),
                        surface_points=pts, rays=np.concatenate([rays, bg]),
                        depth=pts[:, 2].astype(np.float32), num_foreground=len(rays)))
    return out


def _config(mod):
    return mod.TrackerConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=FX * BASELINE, width=W, height=H,
                             min_init_features=150, max_frames_between_kf=4)


def _drive(system, images):
    for k, (l, r) in enumerate(images):
        system.track_stereo(l, r, timestamp=k * 0.1)
    system.flush()
    return system


def parse_map_objects(path):
    lines = open(path).read().split("\n")
    out = []
    for i in range(0, len([ln for ln in lines if ln.strip()]), 3):
        Two = np.eye(4)
        Two[:3] = np.array(lines[i + 1].split(), float).reshape(3, 4)
        out.append((int(lines[i]), Two, np.array(lines[i + 2].split(), float)))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    world = textured_world()
    images = [(render(world, k * STEP), render(world, k * STEP, BASELINE)) for k in range(N_FRAMES)]
    rng = np.random.default_rng(9)
    fields = [detection_fields(k * STEP, rng) for k in range(N_FRAMES)]

    def jfactory(slam_map):
        return JPipeline(slam_map, jdeepsdf.sphere_decoder_fn, jdeepsdf.make_sphere_params(code_len=CODE_LEN),
                         jgn.GNConfig(code_len=CODE_LEN, k4=0.0, num_iterations=8, max_grad_points=256),
                         max_detections=4, max_surface_points=128, max_rays=256,
                         extract_meshes=True, voxels_dim=17)

    def tfactory(slam_map):
        dec = tdeepsdf.SphereDecoder(tdeepsdf.make_sphere_params(code_len=CODE_LEN))
        return TPipeline(slam_map, dec,
                         tgn.GNConfig(code_len=CODE_LEN, k4=0.0, num_iterations=8, max_grad_points=256),
                         max_detections=4, max_surface_points=128, max_rays=256,
                         extract_meshes=True, voxels_dim=17)

    js = _drive(jsystem.SLAMSystem(
        tracker_cfg=_config(jtracking), orb_params=jorb.ORBParams(n_features=600, n_levels=4),
        object_pipeline_factory=jfactory,
        detection_source=lambda i: [JDetection(**f) for f in fields[i]]), images)
    ts = _drive(tsystem.SLAMSystem(
        tracker_cfg=_config(ttracking), orb_params=torb.ORBParams(n_features=600, n_levels=4),
        object_pipeline_factory=tfactory,
        detection_source=lambda i: [TDetection(**f) for f in fields[i]], device="cpu"), images)
    out = tmp_path_factory.mktemp("torch_system_map")
    ts.save_map(str(out))
    return js, ts, str(out)


def _live(system):
    return [o for o in system.map.objects.values() if not o.bad]


def test_same_keyframes_and_states(both):
    js, ts, _ = both
    assert ts.state.name == js.state.name == "OK"
    assert [kf.seq_idx for _, kf in sorted(ts.map.keyframes.items())] == \
        [kf.seq_idx for _, kf in sorted(js.map.keyframes.items())]
    assert [l for _, _, l in ts.tracker.trajectory] == [l for _, _, l in js.tracker.trajectory]


def test_poses_match_jax(both):
    js, ts, _ = both
    assert len(ts.tracker.trajectory) == len(js.tracker.trajectory) == N_FRAMES
    for (ta, Ta, _), (tb, Tb, _) in zip(js.tracker.trajectory, ts.tracker.trajectory):
        assert ta == tb
        assert np.abs(np.asarray(Ta) - Tb).max() <= 1e-3


def test_objects_match_jax(both):
    js, ts, _ = both
    jo, to = _live(js), _live(ts)
    assert len(to) == len(jo) >= 1
    for o in to:
        d = min(np.linalg.norm(o.T_wo[:3, 3] - p.T_wo[:3, 3]) for p in jo)
        assert d <= 1e-2, d
        # test_slam_objects.py:205: within 0.35 m of a true sphere centre
        assert np.linalg.norm(SPHERES_W - o.T_wo[:3, 3], axis=-1).min() < 0.35
        assert o.vertices is not None and len(o.vertices) > 30


def test_local_ba_ran_with_object_edges(both):
    _, ts, _ = both
    log = ts.local_mapper.ba_log
    assert log and all(r["device_ms"] is None for r in log)
    assert max(r["n_edges"] for r in log) >= 1


def test_save_map_files_parse(both):
    _, ts, out = both
    pts = np.loadtxt(os.path.join(out, "MapPoints.txt")).reshape(-1, 3)
    assert len(pts) == sum(not p.bad for p in ts.map.points.values()) > 100
    cams = np.loadtxt(os.path.join(out, "Cameras.txt")).reshape(-1, 3, 4)
    assert cams.shape[0] == N_FRAMES
    np.testing.assert_allclose(cams[-1, 0, 3], (N_FRAMES - 1) * STEP, atol=0.05)
    objs = parse_map_objects(os.path.join(out, "MapObjects.txt"))
    assert len(objs) == sum(not o.dynamic for o in _live(ts))
    for obj_id, Two, code in objs:
        assert obj_id in ts.map.objects and code.shape == (CODE_LEN,)
        np.testing.assert_allclose(Two, ts.map.objects[obj_id].T_wo, atol=1e-6)


def test_system_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tsystem.SLAMSystem()


def test_unported_modes_raise():
    """Loop closing and relocalization are ported (slice 5): they attach,
    and the relocalizer and the loop closer share one keyframe database."""
    from dspslam_tpu_torch.place.vocabulary import Vocabulary

    voc = Vocabulary.train(np.random.default_rng(0).integers(0, 2**32, (300, 8), dtype=np.uint32),
                           branching=4, levels=2)
    s = tsystem.SLAMSystem(device="cpu")
    s.attach_vocabulary(voc)
    assert s.tracker.relocalizer is not None and s.loop_closer is None
    s.enable_loop_closing(voc)
    assert s.loop_closer.db is s.kf_db is s.tracker.relocalizer.db
    assert s.map.keyframe_erase_hooks == [s.kf_db.erase]


def test_localization_mode_adds_no_keyframes():
    """System::ActivateLocalizationMode: tracking goes on against the frozen
    map, and no keyframe (nor map point) is added until it is deactivated."""
    world = textured_world()
    images = [(render(world, k * STEP), render(world, k * STEP, BASELINE)) for k in range(N_FRAMES)]
    s = tsystem.SLAMSystem(tracker_cfg=_config(ttracking), device="cpu",
                           orb_params=torb.ORBParams(n_features=600, n_levels=4))
    for k in range(3):
        s.track_stereo(*images[k], timestamp=k * 0.1)
    s.activate_localization_mode()
    n_kf, n_pts = len(s.map.keyframes), len(s.map.points)
    for k in range(3, N_FRAMES):
        s.track_stereo(*images[k], timestamp=k * 0.1)
    assert s.state.name == "OK" and not any(lost for _, _, lost in s.tracker.trajectory)
    assert (len(s.map.keyframes), len(s.map.points)) == (n_kf, n_pts)
    s.deactivate_localization_mode()
    s.track_stereo(*images[-1], timestamp=N_FRAMES * 0.1)
    assert len(s.map.keyframes) == n_kf + 1      # max_frames_between_kf = 4 has passed
