"""Relocalization: dspslam_tpu.slam.relocalization.Relocalizer against the
PyTorch port's, and the port's system recovering after a blackout.

* Parity: the same keyframe map in both packages (tests/test_loop_closing.py's
  1 m-cell landmark world, 25 keyframes along x = 0..12 at the true poses,
  a K=6, L=2 vocabulary, every keyframe in the database), queried by frames
  at x = 4.3 and 9.6 m whose keypoints carry 0.5 px noise. Both packages try
  the same candidates in the same order, succeed on the same keyframe, and
  their poses agree within 1e-3 (f32 GN from the same PnP start).
* tests/test_relocalization.py's blackout (a JAX test marked slow): stereo
  640 x 240 frames of a two-layer world, a map over x = 0..1.2 m, three
  blank frames, then the camera reappears at x = 0.45 m. The port's
  SLAMSystem(device="cpu") with `enable_loop_closing` goes LOST on the
  blank frames and relocalizes at once, within 8 cm of the truth.
"""

import itertools

import numpy as np
import pytest
import torch

import dspslam_tpu.slam.map as jmap
import dspslam_tpu_torch.slam.map as tmap
from dspslam_tpu.place import vocabulary as jvoc
from dspslam_tpu.slam import relocalization as jreloc
from dspslam_tpu_torch.place import vocabulary as tvoc
from dspslam_tpu_torch.slam import relocalization as treloc

FX = FY = 500.0
CX, CY = 320.0, 240.0
INTR = [FX, FY, CX, CY, 200.0]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world():
    rng = np.random.default_rng(5)
    pos = np.stack([np.array([c + rng.uniform(0, 1), rng.uniform(-2, 2), rng.uniform(6, 10)],
                             np.float32) for c in range(15) for _ in range(25)])
    desc = rng.integers(0, 2**32, (len(pos), 8), dtype=np.uint32)
    return pos, desc


def _view(pos, desc, x, noise_rng=None, n_slots=220):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -x
    pc = pos @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    ok = (pc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
    vis = np.nonzero(ok)[0][:n_slots]
    if noise_rng is not None:
        uv = uv + noise_rng.normal(0, 0.5, uv.shape)
    f = {"xy": np.zeros((n_slots, 2), np.float32), "desc": np.zeros((n_slots, 8), np.uint32),
         "angle": np.zeros(n_slots, np.float32), "level": np.zeros(n_slots, np.int32),
         "sigma2": np.ones(n_slots, np.float32), "response": np.zeros(n_slots, np.float32),
         "valid": np.zeros(n_slots, np.float32)}
    n = len(vis)
    f["xy"][:n], f["desc"][:n], f["valid"][:n] = uv[vis], desc[vis], 1.0
    return T, f, vis


def _build(M, V, pos, desc, start):
    for c in ("KeyFrame", "MapPoint", "Frame"):
        getattr(M, c)._ids = itertools.count(start)
    m = M.Map()
    voc = V.Vocabulary.train(desc, branching=6, levels=2, seed=1)
    db = V.KeyFrameDatabase(voc)
    point_of = {}
    for x in np.arange(0.0, 12.5, 0.5):
        T, f, vis = _view(pos, desc, x)
        frame = M.Frame(float(x), f)
        frame.T_cw = T
        kf = M.KeyFrame(frame)
        m.add_keyframe(kf)
        for slot, li in enumerate(vis):
            if li not in point_of:
                p = M.MapPoint(pos[li], desc[li], kf.id)
                m.add_point(p)
                point_of[li] = p
            m.add_observation(point_of[li], kf, slot)
        m.update_covisibility(kf)
        db.add(kf.id, voc.bow_vector(f["desc"], f["valid"]))
    return m, voc, db


@pytest.mark.parametrize("x_query", [4.3, 9.6])
def test_relocalizer_matches_jax(x_query):
    pos, desc = _world()
    start = max(next(c._ids) for M in (jmap, tmap) for c in (M.KeyFrame, M.MapPoint, M.Frame))
    out = {}
    for name, M, V, R, kw in (("jax", jmap, jvoc, jreloc, {}),
                              ("torch", tmap, tvoc, treloc, {"device": "cpu"})):
        m, voc, db = _build(M, V, pos, desc, start)
        reloc = R.Relocalizer(m, voc, db, INTR, **kw)
        tried = []
        solve = reloc._solve_against

        def record(frame, kf, solve=solve, tried=tried):
            ok = solve(frame, kf)
            tried.append((kf.id, ok))
            return ok

        reloc._solve_against = record
        _, f, _ = _view(pos, desc, x_query, np.random.default_rng(3))
        frame = M.Frame(0.0, f)
        assert reloc.try_relocalize(frame)
        out[name] = (tried, frame.T_cw.copy(), frame.map_point_ids.copy())
    (jt, jT, jids), (tt, tT, tids) = out["jax"], out["torch"]
    assert tt == jt and tt[-1][1]
    np.testing.assert_allclose(tT, jT, atol=1e-3)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(-tT[0, 3], x_query, atol=0.05)


def test_system_relocalizes_after_blackout():
    import sys

    sys.path.insert(0, "tests")
    from test_relocalization import BASELINE, BF, CX, CY, FX, FY, H, W, render, textured_world

    from dspslam_tpu_torch.frontend import orb
    from dspslam_tpu_torch.slam.system import SLAMSystem
    from dspslam_tpu_torch.slam.tracking import State, TrackerConfig

    world = textured_world()
    params = orb.ORBParams(n_features=500, n_levels=3)
    cfg = TrackerConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, width=W, height=H, min_init_features=150,
                        max_frames_between_kf=2, search_radius_motion=40.0)
    system = SLAMSystem(tracker_cfg=cfg, orb_params=params, device="cpu")
    descs = []
    for x in (0.0, 0.6, 1.2):
        f = orb.extract(torch.from_numpy(np.ascontiguousarray(render(world, x))), params)
        descs.append(f["desc"].numpy().view(np.uint32)[f["valid"].numpy() > 0])
    voc = tvoc.Vocabulary.train(np.concatenate(descs), branching=6, levels=2)
    system.enable_loop_closing(voc, fix_scale=True)
    assert system.tracker.relocalizer.db is system.loop_closer.db is system.kf_db

    blank = np.zeros((H, W), np.float32)
    k = 0

    def step(img_l, img_r):
        nonlocal k
        system.track_stereo(img_l, img_r, 0.1 * k)
        k += 1

    for x in np.arange(0, 1.21, 0.15):
        step(render(world, x), render(world, x, BASELINE))
    assert system.state == State.OK
    assert len(system.kf_db.vectors) == len(system.map.keyframes) >= 3
    for _ in range(3):
        step(blank, blank)
    assert system.state == State.LOST
    step(render(world, 0.45), render(world, 0.45, BASELINE))
    assert system.state == State.OK, "failed to relocalize"
    for _ in range(2):
        step(render(world, 0.45), render(world, 0.45, BASELINE))
        assert system.state == State.OK
    T_cw = system.tracker.trajectory[-1][1]
    twc = -T_cw[:3, :3].T @ T_cw[:3, 3]
    np.testing.assert_allclose(twc, [0.45, 0.0, 0.0], atol=0.08)
    assert system.loop_closer.loops_closed == 0
    system.map.check_invariants()
