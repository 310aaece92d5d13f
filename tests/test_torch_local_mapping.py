"""Local mapping: the cases of tests/test_ba_buckets.py through
dspslam_tpu's LocalMapper and the PyTorch port's (device="cpu"), and the
port's repair of fault R1 (ROADMAP section 3).

The dense window: 3 keyframes 0.4 m apart observing 1300 landmarks at
8-18 m, point estimates with 5 cm noise (one numpy seed). Tolerances: the
port's points within 1e-3 m and poses within 1e-4 of JAX's after the same
local BA (f32 sums in another order over 15 LM steps).
"""

import numpy as np
import pytest
import torch

from dspslam_tpu.slam import local_mapping as jlm
from dspslam_tpu.slam import map as jmap
from dspslam_tpu_torch.slam import local_mapping as tlm
from dspslam_tpu_torch.slam import map as tmap

FX, FY, CX, CY, BF = 500.0, 500.0, 320.0, 240.0, 100.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: with parallel
    test workers, each worker's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bucket_selection():
    assert tlm.ba_point_bucket(1) == 1024
    assert tlm.ba_point_bucket(1024) == 1024
    assert tlm.ba_point_bucket(1025) == 2048
    assert tlm.ba_point_bucket(3500) == 4096
    assert tlm.ba_point_bucket(5000) == 8192
    assert tlm.ba_point_bucket(9000) == 8192     # beyond the last: the cap


def _make_feats(uv, n_slots):
    f = {
        "xy": np.zeros((n_slots, 2), np.float32), "desc": np.zeros((n_slots, 8), np.uint32),
        "angle": np.zeros(n_slots, np.float32), "level": np.zeros(n_slots, np.int32),
        "sigma2": np.ones(n_slots, np.float32), "response": np.zeros(n_slots, np.float32),
        "valid": np.zeros(n_slots, np.float32),
    }
    f["xy"][: len(uv)] = uv
    f["valid"][: len(uv)] = 1.0
    return f


def _world(seed, n_pts, noise):
    rng = np.random.default_rng(seed)
    truth = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-3, 3, n_pts),
                      rng.uniform(8, 18, n_pts)], axis=-1).astype(np.float32)
    return truth, truth + rng.normal(0, noise, truth.shape).astype(np.float32)


def build_window(mod, truth, noisy, n_kf):
    """n_kf keyframes 0.4 m apart observing every landmark (cameras at the
    truth, points noisy). Returns (map, keyframes, point ids)."""
    slam_map = mod.Map()
    kfs = []
    for k in range(n_kf):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -0.4 * k
        pc = truth @ T[:3, :3].T + T[:3, 3]
        u = FX * pc[:, 0] / pc[:, 2] + CX
        v = FY * pc[:, 1] / pc[:, 2] + CY
        frame = mod.Frame(float(k), _make_feats(np.stack([u, v], -1), len(truth)))
        frame.T_cw = T
        kf = mod.KeyFrame(frame)
        kf.u_right = (u - BF / pc[:, 2]).astype(np.float32)
        slam_map.add_keyframe(kf)
        kfs.append(kf)
    pt_ids = []
    for i in range(len(truth)):
        p = mod.MapPoint(noisy[i], np.zeros(8, np.uint32), kfs[0].id)
        slam_map.add_point(p)
        for kf in kfs:
            slam_map.add_observation(p, kf, i)
        pt_ids.append(p.id)
    for kf in kfs:
        slam_map.update_covisibility(kf)
    return slam_map, kfs, pt_ids


def _mean_point_err(slam_map, pt_ids, truth):
    return float(np.mean([np.linalg.norm(slam_map.points[p].position - truth[i])
                          for i, p in enumerate(pt_ids) if p in slam_map.points]))


def _cfg(mod, **kw):
    return mod.LocalMapperConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, **kw)


def _run_ba(mod, slam_map, kf, **kw):
    mapper = mod.LocalMapper(slam_map, _cfg(mod, async_ba=False), **kw)
    pending = mapper.dispatch_bundle_adjust(kf)
    assert pending is not None
    mapper._apply_bundle_adjust(pending)
    return pending


@pytest.fixture(scope="module")
def dense():
    truth, noisy = _world(7, 1300, 0.05)
    out = {}
    for name, mod, kw in (("jax", (jmap, jlm), {}), ("torch", (tmap, tlm), {"device": "cpu"})):
        slam_map, kfs, pt_ids = build_window(mod[0], truth, noisy, 3)
        err_before = _mean_point_err(slam_map, pt_ids, truth)
        pending = _run_ba(mod[1], slam_map, kfs[-1], **kw)
        out[name] = (slam_map, kfs, pt_ids, pending, err_before)
    return truth, out


def test_dense_window_optimizes_all_points(dense):
    truth, out = dense
    slam_map, _, pt_ids, pending, err_before = out["torch"]
    # every point entered the solve: the 2048 bucket holds 1300 points
    assert len(pending["pt_slot"]) == len(pt_ids)
    assert pending["host"]["out"]["points"].shape[0] == 2048
    assert _mean_point_err(slam_map, pt_ids, truth) < 0.35 * err_before


def test_dense_window_matches_jax(dense):
    _, out = dense
    jm, jkfs, jids, _, _ = out["jax"]
    tm, tkfs, tids, _, _ = out["torch"]
    dp = max(np.abs(tm.points[b].position - jm.points[a].position).max() for a, b in zip(jids, tids))
    assert dp <= 1e-3
    for a, b in zip(jkfs, tkfs):
        assert np.abs(a.T_cw - b.T_cw).max() <= 1e-4


def test_hard_cap_diverges_from_uncapped(monkeypatch):
    """One fixed cap below the window's density leaves the weakest points
    unoptimized: the accuracy cliff the buckets remove."""
    truth, noisy = _world(8, 1300, 0.05)
    slam_map, kfs, pt_ids = build_window(tmap, truth, noisy, 3)
    monkeypatch.setattr(tlm, "BA_PT_BUCKETS", (512,))
    monkeypatch.setattr(tlm, "BA_PT_CAP", 512)
    pending = _run_ba(tlm, slam_map, kfs[-1], device="cpu")
    assert len(pending["pt_slot"]) == 512
    err_capped = _mean_point_err(slam_map, pt_ids, truth)

    slam_map2, kfs2, pt_ids2 = build_window(tmap, truth, noisy, 3)
    monkeypatch.setattr(tlm, "BA_PT_BUCKETS", (2048,))
    monkeypatch.setattr(tlm, "BA_PT_CAP", 2048)
    _run_ba(tlm, slam_map2, kfs2[-1], device="cpu")
    assert err_capped > 2.0 * _mean_point_err(slam_map2, pt_ids2, truth)


def _stale_state(mod):
    """Five keyframes over 200 landmarks; keyframe 1 still lists keyframe 3
    in its covisibility while keyframe 3 no longer lists keyframe 1 (the
    JAX package leaves this after a keyframe's re-count drops a partner)."""
    truth, noisy = _world(3, 200, 0.02)
    slam_map, kfs, _ = build_window(mod, truth, noisy, 5)
    kfs[3].covis.pop(kfs[1].id)
    assert kfs[3].id in kfs[1].covis
    return slam_map, kfs


def test_r1_erase_removes_every_covisibility_entry():
    """Fault R1: erasing a keyframe must clear it from every keyframe that
    lists it. The JAX package clears only the keyframes in its own list, and
    the next BA over the stale window raises KeyError (BENCH_r05's
    `KeyError: 48`)."""
    jm, jkfs = _stale_state(jmap)
    jmapper = jlm.LocalMapper(jm, _cfg(jlm, async_ba=False))
    jmapper._erase_keyframe(jkfs[3])
    assert jkfs[3].id in jkfs[1].covis                 # the reference's stale entry
    with pytest.raises(KeyError):
        jmapper.local_bundle_adjust(jkfs[1])

    tm, tkfs = _stale_state(tmap)
    mapper = tlm.LocalMapper(tm, _cfg(tlm, async_ba=False), device="cpu")
    mapper._erase_keyframe(tkfs[3])
    assert all(tkfs[3].id not in kf.covis for kf in tm.keyframes.values())
    assert tkfs[3].id not in tm.local_keyframes(tkfs[1])
    mapper.local_bundle_adjust(tkfs[1])
    assert mapper.ba_log and np.isfinite(tkfs[1].T_cw).all()


def _assert_covisibility_sound(slam_map):
    for kf in slam_map.keyframes.values():
        for other in kf.covis:
            assert other in slam_map.keyframes
            assert kf.id in slam_map.keyframes[other].covis       # symmetric
        assert all(i in slam_map.keyframes for i in slam_map.local_keyframes(kf))


@pytest.mark.parametrize("async_keyframe", [False, True], ids=["sync", "async_keyframe"])
def test_r1_cull_then_process_and_flush(async_keyframe):
    """Keyframe culling during process() erases redundant keyframes; the
    next keyframe's processing and the final flush (which dispatch BA over
    the survivors' windows) run without a KeyError."""
    truth, noisy = _world(4, 300, 0.02)
    slam_map, kfs, _ = build_window(tmap, truth, noisy, 6)
    mapper = tlm.LocalMapper(slam_map, _cfg(tlm, async_keyframe=async_keyframe), device="cpu")
    n_before = len(slam_map.keyframes)
    mapper.process(kfs[4])
    mapper.poll()
    mapper.poll()
    mapper.process(kfs[5])
    mapper.flush()
    assert len(slam_map.keyframes) < n_before                    # culling erased some
    assert all(kf.bad for kf in kfs if kf.id not in slam_map.keyframes)
    _assert_covisibility_sound(slam_map)
    assert mapper.ba_log
