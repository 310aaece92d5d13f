"""Loop closing: dspslam_tpu.place.loop_closing.LoopCloser against the
PyTorch port's `LoopCloser(device="cpu")` on the fabricated maps of
tests/test_loop_closing.py (a drifted out-and-back over a 1 m-cell
landmark world, and its out-back-out-back variant that closes two loops)
and a reduced datasets.street_loop world (street_len=30, 61 keyframes);
tests/test_torch_loop_aliasing.py reuses the helpers here.

Both packages build the same map: the id counters of KeyFrame, MapPoint,
MapObject and Frame start at the same value in both, so that every set and
dict of ids iterates in the same order. `Map.check_invariants()` runs
after every loop correction and every global-BA apply.

Tolerances: the same loops close on the same keyframes; keyframe poses
within 1e-3 after the correction and the essential graph. After the global
BA the poses agree within 5e-2 and the street loop's ATE within 10%: the
GBA fixes one keyframe of a monocular-observation window, so the scale
direction is held only by damping and f32 rounding moves the solution
along it (ROADMAP.md section 3).
"""

import itertools

import numpy as np
import pytest
import torch

import dspslam_tpu.slam.map as jmap
import dspslam_tpu_torch.slam.map as tmap
from dspslam_tpu.place import loop_closing as jlc
from dspslam_tpu.place import vocabulary as jvoc
from dspslam_tpu_torch.place import loop_closing as tlc
from dspslam_tpu_torch.place import vocabulary as tvoc
from torch_threads import one_torch_thread  # noqa: F401

FX = FY = 500.0
CX, CY = 320.0, 240.0
BF = 200.0
PACKAGES = {"jax": (jmap, jlc, jvoc, {}), "torch": (tmap, tlc, tvoc, {"device": "cpu"})}


def _sync_ids(start=50_000):
    """Start both packages' id counters at one value (past any id minted
    before in this process)."""
    mods = (jmap, tmap)
    names = ("KeyFrame", "MapPoint", "MapObject", "Frame")
    start = max([start] + [next(getattr(m, c)._ids) for m in mods for c in names])
    for m in mods:
        for c in names:
            getattr(m, c)._ids = itertools.count(start)


class CheckedCloser:
    """Runs Map.check_invariants() on the port's map after each loop
    correction and global-BA apply."""

    def __init__(self, closer):
        self.closer = closer
        self.checks = 0
        for name in ("_correct_loop", "_apply_global_ba"):
            fn = getattr(closer, name)
            setattr(closer, name, self._wrap(fn))

    def _wrap(self, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            self.closer.map.check_invariants()
            self.checks += 1
            return out
        return run


def _project(T_cw, X):
    pc = X @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    u = FX * pc[:, 0] / np.maximum(z, 1e-6) + CX
    v = FY * pc[:, 1] / np.maximum(z, 1e-6) + CY
    ok = (z > 0.5) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
    return np.stack([u, v], -1), ok


def _feats(uv, desc, n_slots=220):
    f = {
        "xy": np.zeros((n_slots, 2), np.float32), "desc": np.zeros((n_slots, 8), np.uint32),
        "angle": np.zeros(n_slots, np.float32), "level": np.zeros(n_slots, np.int32),
        "sigma2": np.ones(n_slots, np.float32), "response": np.zeros(n_slots, np.float32),
        "valid": np.zeros(n_slots, np.float32),
    }
    n = min(len(uv), n_slots)
    f["xy"][:n], f["desc"][:n], f["valid"][:n] = uv[:n], desc[:n], 1.0
    return f


def _cell_world(seed, x_max=12, per_cell=25):
    rng = np.random.default_rng(seed)
    pos, desc = [], []
    for cell in range(x_max + 3):
        for _ in range(per_cell):
            pos.append(np.array([cell + rng.uniform(0, 1), rng.uniform(-2, 2), rng.uniform(6, 10)],
                                np.float32))
            desc.append(rng.integers(0, 2**32, 8, dtype=np.uint32))
    return np.stack(pos), np.stack(desc)


def _drifted_run(pkg, xs, pass_starts, drift_of, lmk_pos, lmk_desc, online=False, n_slots=220,
                 closer_kwargs=None, voc_seed=1):
    """Build the map keyframe by keyframe (tests/test_loop_closing.py's
    construction: points positioned with the creator's drifted pose,
    association broken at each pass start) and run the loop closer over it:
    after each keyframe when `online` (test_loop_aliasing.py), else over the
    whole map once built (test_loop_closing.py)."""
    M, LC, V, kw = PACKAGES[pkg]
    slam_map = M.Map()
    voc = V.Vocabulary.train(lmk_desc, branching=6, levels=2, seed=voc_seed)
    closer = LC.LoopCloser(slam_map, voc, [FX, FY, CX, CY, BF], fix_scale=True, min_matches=12,
                           **kw, **(closer_kwargs or {}))
    checked = CheckedCloser(closer) if pkg == "torch" else None
    point_of_lmk: dict = {}
    kfs, closed_at, pending, poses_before_gba = [], [], [], []

    def insert(kf, step):
        if closer.insert_keyframe(kf):
            closed_at.append(step)
            pending.append(closer._pending_gba)
            poses_before_gba.append(np.stack([k.T_cw for k in kfs]))
    for step, x in enumerate(xs):
        if step in pass_starts:
            point_of_lmk = {}
        T_true = np.eye(4, dtype=np.float32)
        T_true[0, 3] = -x
        T_est = T_true.copy()
        T_est[0, 3] = -(x + drift_of(step))
        uv, ok = _project(T_true, lmk_pos)
        vis = np.nonzero(ok)[0]
        frame = M.Frame(float(step), _feats(uv[vis], lmk_desc[vis], n_slots))
        frame.T_cw = T_est
        kf = M.KeyFrame(frame)
        slam_map.add_keyframe(kf)
        T_wc_est = np.linalg.inv(T_est)
        for slot, li in enumerate(vis[:n_slots]):
            li = int(li)
            if li in point_of_lmk:
                p = slam_map.points.get(point_of_lmk[li])
                if p is not None:
                    slam_map.add_observation(p, kf, slot)
                continue
            x_cam = T_true[:3, :3] @ lmk_pos[li] + T_true[:3, 3]
            p = M.MapPoint(T_wc_est[:3, :3] @ x_cam + T_wc_est[:3, 3], lmk_desc[li], kf.id)
            slam_map.add_point(p)
            slam_map.add_observation(p, kf, slot)
            point_of_lmk[li] = p.id
        slam_map.update_covisibility(kf)
        kfs.append(kf)
        if online:
            insert(kf, step)
    if not online:
        for step, kf in enumerate(kfs):
            insert(kf, step)
    closer.flush()
    # closed_at: the steps (keyframe indices) that closed a loop
    return closer, kfs, closed_at, pending, poses_before_gba, checked


def test_fabricated_loop_correction_matches_jax():
    lmk_pos, lmk_desc = _cell_world(5)
    xs = list(range(0, 11)) + list(range(9, -1, -1))
    runs = {}
    for pkg in ("jax", "torch"):
        _sync_ids()
        runs[pkg] = _drifted_run(pkg, xs, {11}, lambda s: max(0, s - 10) * 0.06, lmk_pos, lmk_desc)
    (jc, jk, jclosed, _, jpre, _), (tc, tk, tclosed, _, tpre, checked) = runs["jax"], runs["torch"]
    assert tc.loops_closed == jc.loops_closed >= 1 and tclosed == jclosed
    np.testing.assert_allclose(tpre[0], jpre[0], atol=1e-3)
    t_final = np.stack([k.T_cw for k in tk])
    np.testing.assert_allclose(t_final, np.stack([k.T_cw for k in jk]), atol=5e-2)
    assert abs(tk[-1].T_cw[0, 3]) < 0.5 * 10 * 0.06
    assert np.isfinite(t_final).all()
    assert all(np.isfinite(p.position).all() for p in tc.map.points.values())
    assert checked.checks >= 2


def test_global_ba_solves_in_float64(monkeypatch):
    """R6 (ROADMAP.md section 3): the global BA's window of monocular
    observations leaves the scale direction to the LM damping, and in f32
    the card's scatter-add order moved the long loop's ATE after the loop
    from ~6.2 cm to 8-20 cm; the solve runs in float64 (the reference's g2o
    solves in double) and the map keeps f32 poses."""
    seen = []
    real = tlc.ba.global_bundle_adjust

    def spy(kf_poses, *a, **kw):
        seen.append(kf_poses.dtype)
        return real(kf_poses, *a, **kw)

    monkeypatch.setattr(tlc.ba, "global_bundle_adjust", spy)
    lmk_pos, lmk_desc = _cell_world(5)
    xs = list(range(0, 11)) + list(range(9, -1, -1))
    _sync_ids()
    closer, kfs, *_ = _drifted_run("torch", xs, {11}, lambda s: max(0, s - 10) * 0.06, lmk_pos, lmk_desc)
    assert closer.loops_closed >= 1 and seen and all(d == torch.float64 for d in seen)
    assert all(k.T_cw.dtype == np.float32 for k in kfs)
    assert all(p.position.dtype == np.float32 for p in closer.map.points.values())


def test_second_loop_aborts_pending_gba():
    """tests/test_loop_closing.py's out-back-out-back drive with no poll
    between keyframes: the second correction drops the first, stale global
    BA, whose apply is then a guarded no-op."""
    lmk_pos, lmk_desc = _cell_world(5)
    xs = list(range(0, 11)) + list(range(9, -1, -1)) + list(range(1, 11)) + list(range(9, -1, -1))
    steps = {s: 0.05 * max(0, s - 10) for s in range(len(xs))}
    runs = {}
    for pkg in ("jax", "torch"):
        _sync_ids()
        runs[pkg] = _drifted_run(pkg, xs, {11, 21, 31}, steps.get, lmk_pos, lmk_desc)
    jc, jclosed = runs["jax"][0], runs["jax"][2]
    closer, kfs, closed, pending, _, checked = runs["torch"]
    assert closer.loops_closed == jc.loops_closed >= 2 and closed == jclosed
    stale = pending[0]
    assert stale["epoch"] < closer._map_epoch
    poses_now = {k.id: k.T_cw.copy() for k in kfs}
    closer._apply_global_ba(stale)
    for k in kfs:
        np.testing.assert_array_equal(k.T_cw, poses_now[k.id])
    assert all(np.isfinite(k.T_cw).all() for k in kfs)
    assert abs(kfs[-1].T_cw[0, 3]) < 0.75
    assert checked.checks >= 3


def test_reduced_street_loop_matches_jax():
    """The long-loop arm at street_len=30 (61 keyframes)."""
    from dspslam_tpu.datasets.street_loop import StreetLoopWorld as JWorld
    from dspslam_tpu_torch.apps import benchmark_slam

    _sync_ids()
    world = JWorld(street_len=30)
    slam_map, kfs, truth = world.build()
    voc = jvoc.Vocabulary.train(world.lmk_desc, branching=6, levels=2, seed=1)
    closer = jlc.LoopCloser(slam_map, voc, [world.fx, world.fy, world.cx, world.cy, world.fx * 0.4],
                            fix_scale=True, min_matches=12)
    for kf in kfs:
        closer.insert_keyframe(kf)
    closer.flush()
    j_after = float(np.sqrt(np.mean(world.pose_errors(slam_map, kfs, truth) ** 2)))

    _sync_ids()
    rec = benchmark_slam.main_long_loop(type("A", (), {"frames": 0})(), torch.device("cpu"),
                                        street_len=30)
    assert rec["loops_closed"] == closer.loops_closed == 1 and rec["loop_kfs"] == 61
    assert rec["ate_after_loop_cm"] == pytest.approx(j_after * 100, rel=0.1)
