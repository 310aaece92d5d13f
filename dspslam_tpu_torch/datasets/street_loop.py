"""Fabricated street-loop map builder for loop-closing benchmarks.

A host numpy copy of dspslam_tpu/datasets/street_loop.py, built on the
port's `slam.map` classes.

Builds the same shape of sequence the reference validates loop closing
on (KITTI-00-style: a long outbound street, a distinct return street,
a revisit of the start only at the very end — BASELINE config 5) as a
keyframe-level map with known ground truth and injected odometry drift:

  * landmarks live in 1 m world cells with persistent descriptors, so
    the revisit sees the SAME content it saw outbound (what BoW place
    recognition keys on);
  * the estimated poses carry linearly accumulating drift; on the
    revisit the drift has broken data association, so revisited
    landmarks mint NEW map points — exactly the condition that makes a
    loop closure necessary (LoopClosing.cc:60-120 operates on such a
    drifted map).

Used by apps/benchmark_slam.py --long_loop (the loop-gain number).
"""

from __future__ import annotations

import numpy as np

from ..slam.map import Frame, KeyFrame, Map, MapPoint

N_LMK_PER_CELL = 25
FEAT_SLOTS = 220


def _make_feats(uv, desc, n_slots=FEAT_SLOTS):
    f = {
        "xy": np.zeros((n_slots, 2), np.float32),
        "desc": np.zeros((n_slots, 8), np.uint32),
        "angle": np.zeros(n_slots, np.float32),
        "level": np.zeros(n_slots, np.int32),
        "sigma2": np.ones(n_slots, np.float32),
        "response": np.zeros(n_slots, np.float32),
        "valid": np.zeros(n_slots, np.float32),
    }
    n = min(len(uv), n_slots)
    f["xy"][:n] = uv[:n]
    f["desc"][:n] = desc[:n]
    f["valid"][:n] = 1.0
    return f


class StreetLoopWorld:
    """Two parallel streets of `street_len` one-meter cells; street A is
    traversed outbound, street B on the return, street A again for the
    final `revisit_len` keyframes. One keyframe per meter of travel."""

    def __init__(self, street_len=100, revisit_len=6, drift_rate=0.01,
                 intrinsics=(500.0, 500.0, 320.0, 240.0),
                 image_wh=(640, 480), seed=11):
        self.street_len = street_len
        self.revisit_len = revisit_len
        self.drift_rate = drift_rate
        self.fx, self.fy, self.cx, self.cy = intrinsics
        self.w, self.h = image_wh
        rng = np.random.default_rng(seed)
        pos, desc = [], []
        # cells 0..street_len+3 = street A; the rest = street B (same
        # geometry band, fresh descriptors -> no cross-street matches)
        self.n_cells_per_street = street_len + 4
        for cell in range(2 * self.n_cells_per_street):
            x_base = float(cell % self.n_cells_per_street)
            for _ in range(N_LMK_PER_CELL):
                pos.append(np.array(
                    [x_base + rng.uniform(0, 1), rng.uniform(-2, 2),
                     rng.uniform(6, 10)], np.float32))
                desc.append(rng.integers(0, 2 ** 32, 8, dtype=np.uint32))
        self.lmk_pos = np.stack(pos)
        self.lmk_desc = np.stack(desc)

    def _project(self, T_cw, X):
        pc = X @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = pc[:, 2]
        u = self.fx * pc[:, 0] / z + self.cx
        v = self.fy * pc[:, 1] / z + self.cy
        ok = (z > 0.5) & (u > 0) & (u < self.w) & (v > 0) & (v < self.h)
        return np.stack([u, v], -1), ok

    def _cells(self, street, x):
        c0 = max(int(x), 0)
        base = street * self.n_cells_per_street
        out = []
        for c in range(c0, min(c0 + 4, self.n_cells_per_street)):
            li0 = (base + c) * N_LMK_PER_CELL
            out.extend(range(li0, li0 + N_LMK_PER_CELL))
        return out

    def _make_kf(self, slam_map, step, x_true, groups):
        drift = step * self.drift_rate
        T_true = np.eye(4, dtype=np.float32)
        T_true[0, 3] = -x_true
        T_est = np.eye(4, dtype=np.float32)
        T_est[0, 3] = -(x_true + drift)
        vis_all, dict_of = [], []
        for cells, pdict in groups:
            vis = np.asarray(cells, np.int64)
            _, ok = self._project(T_true, self.lmk_pos[vis])
            for li in vis[ok]:
                vis_all.append(int(li))
                dict_of.append(pdict)
        idx = np.asarray(vis_all, np.int64)
        uv_true, _ = self._project(T_true, self.lmk_pos[idx])
        frame = Frame(float(step), _make_feats(uv_true, self.lmk_desc[idx]))
        frame.T_cw = T_est
        kf = KeyFrame(frame)
        slam_map.add_keyframe(kf)
        T_wc_est = np.linalg.inv(T_est)
        for slot, (li, pdict) in enumerate(
                zip(vis_all[:FEAT_SLOTS], dict_of[:FEAT_SLOTS])):
            if li in pdict:
                p = slam_map.points.get(pdict[li])
                if p is not None:
                    slam_map.add_observation(p, kf, slot)
                continue
            x_cam = T_true[:3, :3] @ self.lmk_pos[li] + T_true[:3, 3]
            x_world_est = T_wc_est[:3, :3] @ x_cam + T_wc_est[:3, 3]
            p = MapPoint(x_world_est, self.lmk_desc[li], kf.id)
            slam_map.add_point(p)
            slam_map.add_observation(p, kf, slot)
            pdict[li] = p.id
        slam_map.update_covisibility(kf)
        return kf

    def build(self):
        """Returns (slam_map, kfs, truth_x): one drifted keyframe per
        meter — outbound street A, return street B, final street-A
        revisit with drift-broken association (fresh point dict)."""
        slam_map = Map()
        point_of_lmk: dict[int, int] = {}
        revisit_points: dict[int, int] = {}
        kfs, truth = [], []
        L = self.street_len
        # outbound along street A; near the turnaround street B's
        # junction landmarks come into view too (graph continuity)
        for step in range(L + 1):
            groups = [(self._cells(0, step), point_of_lmk)]
            if step >= L - 2:
                groups.append((self._cells(1, step), point_of_lmk))
            kfs.append(self._make_kf(slam_map, step, float(step), groups))
            truth.append(float(step))
        # return along street B (fresh points); approaching the revisit
        # junction street A re-enters view with a FRESH dict
        for step in range(L + 1, 2 * L + 1 - self.revisit_len):
            x_true = float(2 * L + 1 - step)
            groups = [(self._cells(1, x_true), point_of_lmk)]
            if x_true <= self.revisit_len + 3:
                groups.append((self._cells(0, x_true), revisit_points))
            kfs.append(self._make_kf(slam_map, step, x_true, groups))
            truth.append(x_true)
        # final revisit purely on street A
        for step in range(2 * L + 1 - self.revisit_len, 2 * L + 1):
            x_true = float(2 * L + 1 - step)
            kfs.append(self._make_kf(
                slam_map, step, x_true,
                [(self._cells(0, x_true), revisit_points)]))
            truth.append(x_true)
        return slam_map, kfs, np.asarray(truth, np.float64)

    def pose_errors(self, slam_map, kfs, truth):
        """Per-keyframe |estimated x - true x| for live keyframes."""
        return np.asarray([
            abs(-kf.T_cw[0, 3] - truth[i])
            for i, kf in enumerate(kfs) if kf.id in slam_map.keyframes
        ])
