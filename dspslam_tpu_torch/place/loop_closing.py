"""Loop closing with objects: detect -> Sim(3) -> correct -> pose graph -> GBA.

Port of dspslam_tpu/place/loop_closing.py, the host orchestration of the
reference's LoopClosing thread (reference src/LoopClosing.cc +
LoopClosing_util.cc). The descriptor matching, the Sim(3) refinement, the
pose graph and the global BA run on the loop closer's device; the map
bookkeeping stays on the host:

* DetectLoop: BoW candidates above the covisible-minimum score, required
  to persist over `consistency` consecutive keyframes (LoopClosing.cc:
  113-239's covisibility-consistency groups, simplified to candidate-id
  persistence);
* ComputeSim3: brute-force descriptor matching between the two keyframes'
  map points, Horn RANSAC (fixed scale for stereo), acceptance by inlier
  count (Sim3Solver RANSAC + OptimizeSim3 of the reference);
* CorrectLoopWithObjects: propagate the corrected Sim(3) through the
  current keyframe's covisibility group, moving keyframes, map points
  AND map objects (LoopClosing_util.cc:69-152), fuse duplicate objects
  by centroid distance (SearchAndFuseObjects, <2 m replace,
  LoopClosing_util.cc:221-293), then optimize the essential graph and
  run a global joint BA (RunGlobalJointBundleAdjustment).

The global BA is dispatched without a host sync and its results stream
back through pinned copies (`tracking._prefetch_to_host`); `poll()`
applies them one frame later, or `flush()` at once, and a solve stamped
with an older correction epoch is never written back.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..backend import ba, pose_graph
from ..frontend import matcher
from ..slam.map import Map, entry_device, to_torch
from ..slam.tracking import _host_result, _prefetch_to_host
from . import sim3 as sim3_mod
from .vocabulary import KeyFrameDatabase, Vocabulary

log = logging.getLogger(__name__)

GBA_KF_CAP = 64
GBA_PT_CAP = 4096
GBA_OBS_CAP = 16384
GBA_OBJ_CAP = 16
GBA_EDGE_CAP = 64
# The global BA solves in float64 (the reference's g2o solves in double): a
# window of monocular observations with one keyframe held leaves the scale
# direction to the LM damping, and f32 rounding (the order of the card's
# scatter-adds) moved the solution along it by centimetres (ROADMAP R6)
GBA_DTYPE = torch.float64
# essential-graph scale: the reference optimizes ALL keyframes
# (Optimizer.cc:780); 2048 Sim(3) vertices covers KITTI-00 (~1.3k KFs).
# Above PG_DENSE_MAX vertices the solve switches from the dense-normal-
# equations LM to the matrix-free CG LM (backend/pose_graph.py).
PG_KF_CAP = 2048
PG_DENSE_MAX = 256
PG_EDGE_CAP = 4096
OBJ_FUSE_DIST = 2.0
# loop-detection score gates (see LoopCloser._detect for derivation)
MIN_SCORE_NO_COVIS = 0.3
MIN_SCORE_FLOOR = 0.05


def _inv_sim3_np(S: np.ndarray) -> np.ndarray:
    """Host-side Sim(3) inverse: [sR t]^-1 = [(1/s)R^T/s, -(R^T/s²)t]."""
    sR = S[:3, :3]
    s2 = float(np.linalg.det(sR)) ** (2.0 / 3.0)
    Rt_over_s = sR.T / s2                       # (sR)^-1 = R^T / s
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = Rt_over_s
    out[:3, 3] = -Rt_over_s @ S[:3, 3]
    return out


def _next_pow2(n: int, lo: int, hi: int) -> int:
    k = lo
    while k < min(n, hi):
        k *= 2
    return min(k, hi)


class LoopCloser:
    def __init__(
        self,
        slam_map: Map,
        voc: Vocabulary,
        intrinsics,
        fix_scale: bool = True,
        consistency: int = 3,
        min_matches: int = 15,
        db: KeyFrameDatabase | None = None,
        min_total_matches: int | None = None,
        device=None,
    ):
        self.map = slam_map
        self.device = entry_device(device, "LoopCloser")
        self.voc = voc
        # shared with the system-level relocalizer when provided
        self.db = db if db is not None else KeyFrameDatabase(voc)
        self.intrinsics_np = np.asarray(intrinsics, np.float32)
        self.intrinsics = torch.from_numpy(self.intrinsics_np.copy()).to(self.device)
        self.fix_scale = fix_scale
        self.consistency = consistency
        self.min_matches = min_matches
        # acceptance needs this many CURRENT-KF keypoints matched to the
        # loop NEIGHBORHOOD's map points under the corrected pose — the
        # reference requires 40 vs its 20 Sim3 inliers (LoopClosing.cc:
        # 389-401), so default to the same 2x proportion of min_matches
        self.min_total_matches = (
            min_total_matches if min_total_matches is not None
            else 2 * min_matches
        )
        self.last_loop_kf_id = -1
        # covisibility-consistency groups (LoopClosing.cc:165-220):
        # list of (frozenset of kf ids, consistency count)
        self._consistent_groups: list[tuple[frozenset, int]] = []
        self.loops_closed = 0
        # global BA runs in the background of subsequent frames (the
        # reference backgrounds it on a thread, LoopClosing_util.cc:213):
        # dispatched at loop closure, applied by poll()/flush()
        self._pending_gba = None
        self._gba_skip = 0
        # correction epoch: bumped by every loop correction; a pending
        # GBA stamped with an older epoch was solved from poses the
        # correction rewrote and must never be applied (the reference's
        # mbStopGBA abort, LoopClosing_util.cc:32-50)
        self._map_epoch = 0

    # ------------------------------------------------------------------
    def insert_keyframe(self, kf) -> bool:
        """Returns True if a loop was closed on this keyframe."""
        bow = self.voc.bow_vector(kf.feats_torch(self.device)["desc"], kf.feats["valid"])
        kf.bow = bow
        closed = False
        for cand in self._detect(kf, bow):
            result = self._compute_sim3(kf, cand)
            if result is not None:
                S_cw_corr, loop_kf = result
                self._correct_loop(kf, loop_kf, S_cw_corr)
                closed = True
                self.loops_closed += 1
                self.last_loop_kf_id = kf.id
                break
        self.db.add(kf.id, bow)
        return closed

    # ------------------------------------------------------------------
    def _detect(self, kf, bow):
        """Covisibility-consistency loop detection (LoopClosing.cc:
        113-239): each candidate expands to its covisibility group; a
        group is consistent with a previous keyframe's group when they
        share a keyframe, each previous group extends at most ONE
        current group (the reference's vbConsistentGroup dedup), and a
        candidate is returned once its chain of group-consistent
        detections reaches `consistency` consecutive keyframes. Returns
        the list of enough-consistent candidate keyframes (possibly
        empty)."""
        if kf.id < self.last_loop_kf_id + 10 or len(self.db.vectors) < 5:
            self._consistent_groups = []
            return []
        neighbors = set(kf.covis) | {kf.id}
        # the reference's gate: candidates must score at least the WORST
        # covisible neighbour (LoopClosing.cc:141-159 minScore) — a
        # same-place match should look at least as similar as a
        # physically adjacent view. Two guards replace reference
        # behaviour that our init order can't reproduce:
        #  * no covisible BoW yet (first KFs) -> MIN_SCORE_NO_COVIS,
        #    deliberately high: with nothing to calibrate against,
        #    detection should effectively wait;
        #  * degenerate covisible minimum (a neighbour sharing almost no
        #    words scores ~0, which would accept everything) ->
        #    MIN_SCORE_FLOOR. Calibrated against the 300-KF
        #    self-similar-street precision test (test_vocab_scale.py):
        #    distinct-place scores there stay below it while true
        #    revisits score an order of magnitude above.
        min_score = min(
            (
                Vocabulary.score(bow, self.map.keyframes[n].bow)
                for n in kf.covis
                if n in self.map.keyframes
                and self.map.keyframes[n].bow is not None
            ),
            default=MIN_SCORE_NO_COVIS,
        )
        cands = self.db.query(
            bow, max(min_score, MIN_SCORE_FLOOR), exclude=neighbors
        )
        if not cands:
            # no candidates resets the chains (LoopClosing.cc:157-160)
            self._consistent_groups = []
            return []
        new_groups: list[tuple[frozenset, int]] = []
        used_prev = [False] * len(self._consistent_groups)
        enough: list = []
        for cand_id, _score in cands[:10]:
            cand_kf = self.map.keyframes.get(cand_id)
            if cand_kf is None or cand_kf.bad:
                continue
            group = frozenset(cand_kf.covis) | {cand_id}
            consistent_some = False
            enough_this = False
            for iG, (prev_set, prev_n) in enumerate(self._consistent_groups):
                if group & prev_set:
                    consistent_some = True
                    n_cur = prev_n + 1
                    if not used_prev[iG]:
                        new_groups.append((group, n_cur))
                        used_prev[iG] = True
                    if n_cur >= self.consistency and not enough_this:
                        enough.append(cand_kf)
                        enough_this = True
            if not consistent_some:
                new_groups.append((group, 0))
        self._consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    def _compute_sim3(self, kf, cand_kf):
        """Sim(3) hypothesis + the reference's two geometric acceptance
        stages: Horn RANSAC on matched 3D pairs (Sim3Solver), then a
        mutual-reprojection GN refinement whose both-directions chi2
        inlier count must reach min_matches (OptimizeSim3,
        Optimizer.cc:1045-1180), then a neighborhood projection gate —
        the loop keyframe's covisibility-group map points projected into
        the current keyframe under the corrected pose must yield
        min_total_matches descriptor matches (SearchByProjection + the
        nTotalMatches>=40 gate, LoopClosing.cc:370-401). The last two
        stages are what candidate persistence + Horn alone cannot give:
        perceptual aliasing with locally-identical structure passes
        RANSAC but fails the neighborhood gate."""
        idx, _ = matcher.match_features(
            kf.feats_torch(self.device), cand_kf.feats_torch(self.device),
            max_dist=matcher.TH_LOW,
        )
        idx = idx.cpu().numpy()
        p_cur, p_cand, uv_cur, uv_cand = [], [], [], []
        for i in np.nonzero(idx >= 0)[0]:
            pid_cur = kf.map_point_ids[i]
            pid_cand = cand_kf.map_point_ids[idx[i]]
            if pid_cur < 0 or pid_cand < 0:
                continue
            pc = self.map.points.get(int(pid_cur))
            pm = self.map.points.get(int(pid_cand))
            if pc is None or pm is None or pc.bad or pm.bad:
                continue
            x_cur = kf.T_cw[:3, :3] @ pc.position + kf.T_cw[:3, 3]
            x_cand = cand_kf.T_cw[:3, :3] @ pm.position + cand_kf.T_cw[:3, 3]
            p_cur.append(x_cur)
            p_cand.append(x_cand)
            uv_cur.append(kf.feats["xy"][i])
            uv_cand.append(cand_kf.feats["xy"][idx[i]])
        if len(p_cur) < self.min_matches:
            return None
        S_12, inliers = sim3_mod.ransac_sim3(
            np.asarray(p_cur), np.asarray(p_cand), self.fix_scale,
            min_inliers=self.min_matches,
        )
        if S_12 is None:
            return None
        # mutual-reprojection refinement over ALL matched pairs, seeded
        # by the RANSAC fit; inliers must hold in BOTH directions. Used
        # as the ACCEPTANCE GATE only: the propagated correction keeps
        # Horn's inlier-refit pose. The reference propagates
        # OptimizeSim3's pose because its Sim3Solver fits just 3 points;
        # our Horn refit already uses every 3D inlier (metrically
        # optimal under the map), and the map, not the stale pixel
        # observations, is the authority the essential graph + GBA
        # propagate — a 201-KF A/B measured the reprojection-refined
        # pose WORSE by 0.04 m / 0.14 deg at the anchor, which the
        # 100-KF lever arm amplified to meters of far-tail error.
        _, _, n_inl, chi2_th = sim3_mod.refine_sim3_reproj(
            S_12, np.asarray(p_cur), np.asarray(p_cand),
            np.asarray(uv_cur), np.asarray(uv_cand),
            fix_scale=self.fix_scale, intrinsics=self.intrinsics_np[:4],
            device=self.device,
        )
        if n_inl < self.min_matches:
            return None
        # corrected current pose: world -> cand cam -> current cam
        S_cw_corr = (S_12 @ cand_kf.T_cw).astype(np.float32)
        # the projection search radius carries the refinement's measured
        # consistency tolerance (sqrt of the adaptive chi2 gate),
        # quantized to multiples of the reference's 10 px
        radius = 10.0 * float(np.ceil(np.sqrt(chi2_th) / 10.0))
        if self._neighborhood_matches(kf, cand_kf, S_cw_corr, radius) \
                < self.min_total_matches:
            return None
        return S_cw_corr, cand_kf

    # loop-neighborhood projection gate cap (fixed shape)
    NEIGH_PT_CAP = 2048

    def _neighborhood_matches(self, kf, loop_kf, S_cw_corr,
                              radius: float = 10.0) -> int:
        """Count current-KF keypoints matched by descriptor to the loop
        keyframe's covisibility-group map points projected under the
        corrected pose (ORBmatcher::SearchByProjection with radius 10,
        LoopClosing.cc:370-389). A true revisit shares its whole
        SURROUNDINGS with the loop neighborhood; an aliased lookalike
        shares only the repeated structure and undershoots this count."""
        pts, descs, seen = [], [], set()
        for nb_id in [loop_kf.id] + list(loop_kf.covis):
            nb = self.map.keyframes.get(nb_id)
            if nb is None or nb.bad:
                continue
            for pid in nb.map_point_ids:
                if pid < 0 or pid in seen:
                    continue
                seen.add(pid)
                p = self.map.points.get(int(pid))
                if p is None or p.bad:
                    continue
                pts.append(p.position)
                descs.append(p.descriptor)
                if len(pts) >= self.NEIGH_PT_CAP:
                    break
            if len(pts) >= self.NEIGH_PT_CAP:
                break
        if not pts:
            return 0
        C = self.NEIGH_PT_CAP
        n = len(pts)
        pos = np.zeros((C, 3), np.float32)
        pos[:n] = np.stack(pts)
        desc = np.zeros((C, 8), np.uint32)
        desc[:n] = np.stack(descs)
        valid = np.zeros(C, np.float32)
        valid[:n] = 1.0
        # project under the CORRECTED Sim(3) camera pose
        pc = pos @ S_cw_corr[:3, :3].T + S_cw_corr[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        intr = self.intrinsics_np
        u = intr[0] * pc[:, 0] / z + intr[2]
        v = intr[1] * pc[:, 1] / z + intr[3]
        w, h = 2.0 * intr[2], 2.0 * intr[3]
        in_img = (
            (pc[:, 2] > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        ).astype(np.float32)
        proj = np.stack([u, v], -1).astype(np.float32)
        dev = self.device
        m_idx, _ = matcher.match_by_projection(
            to_torch(proj, dev), to_torch(valid * in_img, dev),
            to_torch(desc, dev), torch.zeros(C, dtype=torch.int32, device=dev),
            kf.feats_torch(dev),
            radius=radius, max_dist=matcher.TH_LOW, ratio=None,
        )
        m_idx = m_idx.cpu().numpy()
        # distinct current keypoints matched (the reference counts
        # matched mvpCurrentMatchedPoints slots)
        return len(set(int(j) for j in m_idx[:n] if j >= 0))

    # ------------------------------------------------------------------
    def _correct_loop(self, kf, loop_kf, S_cw_corr):
        """Propagate correction through the covisibility group, correct
        points + objects, fuse objects, optimize the essential graph."""
        # loop B while loop A's GBA is still in flight: abort A's solve —
        # it was computed from the poses this correction is about to
        # rewrite (reference mbStopGBA + thread join,
        # LoopClosing_util.cc:32-50); a fresh GBA is dispatched below
        self.abort_pending_gba()
        self._map_epoch += 1
        group = [kf.id] + list(kf.covis)
        T_cw_old = kf.T_cw.copy()
        corrections = {}   # kf_id -> (S_iw_old, S_iw_corr)
        for kf_id in group:
            okf = self.map.keyframes.get(kf_id)
            if okf is None or okf.bad:
                continue
            T_ic = okf.T_cw @ np.linalg.inv(T_cw_old)
            S_iw_corr = (T_ic @ S_cw_corr).astype(np.float32)
            corrections[kf_id] = (okf.T_cw.copy(), S_iw_corr)

        # move points / objects observed by the group (once each; separate
        # id spaces — MapPoint and MapObject counters are independent, a
        # shared set silently skipped colliding object ids)
        moved_pts: set[int] = set()
        moved_objs: set[int] = set()
        for kf_id, (T_old, S_new) in corrections.items():
            okf = self.map.keyframes[kf_id]
            S_wi_new = _inv_sim3_np(S_new)
            for p_id in okf.map_point_ids:
                if p_id < 0 or p_id in moved_pts:
                    continue
                p = self.map.points.get(int(p_id))
                if p is None or p.bad:
                    continue
                x_i = T_old[:3, :3] @ p.position + T_old[:3, 3]
                p.position = (S_wi_new[:3, :3] @ x_i + S_wi_new[:3, 3]).astype(
                    np.float32
                )
                moved_pts.add(p_id)
            # move objects observed by the group (LoopClosing_util.cc:131-146)
            for obj_id in set(okf.object_associations.values()):
                obj = self.map.objects.get(obj_id)
                if obj is None or obj.bad or obj_id in moved_objs:
                    continue
                self._move_object(obj, T_old, S_wi_new)
                moved_objs.add(obj_id)
            okf.T_cw = S_new  # Sim(3) folded into pose (scale ~1 for stereo)

        kf.loop_edges.add(loop_kf.id)
        loop_kf.loop_edges.add(kf.id)
        self._fuse_objects(kf, loop_kf, corrections)
        self._optimize_essential_graph(kf, loop_kf, corrections)
        self._pending_gba = self._dispatch_global_ba(kf, loop_kf)
        self._gba_skip = 1

    def poll(self):
        """Apply a backgrounded global BA once its solve has had a frame
        to overlap tracking (System.track_* calls this per frame)."""
        if self._pending_gba is None:
            return
        if self._gba_skip > 0:
            self._gba_skip -= 1
            return
        pending, self._pending_gba = self._pending_gba, None
        self._apply_global_ba(pending)

    def flush(self):
        """Force-apply a backgrounded global BA (before the next
        keyframe's mapping work, at sequence end, before saving)."""
        self._gba_skip = 0
        if self._pending_gba is not None:
            pending, self._pending_gba = self._pending_gba, None
            self._apply_global_ba(pending)

    def abort_pending_gba(self):
        """Drop an in-flight global BA without applying it."""
        self._pending_gba = None
        self._gba_skip = 0

    @staticmethod
    def _move_object(obj, S_before, S_wi_after):
        """Re-express an object's T_wo under a keyframe's pose update:
        hold the camera-frame pose T_io fixed while world_i moves
        (reference SetObjectPoseSE3(CorrectedTwo), LoopClosing_util.cc:
        131-146). Scale change folds into the object scale."""
        T_io = S_before @ obj.T_wo_se3
        T_wo_new = S_wi_after @ T_io
        s_new = float(np.linalg.det(T_wo_new[:3, :3])) ** (1.0 / 3.0)
        T_se3 = T_wo_new.copy()
        T_se3[:3, :3] /= s_new
        obj.set_pose_se3(T_se3.astype(np.float32), obj.scale * s_new)

    # ------------------------------------------------------------------
    def _side_objects(self, kf_ids) -> set[int]:
        out: set[int] = set()
        for k in kf_ids:
            okf = self.map.keyframes.get(k)
            if okf is None:
                continue
            out.update(
                o for o in okf.object_associations.values()
                if o in self.map.objects and not self.map.objects[o].bad
            )
        return out

    def _fuse_objects(self, kf, loop_kf, corrections):
        """Merge duplicate objects across the loop: a CURRENT-side object
        (observed by the corrected group) matching a LOOP-side object
        (observed by the loop keyframe's group) within 2 m is replaced by
        the loop-side one (SearchAndFuseObjects, LoopClosing_util.cc:
        221-293). Unrelated nearby objects — e.g. two parked cars — are
        never candidates."""
        cur_ids = self._side_objects(corrections.keys())
        loop_ids = self._side_objects([loop_kf.id] + list(loop_kf.covis))
        for cur_id in cur_ids - loop_ids:
            cur = self.map.objects.get(cur_id)
            if cur is None or cur.bad:
                continue
            best, best_d = None, OBJ_FUSE_DIST
            for lid in loop_ids:
                lo = self.map.objects.get(lid)
                if lo is None or lo.bad or lid == cur_id:
                    continue
                d = np.linalg.norm(cur.T_wo[:3, 3] - lo.T_wo[:3, 3])
                if d < best_d:
                    best, best_d = lo, d
            if best is not None:
                self.map.replace_object(cur, best)

    # ------------------------------------------------------------------
    def _loop_window(self, kf, loop_kf, cap: int) -> list[int]:
        """Keyframe window for pose graph / GBA: all keyframes when they
        fit, else a BFS over spanning tree + covisibility + loop edges
        anchored on BOTH loop ends — never `sorted(...)[:cap]`, which
        excluded the loop itself on long sequences."""
        alive = [k for k, v in self.map.keyframes.items() if not v.bad]
        if len(alive) <= cap:
            return sorted(alive)
        from collections import deque

        seen = {kf.id, loop_kf.id}
        q = deque(seen)
        while q and len(seen) < cap:
            k = q.popleft()
            okf = self.map.keyframes.get(k)
            if okf is None:
                continue
            neigh = list(okf.covis) + list(okf.loop_edges) + list(okf.children)
            if okf.parent is not None:
                neigh.append(okf.parent)
            for nb in neigh:
                if nb not in seen and nb in self.map.keyframes \
                        and not self.map.keyframes[nb].bad:
                    seen.add(nb)
                    q.append(nb)
                    if len(seen) >= cap:
                        break
        return sorted(seen)

    def _propagate_and_drag(self, updates: dict, skip_pts=(), skip_objs=()):
        """Spread pose updates {kf_id: (S_before, S_after)} to every
        keyframe reachable through the spanning tree, then re-express all
        map points and objects via their reference keyframe's update —
        the reference's post-GBA spanning-tree correction
        (LoopClosing_util.cc:324-411)."""
        # extend through the spanning tree: child pose follows parent,
        # holding the (pre-update) relative transform fixed
        frontier = list(updates)
        while frontier:
            nxt = []
            for k in frontier:
                okf = self.map.keyframes.get(k)
                if okf is None:
                    continue
                S_par_old, S_par_new = updates[k]
                inv_par_old = _inv_sim3_np(S_par_old)
                for child_id in okf.children:
                    if child_id in updates:
                        continue
                    ckf = self.map.keyframes.get(child_id)
                    if ckf is None or ckf.bad:
                        continue
                    T_rel = ckf.T_cw @ inv_par_old
                    updates[child_id] = (
                        ckf.T_cw.copy(),
                        (T_rel @ S_par_new).astype(np.float32),
                    )
                    nxt.append(child_id)
            frontier = nxt

        inv_after = {}
        for k, (S_before, S_after) in updates.items():
            okf = self.map.keyframes.get(k)
            if okf is not None:
                okf.T_cw = S_after
            inv_after[k] = _inv_sim3_np(S_after)

        def pick_kf(ref_id, observations):
            if ref_id in updates:
                return ref_id
            ref = self.map.keyframes.get(ref_id)
            if ref is not None and not ref.bad:
                return None   # reference alive and unmoved -> entity stays
            for o in observations:   # ref culled: follow any moved observer
                if o in updates:
                    return o
            return None

        for p in self.map.points.values():
            if p.bad or p.id in skip_pts:
                continue
            k = pick_kf(p.ref_kf_id, p.observations)
            if k is None:
                continue
            S_before, _ = updates[k]
            x_i = S_before[:3, :3] @ p.position + S_before[:3, 3]
            S_wi = inv_after[k]
            p.position = (S_wi[:3, :3] @ x_i + S_wi[:3, 3]).astype(np.float32)
        for obj in self.map.objects.values():
            if obj.bad or obj.id in skip_objs:
                continue
            k = pick_kf(obj.ref_kf_id, obj.observations)
            if k is None:
                continue
            self._move_object(obj, updates[k][0], inv_after[k])

    # ------------------------------------------------------------------
    def _optimize_essential_graph(self, kf, loop_kf, corrections):
        """Sim(3) essential-graph optimization (Optimizer.cc:780-1044).

        Edge measurements come from PRE-correction poses (the reference's
        NonCorrectedSim3): vertices of the corrected group start at their
        corrected poses, so spanning-tree/covis edges touching the group
        carry the loop error into the rest of the graph. The fresh loop
        edge uses the corrected relative pose — its residual is zero and
        it anchors the current side to the (fixed) loop keyframe.

        Scale: up to PG_DENSE_MAX keyframes the dense LM solves directly;
        beyond that a COARSE pass first dense-solves a subsampled graph
        (composed f64 measurements on host) and interpolates its
        correction — distributing the loop error globally — then the
        matrix-free CG LM refines all vertices (its block-Jacobi CG
        converges fast once only local, high-frequency error remains).
        Edges fill highest-priority first under PG_EDGE_CAP: loop edges,
        then spanning tree, then strong covisibility — a truncated run
        must never drop the edges that carry the loop error outward."""
        kf_ids = self._loop_window(kf, loop_kf, PG_KF_CAP)
        slot = {k: i for i, k in enumerate(kf_ids)}
        K = _next_pow2(len(kf_ids), 32, PG_KF_CAP)
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        fixed = np.ones(K, np.float32)
        for k, i in slot.items():
            poses[i] = self.map.keyframes[k].T_cw
            fixed[i] = 0.0
        if loop_kf.id in slot:
            fixed[slot[loop_kf.id]] = 1.0

        def pose_before(k):
            if k in corrections:
                return corrections[k][0]
            return self.map.keyframes[k].T_cw

        new_loop = {(kf.id, loop_kf.id), (loop_kf.id, kf.id)}

        def loop_meas(k, l):
            if (k, l) in new_loop:
                return self.map.keyframes[k].T_cw @ _inv_sim3_np(
                    self.map.keyframes[l].T_cw
                )
            return pose_before(k) @ _inv_sim3_np(pose_before(l))

        # collect edges by priority tier (loop > spanning tree > covis)
        tier_loop, tier_tree, tier_covis = [], [], []
        for k in kf_ids:
            okf = self.map.keyframes[k]
            for l in okf.loop_edges:
                if l < k and l in slot:
                    tier_loop.append((k, l, loop_meas(k, l)))
            if okf.parent is not None and okf.parent in slot:
                meas = pose_before(k) @ _inv_sim3_np(pose_before(okf.parent))
                tier_tree.append((k, okf.parent, meas))
            for other, w in okf.covis.items():
                if w >= 100 and other < k and other in slot:
                    meas = pose_before(k) @ _inv_sim3_np(pose_before(other))
                    tier_covis.append((k, other, meas))

        all_edges = tier_loop + tier_tree + tier_covis
        if len(all_edges) > PG_EDGE_CAP:
            log.warning(
                "pose-graph edge cap: %d edges (%d loop / %d tree / %d "
                "covis), keeping strongest-priority %d",
                len(all_edges), len(tier_loop), len(tier_tree),
                len(tier_covis), PG_EDGE_CAP,
            )
            all_edges = all_edges[:PG_EDGE_CAP]
        n = len(all_edges)
        if n < 2:
            return
        E = _next_pow2(n, 64, PG_EDGE_CAP)
        edge_i = np.zeros(E, np.int32)
        edge_j = np.zeros(E, np.int32)
        edge_meas = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
        edge_valid = np.zeros(E, np.float32)
        for idx, (i_id, j_id, meas) in enumerate(all_edges):
            edge_i[idx] = slot[i_id]
            edge_j[idx] = slot[j_id]
            edge_meas[idx] = meas
            edge_valid[idx] = 1.0

        if len(kf_ids) > PG_DENSE_MAX:
            self._coarse_pg_correct(
                kf_ids, slot, poses, fixed, pose_before, tier_loop
            )
            out = pose_graph.optimize_pose_graph_cg(
                *self._upload(poses, fixed, edge_i, edge_j, edge_meas, edge_valid),
                fix_scale=self.fix_scale, cg_iters=min(2 * K, 4096),
            )
        else:
            out = pose_graph.optimize_pose_graph(
                *self._upload(poses, fixed, edge_i, edge_j, edge_meas, edge_valid),
                fix_scale=self.fix_scale,
            )
        new_poses = out.cpu().numpy()
        if not np.isfinite(new_poses).all():
            return
        updates = {}
        for k, i in slot.items():
            if fixed[i] == 0.0:
                updates[k] = (
                    self.map.keyframes[k].T_cw.copy(), new_poses[i]
                )
        self._propagate_and_drag(updates)

    def _coarse_pg_correct(
        self, kf_ids, slot, poses, fixed, pose_before, tier_loop
    ):
        """Coarse-grid pass of the large-graph essential optimization:
        dense-LM a subsampled chain (every stride-th keyframe + all loop
        ends), measurements composed from pre-correction poses in f64 on
        host, then interpolate — each skipped keyframe follows its
        nearest preceding anchor rigidly. Writes corrected poses into
        `poses` in place (the fine CG stage's initialization)."""
        stride = max(1, int(np.ceil(len(kf_ids) / PG_DENSE_MAX)))
        anchors = set(kf_ids[::stride])
        anchors.add(kf_ids[-1])
        for k, l, _ in tier_loop:
            anchors.update((k, l))
        anchors.update(k for k in kf_ids if fixed[slot[k]] == 1.0)
        anchors = sorted(anchors)
        a_slot = {k: i for i, k in enumerate(anchors)}
        Kc = _next_pow2(len(anchors), 32, 2 * PG_DENSE_MAX)
        c_poses = np.tile(np.eye(4, dtype=np.float32), (Kc, 1, 1))
        c_fixed = np.ones(Kc, np.float32)
        for k, i in a_slot.items():
            c_poses[i] = poses[slot[k]]
            c_fixed[i] = fixed[slot[k]]
        edges = []
        for m in range(1, len(anchors)):
            a, b = anchors[m], anchors[m - 1]
            meas = (
                pose_before(a).astype(np.float64)
                @ np.linalg.inv(pose_before(b).astype(np.float64))
            ).astype(np.float32)
            edges.append((a_slot[a], a_slot[b], meas))
        for k, l, meas in tier_loop:
            edges.append((a_slot[k], a_slot[l], meas))
        Ec = _next_pow2(len(edges), 64, 4 * PG_DENSE_MAX)
        ei = np.zeros(Ec, np.int32)
        ej = np.zeros(Ec, np.int32)
        em = np.tile(np.eye(4, dtype=np.float32), (Ec, 1, 1))
        ev = np.zeros(Ec, np.float32)
        for idx, (i, j, meas) in enumerate(edges):
            ei[idx], ej[idx], em[idx], ev[idx] = i, j, meas, 1.0
        out = pose_graph.optimize_pose_graph(
            *self._upload(c_poses, c_fixed, ei, ej, em, ev), fix_scale=self.fix_scale,
        ).cpu().numpy()
        if not np.isfinite(out).all():
            return
        # interpolate: non-anchor keyframes follow the nearest preceding
        # anchor (rigid within a segment; the fine CG pass smooths it)
        cur_anchor = None
        for k in kf_ids:
            i = slot[k]
            if k in a_slot:
                if fixed[i] == 0.0:
                    old = poses[i].copy()
                    poses[i] = out[a_slot[k]]
                    cur_anchor = (old, poses[i])
                else:
                    cur_anchor = (poses[i].copy(), poses[i].copy())
            elif cur_anchor is not None and fixed[i] == 0.0:
                a_old, a_new = cur_anchor
                rel = poses[i].astype(np.float64) @ np.linalg.inv(
                    a_old.astype(np.float64)
                )
                poses[i] = (rel @ a_new.astype(np.float64)).astype(np.float32)

    def _upload(self, *arrays):
        """Host arrays as tensors on the loop closer's device (pinned,
        without waiting for queued device work)."""
        return [to_torch(a, self.device) for a in arrays]

    def _upload_gba(self, *arrays):
        """_upload with the float arrays cast to the global BA's dtype."""
        return [t if t.dtype == torch.int32 else t.to(GBA_DTYPE) for t in self._upload(*arrays)]

    # ------------------------------------------------------------------
    def _global_ba(self, kf, loop_kf):
        """Synchronous dispatch + apply (tests / direct callers)."""
        pending = self._dispatch_global_ba(kf, loop_kf)
        if pending is not None:
            self._apply_global_ba(pending)

    def _dispatch_global_ba(self, kf, loop_kf):
        """Global joint BA windowed around the loop, with camera-object
        edges, DISPATCH only; corrections propagate to out-of-window
        keyframes, points and objects through the spanning tree at apply
        time (GlobalJointBundleAdjustemnt + LoopClosing_util.cc:295-423,
        which backgrounds exactly this solve on a thread). Issues no host
        sync: the inputs go up through pinned memory and the results start
        streaming back at once."""
        kf_ids = self._loop_window(kf, loop_kf, GBA_KF_CAP)
        slot = {k: i for i, k in enumerate(kf_ids)}
        K = GBA_KF_CAP
        kf_poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        kf_fixed = np.ones(K, np.float32)
        for k, i in slot.items():
            kf_poses[i] = self.map.keyframes[k].T_cw
            kf_fixed[i] = 0.0
        # gauge: keyframe 0 when present, else the loop keyframe
        anchor = 0 if 0 in slot else loop_kf.id if loop_kf.id in slot else min(kf_ids)
        kf_fixed[slot[anchor]] = 1.0

        # strongest-observed points first under the cap, like local BA
        # (silent arbitrary-order truncation dropped well-tracked points)
        pt_ids = self.map.points_seen_by(kf_ids)
        pt_ids.sort(key=lambda p: -self.map.points[p].n_obs)
        if len(pt_ids) > GBA_PT_CAP:
            log.warning(
                "global BA point cap: %d observed, optimizing strongest %d",
                len(pt_ids), GBA_PT_CAP,
            )
        pt_ids = pt_ids[:GBA_PT_CAP]
        pslot = {p: i for i, p in enumerate(pt_ids)}
        P = GBA_PT_CAP
        points = np.zeros((P, 3), np.float32)
        pt_valid = np.zeros(P, np.float32)
        for p, i in pslot.items():
            points[i] = self.map.points[p].position
            pt_valid[i] = 1.0

        O = GBA_OBS_CAP
        obs = np.zeros((O, 3), np.float32)
        obs_kf = np.zeros(O, np.int32)
        obs_pt = np.zeros(O, np.int32)
        obs_stereo = np.zeros(O, np.float32)
        obs_is2 = np.ones(O, np.float32)
        obs_valid = np.zeros(O, np.float32)
        m = 0
        for p, i in pslot.items():
            mp = self.map.points[p]
            for kf_id, kp in mp.observations.items():
                if kf_id not in slot or m >= O:
                    continue
                okf = self.map.keyframes[kf_id]
                obs_kf[m] = slot[kf_id]
                obs_pt[m] = i
                obs[m, :2] = okf.feats["xy"][kp]
                ur = okf.u_right[kp] if okf.u_right is not None else -1
                if ur > 0:
                    obs[m, 2] = ur
                    obs_stereo[m] = 1.0
                obs_is2[m] = 1.0 / okf.feats["sigma2"][kp]
                obs_valid[m] = 1.0
                m += 1
        if m < 50:
            return None

        # objects observed by window keyframes -> joint camera-object edges
        # (GlobalJointBundleAdjustemnt includes them, Optimizer_util.cc:36-42)
        obj_state = None
        obj_ids = sorted(self._side_objects(kf_ids))[:GBA_OBJ_CAP]
        oslot = {}
        obj_fixed = None
        if obj_ids:
            oslot = {o: i for i, o in enumerate(obj_ids)}
            M, Q = GBA_OBJ_CAP, GBA_EDGE_CAP
            obj_poses = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
            obj_fixed = np.ones(M, np.float32)
            edge_kf = np.zeros(Q, np.int32)
            edge_obj = np.zeros(Q, np.int32)
            edge_Tco = np.tile(np.eye(4, dtype=np.float32), (Q, 1, 1))
            edge_valid = np.zeros(Q, np.float32)
            qn = 0
            for o, i in oslot.items():
                obj = self.map.objects[o]
                obj_poses[i] = obj.T_wo_se3
                obj_fixed[i] = 0.0
                for kf_id, det_idx in obj.observations.items():
                    okf = self.map.keyframes.get(kf_id)
                    if okf is None or kf_id not in slot or qn >= Q:
                        continue
                    if det_idx >= len(okf.detections):
                        continue
                    T_co = getattr(
                        okf.detections[det_idx], "T_co_se3_measured", None
                    )
                    if T_co is None:
                        continue
                    edge_kf[qn] = slot[kf_id]
                    edge_obj[qn] = oslot[o]
                    edge_Tco[qn] = T_co
                    edge_valid[qn] = 1.0
                    qn += 1
            if qn > 0:
                obj_state = dict(zip(
                    ("poses", "fixed", "edge_kf", "edge_obj", "edge_Tco", "edge_valid"),
                    self._upload_gba(obj_poses, obj_fixed, edge_kf, edge_obj, edge_Tco, edge_valid),
                ))

        out = ba.global_bundle_adjust(
            *self._upload_gba(kf_poses, kf_fixed, points, pt_valid, obs_kf, obs_pt, obs,
                              obs_stereo, obs_is2, obs_valid),
            self.intrinsics.to(GBA_DTYPE), 1e-3, obj_state, schedule=(10,),
        )
        host, event = _prefetch_to_host({"out": out})
        return {
            "host": host, "event": event, "slot": slot, "kf_fixed": kf_fixed, "pslot": pslot,
            "oslot": oslot, "obj_fixed": obj_fixed,
            "has_objs": obj_state is not None,
            "epoch": self._map_epoch,
        }

    def _apply_global_ba(self, pending):
        """Fetch + write back the windowed GBA, then drag the rest of
        the map along the spanning tree; entities erased since dispatch
        are skipped."""
        if pending.get("epoch", self._map_epoch) != self._map_epoch:
            # solved from pre-correction poses: stale, never write back
            # (reference mbStopGBA semantics)
            return
        out = _host_result(pending["host"], pending["event"])["out"]
        slot, kf_fixed = pending["slot"], pending["kf_fixed"]
        pslot, oslot = pending["pslot"], pending["oslot"]
        obj_fixed = pending["obj_fixed"]
        new_poses = out["kf_poses"].astype(np.float32)
        new_pts = out["points"].astype(np.float32)
        if not (np.isfinite(new_poses).all() and np.isfinite(new_pts).all()):
            return
        updates = {}
        for k, i in slot.items():
            okf = self.map.keyframes.get(k)
            if okf is None or okf.bad:
                continue
            if kf_fixed[i] == 0.0:
                updates[k] = (okf.T_cw.copy(), new_poses[i])
            else:
                # fixed-in-window keyframes keep their pose but still act
                # as propagation anchors for out-of-window children
                updates[k] = (okf.T_cw.copy(), okf.T_cw.copy())
        moved_objs = set()
        if pending["has_objs"]:
            new_obj = out["obj_poses"].astype(np.float32)
            if np.isfinite(new_obj).all():
                for o, i in oslot.items():
                    obj = self.map.objects.get(o)
                    if obj is not None and not obj.bad and obj_fixed[i] == 0.0:
                        obj.set_pose_se3(new_obj[i])
                        moved_objs.add(o)
        # out-of-window keyframes/points/objects follow via spanning tree
        self._propagate_and_drag(
            updates, skip_pts=set(pslot), skip_objs=moved_objs
        )
        for p, i in pslot.items():
            mp = self.map.points.get(p)
            if mp is not None and not mp.bad:
                mp.position = new_pts[i]
