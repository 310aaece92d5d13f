"""Local mapping stage: point culling, triangulation + fusion, windowed
(joint) bundle adjustment, keyframe culling.

Port of dspslam_tpu/slam/local_mapping.py, the cooperative-stage form of
the reference's LocalMapping thread (LocalMapping.cc:55-140): each new
keyframe is processed by the host loop (covisibility bookkeeping, map-point
culling, the object pipeline, triangulation + fusion as one device call,
local BA over the covisibility window with camera-object edges,
Optimizer_util.cc:309-771, and keyframe culling).

Device work is queued and read back later: a dispatch records a CUDA event
after its results' copies into pinned host memory, and `poll()` applies a
pending result only once its event has completed (`results_ready`), so an
apply never blocks a tracked frame on the card. On the CPU results are
ready at once.

Keyframe erasure removes the keyframe from every keyframe's covisibility
(`Map.erase_keyframe`), so a BA window never names an erased keyframe
(ROADMAP fault R1, `KeyError: 48` in the JAX package).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..backend import ba
from ..objects.pipeline import results_ready
from ..utils import timing
from . import keyframe_step
from .map import KeyFrame, Map, MapPoint, entry_device, to_torch
from .tracking import _host_result, _prefetch_to_host

BA_KF_CAP = 16          # free window keyframes + fixed observers
BA_WINDOW = 8           # optimized keyframes
# Point-count buckets: the solve's shape grows with the window's density so
# dense maps optimize every point (the reference's local BA is unbounded,
# Optimizer_util.cc:309-430); observations are 4x the points (the
# observations per point of a BA_KF_CAP window).
BA_PT_BUCKETS = (1024, 2048, 4096, 8192)
BA_PT_CAP = BA_PT_BUCKETS[-1]     # hard cap: truncation warning beyond
BA_OBS_PER_PT = 4
BA_OBJ_CAP = 8
BA_EDGE_CAP = 32


def ba_point_bucket(n: int) -> int:
    """Smallest bucket holding n points; the last bucket is the cap."""
    for b in BA_PT_BUCKETS:
        if n <= b:
            return b
    return BA_PT_BUCKETS[-1]


@dataclasses.dataclass
class LocalMapperConfig:
    fx: float = 707.0912
    fy: float = 707.0912
    cx: float = 601.8873
    cy: float = 183.1104
    bf: float = 379.8145
    cull_found_ratio: float = 0.25
    # reference MapPointCulling: a point must reach 3 keyframe observations
    # within 2 keyframes of birth or it is dropped (mnMinObs = 3, stereo)
    cull_min_obs: int = 3
    window: int = BA_KF_CAP
    # Asynchronous local BA: the solve for keyframe k is dispatched at k and
    # applied at a later poll (or the next keyframe, or flush), the
    # reference's mapping thread finishing BA while tracking runs on.
    async_ba: bool = True
    # Spread the keyframe over later frames: the keyframe frame only
    # dispatches triangulation + fusion; poll() applies it and dispatches
    # BA, which applies at a later poll. Ignored when the object pipeline
    # votes with map points (`uses_map_points`, the mono pipeline): its
    # association needs the keyframe's fresh points.
    async_keyframe: bool = False
    # Defer the object stage's apply to a poll (only with async_keyframe).
    async_objects: bool = False
    # Camera-object SE(3) edges in local BA (Optimizer_util.cc:309-430).
    # Off = points-only BA with object poses frozen at their per-keyframe
    # GN measurements: the benchmark's A/B arm.
    ba_objects: bool = True


class LocalMapper:
    def __init__(self, slam_map: Map, cfg: LocalMapperConfig, object_pipeline=None, device=None):
        self.map = slam_map
        self.cfg = cfg
        self.object_pipeline = object_pipeline
        self.device = entry_device(device, "LocalMapper")
        self.intrinsics = torch.tensor([cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf],
                                       dtype=torch.float32, device=self.device)
        self.recent_points: list[tuple[int, int]] = []  # (point_id, birth_kf)
        self._pending_ba = None
        self._pending_tri = None
        self._pending_obj = None      # (kf, obj_pending) awaiting apply
        self._ba_kf = None            # KF whose BA dispatch awaits tri apply
        self._skip_polls = 0          # let dispatched work overlap a frame
        # one record per applied BA solve: edges, edge inliers, device ms
        self.ba_log: list[dict] = []
        self.ba_pt_cap_hits = 0       # solves whose window exceeded BA_PT_CAP

    def _timing_event(self):
        """A timing CUDA event recorded now (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def accepting_keyframes(self) -> bool:
        """The reference's AcceptKeyFrames() gate on weak-tracking keyframe
        insertion: only a pending triangulation holds new keyframes back."""
        return self._pending_tri is None

    # ------------------------------------------------------------------
    def process(self, kf: KeyFrame, triangulate: bool = True):
        """One keyframe through the mapping stages. Triangulation is queued
        first, then the object GN calls; results are read after all of them
        are queued."""
        with timing.span("kf_flush_prev"):
            self.flush()             # drain anything from the previous KF
        self.map.update_covisibility(kf)
        self._cull_points(kf)
        needs_fresh_points = getattr(self.object_pipeline, "uses_map_points", False)
        defer = self.cfg.async_keyframe and not needs_fresh_points
        tri_sync = None
        with timing.span("kf_tri_dispatch"):
            if defer:
                self._pending_tri = self._dispatch_triangulate(kf, triangulate)
            elif needs_fresh_points:
                # mono association votes with map points: the keyframe's
                # triangulation and fusion land before the object stage
                pending = self._dispatch_triangulate(kf, triangulate)
                if pending is not None:
                    self._apply_triangulate(pending)
            else:
                tri_sync = self._dispatch_triangulate(kf, triangulate)
        obj_pending = None
        if self.object_pipeline is not None:
            local_ids = self.map.local_keyframes(kf, self.cfg.window)
            with timing.span("kf_obj_dispatch"):
                obj_pending = self.object_pipeline.dispatch_keyframe(kf, local_ids)
            if defer and self.cfg.async_objects:
                self._pending_obj = (kf, obj_pending)
            else:
                with timing.span("obj_apply"):
                    self.object_pipeline.apply_keyframe(kf, obj_pending)
        if tri_sync is not None:
            with timing.span("tri_apply"):
                self._apply_triangulate(tri_sync)
        if defer:
            # BA must see the triangulated points: poll() dispatches it
            # right after the triangulation applies
            self._ba_kf = kf
            self._skip_polls = 1
        elif self.cfg.async_ba:
            with timing.span("ba_dispatch"):
                self._pending_ba = self.dispatch_bundle_adjust(kf)
            self._skip_polls = 1
        else:
            with timing.span("ba_sync"):
                self.local_bundle_adjust(kf)
        self._cull_keyframes(kf)

    def poll(self):
        """One deferred-stage step per tracked frame: applies at most one
        pending result, and only one whose device work has finished."""
        if self._skip_polls > 0:
            self._skip_polls -= 1
            return
        if self._pending_tri is not None:
            if not results_ready(self._pending_tri["event"]):
                return
            pending, self._pending_tri = self._pending_tri, None
            with timing.span("tri_apply"):
                self._apply_triangulate(pending)
            if self._ba_kf is not None:
                kf, self._ba_kf = self._ba_kf, None
                if not kf.bad:
                    if self.cfg.async_ba:
                        with timing.span("ba_dispatch"):
                            self._pending_ba = self.dispatch_bundle_adjust(kf)
                        self._skip_polls = 1
                    else:
                        with timing.span("ba_sync"):
                            self.local_bundle_adjust(kf)
            return
        if self._pending_obj is not None:
            if not results_ready(self._pending_obj[1]):
                return
            (kf, obj_pending), self._pending_obj = self._pending_obj, None
            with timing.span("obj_apply"):
                self.object_pipeline.apply_keyframe(kf, obj_pending)
            return
        if self._pending_ba is not None:
            if not results_ready(self._pending_ba["event"]):
                return
            with timing.span("ba_apply"):
                self.apply_pending_ba()
            return
        # idle poll: finalize one deferred mesh (the mono pipeline meshes
        # synchronously and defers none)
        pipeline = self.object_pipeline
        if getattr(pipeline, "_pending_meshes", None) and pipeline.meshes_ready():
            with timing.span("mesh_collect"):
                pipeline.collect_meshes(limit=1)

    def apply_pending_ba(self):
        """Read back and write the previous keyframe's BA solve, if any."""
        pending, self._pending_ba = self._pending_ba, None
        if pending is not None:
            self._apply_bundle_adjust(pending)

    def drop_pending_ba(self):
        """Discard in-flight solves (a loop correction rewrote their poses,
        the reference's mbAbortBA). Object measurements are camera-frame
        and stay valid: they are applied."""
        self._pending_ba = None
        self._pending_tri = None
        self._ba_kf = None
        if self._pending_obj is not None:
            (kf, obj_pending), self._pending_obj = self._pending_obj, None
            self.object_pipeline.apply_keyframe(kf, obj_pending)

    def flush(self):
        """Drain all deferred keyframe stages in order."""
        self._skip_polls = 0
        if self._pending_obj is not None:
            (kf, obj_pending), self._pending_obj = self._pending_obj, None
            self.object_pipeline.apply_keyframe(kf, obj_pending)
        if self._pending_tri is not None:
            pending, self._pending_tri = self._pending_tri, None
            self._apply_triangulate(pending)
        if self._ba_kf is not None:
            kf, self._ba_kf = self._ba_kf, None
            if not kf.bad:
                self._pending_ba = self.dispatch_bundle_adjust(kf)
        self.apply_pending_ba()
        if getattr(self.object_pipeline, "_pending_meshes", None):
            self.object_pipeline.collect_meshes()

    # ------------------------------------------------------------------
    def _cull_points(self, kf: KeyFrame):
        """Recent-point culling (LocalMapping::MapPointCulling)."""
        survivors = []
        for p_id, birth in self.recent_points:
            p = self.map.points.get(p_id)
            if p is None or p.bad:
                continue
            age = kf.id - birth
            if p.found_ratio() < self.cfg.cull_found_ratio:
                self.map.erase_point(p_id)
            elif age >= 2 and p.n_obs < self.cfg.cull_min_obs:
                self.map.erase_point(p_id)
            elif age < 3:
                survivors.append((p_id, birth))
        self.recent_points = survivors

    def register_new_points(self, point_ids, birth_kf_id):
        self.recent_points.extend((p, birth_kf_id) for p in point_ids)

    # ------------------------------------------------------------------
    def _dispatch_triangulate(self, kf: KeyFrame, triangulate: bool = True):
        """Epipolar triangulation against strong covisible keyframes
        (LocalMapping::CreateNewMapPoints, LocalMapping.cc:258-450) and
        duplicate fusion (SearchInNeighbors + ORBmatcher::Fuse) as one
        queued device call (slam.keyframe_step); the host applies the
        pre-validated results in _apply_triangulate."""
        with timing.span("tri_host_prep"):
            neighbors, pts, fuse = self._triangulate_inputs(kf, triangulate)
        if not neighbors and not pts:
            return None
        with timing.span("tri_call"):
            N, M, C = kf.n, keyframe_step.MAX_NEIGHBORS, keyframe_step.FUSE_CAP
            # neighbour features are each keyframe's device copy; empty slots
            # reuse kf's own, masked by nb_ok = 0
            kf_dev = kf.feats_torch(self.device)
            nb_list = tuple(neighbors[i].feats_torch(self.device) if i < len(neighbors) else kf_dev
                            for i in range(M))
            nb_T = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
            nb_has = np.ones((M, N), np.float32)
            nb_ok = np.zeros(M, np.float32)
            for i, other in enumerate(neighbors):
                nb_T[i] = other.T_cw
                nb_has[i] = (other.map_point_ids >= 0).astype(np.float32)
                nb_ok[i] = 1.0
            depth_pos = (kf.depth > 0).astype(np.float32) if kf.depth is not None else np.zeros(N, np.float32)
            d = self.device
            out = keyframe_step.keyframe_matching(
                kf_dev, to_torch(np.asarray(kf.T_cw, np.float32), d),
                to_torch((kf.map_point_ids >= 0).astype(np.float32), d), to_torch(depth_pos, d),
                nb_list, to_torch(nb_T, d), to_torch(nb_has, d), to_torch(nb_ok, d),
                *(to_torch(a, d) for a in fuse), to_torch(np.zeros(C, np.int32), d), self.intrinsics,
            )
            host, event = _prefetch_to_host({"out": out})
        return {"host": host, "event": event, "kf": kf, "neighbors": neighbors,
                "pts": pts, "n_f": len(pts)}

    def _triangulate_inputs(self, kf: KeyFrame, triangulate: bool):
        """The triangulation's neighbour keyframes, the fusion candidates
        (neighbour map points not yet observed by kf) and their padded
        (position, valid, descriptor) arrays."""
        neighbors = []
        if triangulate:
            for other_id in kf.covisible_keyframes(4):
                other = self.map.keyframes.get(other_id)
                if other is None or other.bad:
                    continue
                if np.linalg.norm(kf.camera_center() - other.camera_center()) < 1e-3:
                    continue
                neighbors.append(other)
                if len(neighbors) == keyframe_step.MAX_NEIGHBORS:
                    break
        neighbor_pts = {}
        for other_id in kf.covisible_keyframes(5):
            other = self.map.keyframes.get(other_id)
            if other is None:
                continue
            for p_id in other.map_point_ids:
                if p_id >= 0 and p_id not in neighbor_pts:
                    p = self.map.points.get(int(p_id))
                    if p is not None and not p.bad and kf.id not in p.observations:
                        neighbor_pts[p_id] = p
        pts = list(neighbor_pts.values())[: keyframe_step.FUSE_CAP]
        C = keyframe_step.FUSE_CAP
        fuse_pos = np.zeros((C, 3), np.float32)
        fuse_valid = np.zeros(C, np.float32)
        fuse_desc = np.zeros((C, 8), np.uint32)
        n_f = len(pts)
        if n_f:
            fuse_pos[:n_f] = np.stack([p.position for p in pts])
            fuse_valid[:n_f] = 1.0
            fuse_desc[:n_f] = np.stack([p.descriptor for p in pts])
        return neighbors, pts, (fuse_pos, fuse_valid, fuse_desc)

    def _apply_triangulate(self, pending):
        out = _host_result(pending["host"], pending["event"])["out"]
        kf = pending["kf"]
        neighbors, pts, n_f = pending["neighbors"], pending["pts"], pending["n_f"]
        if kf.bad:
            return
        # mint triangulated points (host bookkeeping only)
        created = []
        cam = kf.camera_center()
        for i_nb, other in enumerate(neighbors):
            if other.bad:      # culled since dispatch
                continue
            idx, X, ok = out["tri_idx"][i_nb], out["tri_X"][i_nb], out["tri_ok"][i_nb]
            for i in np.nonzero(ok)[0]:
                j = int(idx[i])
                if kf.map_point_ids[i] >= 0 or other.map_point_ids[j] >= 0:
                    continue   # taken by the other neighbour this round
                p = MapPoint(X[i].astype(np.float32), kf.feats["desc"][i], kf.id,
                             int(kf.feats["level"][i]), float(np.linalg.norm(X[i] - cam)))
                self.map.add_point(p)
                self.map.add_observation(p, kf, int(i))
                self.map.add_observation(p, other, j)
                created.append(p.id)
        if created:
            self.register_new_points(created, kf.id)
            self.map.update_covisibility(kf)

        # fusion matches
        idx = out["fuse_idx"]
        for j in range(n_f):
            if idx[j] < 0:
                continue
            kp = int(idx[j])
            existing_id = kf.map_point_ids[kp]
            p_new = pts[j]
            if p_new.bad:
                continue
            if existing_id < 0:
                self.map.add_observation(p_new, kf, kp)
            elif existing_id != p_new.id:
                existing = self.map.points.get(int(existing_id))
                if existing is None or existing.bad:
                    continue
                # keep the better-observed point
                keep, drop = (existing, p_new) if existing.n_obs >= p_new.n_obs else (p_new, existing)
                self.map.replace_point(drop, keep)

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: KeyFrame):
        """Drop redundant covisible keyframes: > 90% of their close points
        seen by >= 3 other keyframes (LocalMapping::KeyFrameCulling,
        LocalMapping.cc:683-760)."""
        for other_id in kf.covisible_keyframes():
            other = self.map.keyframes.get(other_id)
            if other is None or other.bad or other.id == 0 or other.not_erase:
                continue
            total = redundant = 0
            for p_id in other.map_point_ids:
                if p_id < 0:
                    continue
                p = self.map.points.get(int(p_id))
                if p is None or p.bad:
                    continue
                total += 1
                if p.n_obs >= 4:   # seen by >= 3 others
                    redundant += 1
            if total > 20 and redundant > 0.9 * total:
                self._erase_keyframe(other)

    def _erase_keyframe(self, kf: KeyFrame):
        """KeyFrame::SetBadFlag: drop its observations, re-parent its
        spanning-tree children, and erase it from the map (which removes
        it from every keyframe's covisibility)."""
        for p_id in kf.map_point_ids:
            if p_id < 0:
                continue
            p = self.map.points.get(int(p_id))
            if p is not None:
                p.observations.pop(kf.id, None)
        parent = self.map.keyframes.get(kf.parent) if kf.parent is not None else None
        for child_id in kf.children:
            child = self.map.keyframes.get(child_id)
            if child is not None:
                child.parent = kf.parent
                if parent is not None:
                    parent.children.add(child_id)
        if parent is not None:
            parent.children.discard(kf.id)
        kf.bad = True
        self.map.erase_keyframe(kf.id)

    # ------------------------------------------------------------------
    def local_bundle_adjust(self, kf: KeyFrame):
        """Pack + solve + write back at once."""
        pending = self.dispatch_bundle_adjust(kf)
        if pending is not None:
            self._apply_bundle_adjust(pending)

    def dispatch_bundle_adjust(self, kf: KeyFrame):
        """Pack the covisibility window and queue the device BA (no read
        back; see LocalMapperConfig.async_ba)."""
        with timing.span("ba_pack"):
            packed = self._pack_bundle_adjust(kf)
        if packed is None:
            return None
        args, obj_state, pending = packed
        start = self._timing_event()
        out = ba.bundle_adjust(*args, self.intrinsics, 1e-3, obj_state)
        stop = self._timing_event()
        host, event = _prefetch_to_host({"out": out})
        return {"host": host, "event": event, "timing": (start, stop), **pending}

    def _pack_bundle_adjust(self, kf: KeyFrame):
        """The window's BA inputs on the device: (the ten tensor arguments,
        obj_state or None, the slots the apply needs); None when there is
        nothing to solve.

        As the reference's local BA (Optimizer_util.cc:309-430): the window
        is optimized, and every other keyframe observing a window point
        joins as a fixed camera.
        """
        window_ids = self.map.local_keyframes(kf, BA_WINDOW - 1)[:BA_WINDOW]
        if len(window_ids) < 2:
            return None

        # points observed by the window, strongest first
        pt_ids = self.map.points_seen_by(window_ids)
        pt_ids.sort(key=lambda p: -self.map.points[p].n_obs)
        if len(pt_ids) > BA_PT_CAP:
            self.ba_pt_cap_hits += 1
            logging.getLogger(__name__).warning(
                "local BA point cap: %d observed, optimizing strongest %d", len(pt_ids), BA_PT_CAP)
        pt_ids = pt_ids[:BA_PT_CAP]

        # fixed observers: keyframes outside the window seeing window points
        window_set = set(window_ids)
        observer_counts: dict[int, int] = {}
        for p_id in pt_ids:
            for kf_id in self.map.points[p_id].observations:
                if kf_id not in window_set and kf_id in self.map.keyframes:
                    observer_counts[kf_id] = observer_counts.get(kf_id, 0) + 1
        fixed_ids = sorted(observer_counts, key=lambda k: -observer_counts[k])
        fixed_ids = fixed_ids[: BA_KF_CAP - len(window_ids)]

        all_ids = window_ids + fixed_ids
        kf_slot = {kf_id: i for i, kf_id in enumerate(all_ids)}
        K = BA_KF_CAP
        kf_poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        kf_fixed = np.ones(K, np.float32)     # padded + observer slots fixed
        for kf_id, i in kf_slot.items():
            kf_poses[i] = self.map.keyframes[kf_id].T_cw
            if kf_id in window_set:
                kf_fixed[i] = 0.0
        # gauge: fix the oldest window keyframe (and KF 0 if present)
        kf_fixed[kf_slot[min(window_ids)]] = 1.0
        if 0 in kf_slot:
            kf_fixed[kf_slot[0]] = 1.0
        pt_slot = {p_id: i for i, p_id in enumerate(pt_ids)}
        P = ba_point_bucket(len(pt_ids))
        points = np.zeros((P, 3), np.float32)
        pt_valid = np.zeros(P, np.float32)
        for p_id, i in pt_slot.items():
            points[i] = self.map.points[p_id].position
            pt_valid[i] = 1.0

        O = BA_OBS_PER_PT * P
        obs_kf = np.zeros(O, np.int32)
        obs_pt = np.zeros(O, np.int32)
        obs_uvr = np.zeros((O, 3), np.float32)
        obs_stereo = np.zeros(O, np.float32)
        obs_inv_s2 = np.ones(O, np.float32)
        obs_valid = np.zeros(O, np.float32)
        n_obs = 0
        obs_refs = []    # (kf_id, kp_idx, p_id) for the outliers' write-back
        for p_id in pt_ids:
            p = self.map.points[p_id]
            for kf_id, kp_idx in p.observations.items():
                if kf_id not in kf_slot or n_obs >= O:
                    continue
                okf = self.map.keyframes[kf_id]
                obs_kf[n_obs] = kf_slot[kf_id]
                obs_pt[n_obs] = pt_slot[p_id]
                ur = okf.u_right[kp_idx] if okf.u_right is not None else -1.0
                obs_uvr[n_obs, :2] = okf.feats["xy"][kp_idx]
                if ur > 0:
                    obs_uvr[n_obs, 2] = ur
                    obs_stereo[n_obs] = 1.0
                obs_inv_s2[n_obs] = 1.0 / okf.feats["sigma2"][kp_idx]
                obs_valid[n_obs] = 1.0
                obs_refs.append((kf_id, kp_idx, p_id))
                n_obs += 1
        if n_obs >= O:
            logging.getLogger(__name__).warning(
                "local BA observation cap reached (%d): remaining observations dropped "
                "from this solve", O)
        if n_obs < 20:
            return None

        # objects in the window -> joint BA edges
        d = self.device
        obj_state, obj_slot, obj_fixed, n_edges = None, None, None, 0
        obj_ids = []
        for kf_id in (window_ids if self.cfg.ba_objects else []):
            for obj_id in self.map.keyframes[kf_id].object_associations.values():
                obj = self.map.objects.get(obj_id)
                if obj is not None and not obj.bad and not obj.dynamic and obj_id not in obj_ids:
                    obj_ids.append(obj_id)
        obj_ids = obj_ids[:BA_OBJ_CAP]
        if obj_ids:
            obj_slot = {o: i for i, o in enumerate(obj_ids)}
            M, Q = BA_OBJ_CAP, BA_EDGE_CAP
            obj_poses = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
            obj_fixed = np.ones(M, np.float32)
            for o, i in obj_slot.items():
                obj_poses[i] = self.map.objects[o].T_wo_se3
                obj_fixed[i] = 0.0
            edge_kf = np.zeros(Q, np.int32)
            edge_obj = np.zeros(Q, np.int32)
            edge_Tco = np.tile(np.eye(4, dtype=np.float32), (Q, 1, 1))
            edge_valid = np.zeros(Q, np.float32)
            for o in obj_ids:
                for kf_id, det_idx in self.map.objects[o].observations.items():
                    if kf_id not in kf_slot or n_edges >= Q:
                        continue
                    T_co = getattr(self.map.keyframes[kf_id].detections[det_idx], "T_co_se3_measured", None)
                    if T_co is None:
                        continue
                    edge_kf[n_edges] = kf_slot[kf_id]
                    edge_obj[n_edges] = obj_slot[o]
                    edge_Tco[n_edges] = T_co
                    edge_valid[n_edges] = 1.0
                    n_edges += 1
            if n_edges > 0:
                obj_state = {"poses": obj_poses, "fixed": obj_fixed, "edge_kf": edge_kf,
                             "edge_obj": edge_obj, "edge_Tco": edge_Tco, "edge_valid": edge_valid}
                obj_state = {k: to_torch(v, d) for k, v in obj_state.items()}
            else:
                obj_slot = obj_fixed = None

        args = tuple(to_torch(a, d) for a in (kf_poses, kf_fixed, points, pt_valid, obs_kf, obs_pt, obs_uvr,
                                              obs_stereo, obs_inv_s2, obs_valid))
        return args, obj_state, {
            "kf_slot": kf_slot, "kf_fixed": kf_fixed, "pt_slot": pt_slot, "obs_refs": obs_refs,
            "obs_valid": obs_valid, "obj_slot": obj_slot, "obj_fixed": obj_fixed, "n_edges": n_edges,
        }

    def _apply_bundle_adjust(self, pending):
        """Read back + write, never with a diverged solution, and never onto
        entities erased (culled / fused) since dispatch."""
        out = _host_result(pending["host"], pending["event"])["out"]
        start, stop = pending["timing"]
        self.ba_log.append({
            "n_edges": pending["n_edges"],
            "edge_inliers": int(out["obj_edge_inlier"].sum()) if pending["obj_slot"] is not None else 0,
            "device_ms": start.elapsed_time(stop) if start is not None else None,
        })
        kf_slot, kf_fixed = pending["kf_slot"], pending["kf_fixed"]
        new_poses, new_pts_all = out["kf_poses"], out["points"]
        if not (np.isfinite(new_poses).all() and np.isfinite(new_pts_all).all()):
            return
        for kf_id, i in kf_slot.items():
            okf = self.map.keyframes.get(kf_id)
            if okf is not None and not okf.bad and kf_fixed[i] == 0.0:
                okf.T_cw = new_poses[i]
        for p_id, i in pending["pt_slot"].items():
            p = self.map.points.get(p_id)
            if p is not None and not p.bad:
                p.position = new_pts_all[i]
        inlier = out["obs_inlier"]
        obs_valid = pending["obs_valid"]
        for i, (kf_id, kp_idx, p_id) in enumerate(pending["obs_refs"]):
            if obs_valid[i] > 0 and inlier[i] == 0:
                p = self.map.points.get(p_id)
                okf = self.map.keyframes.get(kf_id)
                if p is not None and okf is not None:
                    p.observations.pop(kf_id, None)
                    if okf.map_point_ids[kp_idx] == p_id:
                        okf.map_point_ids[kp_idx] = -1
                    if p.n_obs == 0:
                        self.map.erase_point(p_id)
        if pending["obj_slot"] is not None:
            new_obj, obj_fixed = out["obj_poses"], pending["obj_fixed"]
            for o, i in pending["obj_slot"].items():
                obj = self.map.objects.get(o)
                if obj is not None and not obj.bad and obj_fixed[i] == 0.0:
                    obj.set_pose_se3(new_obj[i])
