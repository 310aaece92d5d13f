"""Per-keyframe object pipeline: associate -> pose-only GN -> full recon.

Port of dspslam_tpu/objects/pipeline.py, the host orchestration of the
reference's LocalMapping object stages (LocalMapping.cc:89-107 +
LocalMapping_util.cc):

* GetNewObservations: detections associated to existing objects get the
  pose-only SE(3) GN against the object's code (one batched call), then
  static / dynamic / false-association triage (LocalMapping_util.cc:84-154);
  re-observed static objects also get a warm-started joint refinement;
* CreateNewMapObjects: unassociated detections get the joint Sim(3) + code
  GN in one batched call and become MapObjects with a deferred mesh
  (LocalMapping_util.cc:156-205).

The batch is padded to a power-of-2 bucket (`_bucket`). With the canonical
decoder on the card every GN iteration runs kernel K1: once per pose-only
iteration, twice per joint iteration. `dispatches` counts the calls.
Host preparation (the association, and each call's padding and upload)
is the `obj_prep` span (`utils.timing`).

The dynamic-object prediction horizon is the gap since the object's last
MEASURED keyframe (`MapObject.last_measured_frame_id`). The JAX package
uses the gap since the pipeline's previous keyframe, which is wrong when
the object went unmeasured in between (ROADMAP fault R3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..shape import gn, mesh as mesh_mod
from ..slam.map import Map, MapObject, to_torch
from ..utils import timing
from . import association
from .detections import Detection, pad_detections


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


MIN_PTS_RECON = 50
# Recent-object culling (MapObjectCulling, LocalMapping_util.cc:29-62): a
# static object must accumulate MORE than CULL_MAX_OBS keyframe
# observations within CULL_WINDOW_KFS keyframes of creation or it is culled.
CULL_MAX_OBS = 2
CULL_WINDOW_KFS = 2


def _decoder_device(decoder) -> torch.device:
    for t in list(decoder.parameters()) + list(decoder.buffers()):
        return t.device
    return torch.device("cpu")


def results_ready(tree) -> bool:
    """True when every CUDA event in a pending result (nested tuples,
    lists and dicts) has completed; results without events (the CPU) are
    ready."""
    if isinstance(tree, torch.cuda.Event):
        return tree.query()
    if isinstance(tree, dict):
        return all(results_ready(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return all(results_ready(v) for v in tree)
    return True


def _record_event(device: torch.device, timing: bool = False):
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=timing)
    event.record()
    return event


def _numpy(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


class ObjectPipeline:
    def __init__(self, slam_map: Map, decoder, gn_config: gn.GNConfig, max_detections: int = 8,
                 max_surface_points: int = 256, max_rays: int = 512, extract_meshes: bool = True,
                 voxels_dim: int = 32, calibrate_scale_init: bool = True,
                 max_shape_refinements: int = 6):
        self.map = slam_map
        self.decoder = decoder
        self.device = _decoder_device(decoder)
        self.cfg = gn_config
        self.caps = (max_detections, max_surface_points, max_rays)
        self.batched_recon = gn.batched_reconstruct(decoder, gn_config)
        self.batched_pose = gn.batched_estimate_pose(decoder, gn_config)
        # warm-started joint re-reconstructions per static object, bounded
        # (the reference re-runs reconstruct_object on every observation,
        # LocalMapping_util.cc:391)
        self.max_shape_refinements = max_shape_refinements
        # the zero code's surface radius seeds new objects' scale
        self.canonical_half_extent = (
            self._measure_canonical_half_extent() if calibrate_scale_init else None
        )
        self.extract_meshes = extract_meshes
        self.mesher = mesh_mod.MeshExtractor(decoder, gn_config.code_len, voxels_dim, self.device)
        # frame id of the previously processed keyframe
        self.last_kf_frame_id: int | None = None
        # deferred mesh extractions: (obj, mesher handle)
        self._pending_meshes: list = []
        # |predicted - measured| center per dynamic update (m)
        self.dyn_pred_errs: list[float] = []
        # GN calls: "measure" (pose-only), "recon" and "refine" (joint)
        self.dispatches = {"measure": 0, "recon": 0, "refine": 0}
        # device ms of each keyframe's GN calls (CUDA events; the card only)
        self.gn_device_ms: list[float] = []

    def _t(self, a) -> torch.Tensor:
        return to_torch(np.asarray(a, np.float32), self.device)

    def expected_k1_launches(self) -> int:
        """K1 launches the counted GN calls make with the canonical decoder
        on the card: one per pose-only iteration, two per joint iteration."""
        c = self.cfg
        return (c.pose_only_iterations * self.dispatches["measure"]
                + 2 * c.num_iterations * (self.dispatches["recon"] + self.dispatches["refine"]))

    # ------------------------------------------------------------------
    def meshes_ready(self) -> bool:
        return not self._pending_meshes or self.mesher.ready(self._pending_meshes[0][1])

    def collect_meshes(self, limit: int | None = None):
        """Finalize deferred mesh extractions (the local mapper's idle polls
        take one at a time; flush() drains the rest)."""
        n = len(self._pending_meshes) if limit is None else min(limit, len(self._pending_meshes))
        pending, self._pending_meshes = self._pending_meshes[:n], self._pending_meshes[n:]
        for obj, handle in pending:
            if obj.bad:
                continue
            m = self.mesher.collect(handle)
            obj.vertices, obj.faces = m["vertices"], m["faces"]

    def dispatch_keyframe(self, kf, local_kf_ids: list[int]):
        """Associate detections (host) and queue both GN calls without
        reading their results; apply_keyframe reads them."""
        with timing.span("obj_prep"):
            frame_gap = (
                float(kf.frame_id - self.last_kf_frame_id) if self.last_kf_frame_id is not None else 1.0
            )
            self.last_kf_frame_id = kf.frame_id
            if not kf.detections:
                return None
            local_objects = self._local_objects(local_kf_ids)
            assoc, new_idx, bad_idx = association.associate_detections_centroid(
                kf, local_objects, kf.T_cw, frame_gap=max(frame_gap, 1.0)
            )
        start = _record_event(self.device, timing=True)
        measured = self._dispatch_measure(kf, assoc, frame_gap)
        recon = self._dispatch_recon(kf, [i for i in new_idx if i not in bad_idx])
        return {"measured": measured, "recon": recon, "frame_gap": frame_gap,
                "timing": (start, _record_event(self.device, timing=True))}

    def apply_keyframe(self, kf, pending):
        if pending is not None:
            self._apply_measure(kf, pending["measured"], pending["frame_gap"])
            self._apply_recon(kf, pending["recon"])
            start, stop = pending["timing"]
            if start is not None and (pending["measured"] or pending["recon"]):
                stop.synchronize()
                self.gn_device_ms.append(start.elapsed_time(stop))
        self._cull_objects(kf)

    def _local_objects(self, kf_ids):
        objs, seen = [], set()
        for kf_id in kf_ids:
            kf = self.map.keyframes.get(kf_id)
            if kf is None:
                continue
            for obj_id in kf.object_associations.values():
                if obj_id in seen:
                    continue
                seen.add(obj_id)
                obj = self.map.objects.get(obj_id)
                if obj is not None and not obj.bad:
                    objs.append(obj)
        return objs

    def _horizon(self, obj, kf, frame_gap: float) -> float:
        """Frames since the object's last measured keyframe (fault R3's
        fix); the gap since the previous keyframe when it was never
        measured."""
        frame_id = obj.last_measured_frame_id
        if frame_id is None and obj.last_measured_kf_id is not None:
            measured_kf = self.map.keyframes.get(obj.last_measured_kf_id)
            frame_id = None if measured_kf is None else measured_kf.frame_id
        return frame_gap if frame_id is None else float(kf.frame_id - frame_id)

    @staticmethod
    def _stamp_measured(obj, kf):
        obj.last_measured_kf_id = kf.id
        obj.last_measured_frame_id = kf.frame_id

    # ------------------------------------------------------------------
    def _measure_canonical_half_extent(self):
        """Median surface radius of the zero-code shape on a coarse SDF
        grid, used to seed new objects' scale."""
        dim = 33
        code = torch.zeros(self.cfg.code_len, device=self.device)
        sdf = mesh_mod.decode_sdf_grid(self.decoder, code, dim).cpu().numpy()
        spacing = 2.0 / (dim - 1)
        idx = np.argwhere(np.abs(sdf) < spacing)      # near-surface band
        if len(idx) == 0:
            return None
        pts = idx * spacing - 1.0
        return float(np.median(np.linalg.norm(pts, axis=-1)))

    def _calibrated_t_init(self, t_init, dets):
        """Rescale each detection's initial Sim(3) so the zero-code surface
        starts at the median distance of its surface points from its
        center."""
        r0 = self.canonical_half_extent
        if r0 is None or r0 < 1e-3:
            return t_init
        for slot, det in enumerate(dets):
            pts = getattr(det, "surface_points", None)
            n = getattr(det, "num_surface_points", 0)
            if pts is None or n < MIN_PTS_RECON:
                continue
            center = t_init[slot, :3, 3]
            r_obs = float(np.median(np.linalg.norm(np.asarray(pts[:n]) - center, axis=-1)))
            s_det = float(np.linalg.det(t_init[slot, :3, :3])) ** (1 / 3)
            s_star = r_obs / r0
            if s_det > 1e-6 and s_star > 1e-6:
                t_init[slot, :3, :3] *= s_star / s_det
        return t_init

    def _dispatch_measure(self, kf, assoc, frame_gap: float = 1.0):
        """Pose-only GN for all associated detections in one batched call
        (queued only). Dynamic objects start from the constant-velocity
        prediction over their own horizon."""
        with timing.span("obj_prep"):
            entries = [
                (det_idx, obj) for det_idx, obj in assoc.items()
                if kf.detections[det_idx].num_surface_points >= association.MIN_PTS_ASSOCIATED
            ]
            if not entries:
                return None
            P = self.caps[1]
            entries = entries[: self.caps[0]]
            B = _bucket(len(entries), self.caps[0])
            t_init = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
            scales = np.ones(B, np.float32)
            pts = np.zeros((B, P, 3), np.float32)
            mask = np.zeros((B, P), np.float32)
            codes = np.zeros((B, self.cfg.code_len), np.float32)
            for i, (det_idx, obj) in enumerate(entries):
                det: Detection = kf.detections[det_idx]
                n = min(det.num_surface_points, P)
                pts[i, :n] = det.surface_points[:n]
                mask[i, :n] = 1.0
                T_wo = obj.T_wo_se3
                if obj.dynamic:
                    T_wo = T_wo.copy()
                    T_wo[:3, 3] = T_wo[:3, 3] + obj.velocity * self._horizon(obj, kf, frame_gap)
                t_init[i] = (kf.T_cw @ T_wo).astype(np.float32)
                scales[i] = obj.scale
                codes[i] = obj.code[: self.cfg.code_len]
            args = [self._t(a) for a in (t_init, scales, pts, mask, codes)]
        out = self.batched_pose(*args)
        self.dispatches["measure"] += 1
        return entries, out, self._dispatch_refine(kf, entries)

    def _dispatch_refine(self, kf, entries):
        """Warm-started joint recon for re-observed static objects (queued
        only; applied for detections the triage keeps static)."""
        with timing.span("obj_prep"):
            cand = [
                (det_idx, obj) for det_idx, obj in entries
                if not obj.dynamic
                and obj.n_shape_refinements < self.max_shape_refinements
                and kf.detections[det_idx].rays is not None
                and kf.detections[det_idx].num_surface_points >= MIN_PTS_RECON
            ]
            if not cand:
                return None
            B_cap, P, R = self.caps
            cand = cand[:B_cap]
            B = _bucket(len(cand), B_cap)
            batch = pad_detections([kf.detections[i] for i, _ in cand], B, P, R)
            t_init = np.asarray(batch["t_cam_obj"]).copy()
            codes = np.zeros((B, self.cfg.code_len), np.float32)
            for slot, (_, obj) in enumerate(cand):
                t_init[slot] = (kf.T_cw @ obj.T_wo).astype(np.float32)
                codes[slot] = obj.code[: self.cfg.code_len]
            args = self._recon_inputs(t_init, batch, codes)
        out = self.batched_recon(*args)
        self.dispatches["refine"] += 1
        return cand, out

    def _recon_inputs(self, t_init, batch, codes):
        """A joint GN call's arguments on the device."""
        return [self._t(a) for a in (t_init, batch["pts"], batch["pts_mask"], batch["rays"],
                                     batch["ray_mask"], batch["depth"], batch["fg_mask"], codes)]

    def _apply_measure(self, kf, pending, frame_gap: float = 1.0):
        """Apply the pose-only GN results with the reference's
        static / dynamic / false-association triage (GetNewObservations,
        LocalMapping_util.cc:100-151)."""
        if pending is None:
            return
        entries, out, refine = pending
        t_all = out["t_cam_obj"].cpu().numpy()
        T_wc = np.linalg.inv(kf.T_cw)
        static_dets: set[int] = set()
        for i, (det_idx, obj) in enumerate(entries):
            T_co = t_all[i]
            if not np.all(np.isfinite(T_co)):
                continue
            verdict = association.classify_measurement(obj, T_co, kf.T_cw)
            if verdict == association.STATIC_MEASUREMENT:
                static_dets.add(det_idx)
                kf.detections[det_idx].T_co_se3_measured = T_co
                obj.set_pose_se3((T_wc @ T_co).astype(np.float32))
                self._stamp_measured(obj, kf)
            elif verdict == association.DYNAMIC_UPDATE:
                horizon = self._horizon(obj, kf, frame_gap)
                if obj.dynamic:
                    # constant-velocity prediction quality at this keyframe
                    pred = obj.T_wo_se3[:3, 3] + obj.velocity * horizon
                    meas = (T_wc @ T_co)[:3, 3]
                    self.dyn_pred_errs.append(float(np.linalg.norm(pred - meas)))
                else:
                    obj.dynamic = True
                    self.map.n_dynamic_objects += 1
                association.update_dynamic_object(obj, T_co, kf.T_cw, horizon)
                self._stamp_measured(obj, kf)
            else:  # DISASSOCIATE: a mature static object jumped
                kf.object_associations.pop(det_idx, None)
                obj.observations.pop(kf.id, None)
                continue
            obj.n_observed += 1
        self._apply_refine(kf, refine, static_dets)

    def _apply_refine(self, kf, refine, static_dets: set):
        """Write back warm-started re-reconstructions for detections the
        triage kept static (UpdateReconstruction, LocalMapping_util.cc:
        425-430); the mesh re-extracts, deferred."""
        if refine is None:
            return
        cand, out = refine
        res = _numpy(out)
        T_wc = np.linalg.inv(kf.T_cw)
        for slot, (det_idx, obj) in enumerate(cand):
            if (det_idx not in static_dets or obj.bad or obj.dynamic or not res["is_good"][slot]
                    or not np.all(np.isfinite(res["t_cam_obj"][slot]))):
                continue
            obj.set_pose_sim3((T_wc @ res["t_cam_obj"][slot]).astype(np.float32))
            obj.code = res["code"][slot].astype(np.float32)
            obj.n_shape_refinements += 1
            kf.detections[det_idx].T_co_se3_measured = self._se3_of(res["t_cam_obj"][slot])
            if self.extract_meshes:
                self._pending_meshes.append((obj, self.mesher.dispatch(obj.code)))

    # ------------------------------------------------------------------
    def _dispatch_recon(self, kf, new_indices):
        """Batched joint GN on all new detections (queued only)."""
        with timing.span("obj_prep"):
            dets, det_map = [], []
            for i in new_indices:
                det: Detection = kf.detections[i]
                if det.is_front and det.rays is not None and det.num_surface_points >= MIN_PTS_RECON:
                    dets.append(det)
                    det_map.append(i)
            if not dets:
                return None
            B_cap, P, R = self.caps
            B = _bucket(len(dets), B_cap)
            batch = pad_detections(dets, B, P, R)
            t_init = self._calibrated_t_init(np.asarray(batch["t_cam_obj"]).copy(), dets)
            args = self._recon_inputs(t_init, batch, np.zeros((B, self.cfg.code_len), np.float32))
        out = self.batched_recon(*args)
        self.dispatches["recon"] += 1
        return det_map, out

    def _apply_recon(self, kf, pending):
        if pending is None:
            return
        det_map, out = pending
        res = _numpy(out)
        t_cam_obj, codes, good = res["t_cam_obj"], res["code"], res["is_good"]
        T_wc = np.linalg.inv(kf.T_cw)
        for slot, det_idx in enumerate(det_map[: t_cam_obj.shape[0]]):
            if not good[slot] or not np.all(np.isfinite(t_cam_obj[slot])):
                continue
            obj = MapObject((T_wc @ t_cam_obj[slot]).astype(np.float32), codes[slot], kf.id)
            obj.observations[kf.id] = det_idx
            self._stamp_measured(obj, kf)
            kf.object_associations[det_idx] = obj.id
            kf.detections[det_idx].T_co_se3_measured = self._se3_of(t_cam_obj[slot])
            self.map.add_object(obj)
            self._tag_member_points(kf, det_idx, obj)
            if self.extract_meshes:
                # the voxel decode is queued now; marching tetrahedra runs at
                # an idle poll or at flush, off the keyframe's critical path
                self._pending_meshes.append((obj, self.mesher.dispatch(obj.code)))

    @staticmethod
    def _se3_of(T_sim3):
        s = np.linalg.det(T_sim3[:3, :3]) ** (1.0 / 3.0)
        T = T_sim3.copy()
        T[:3, :3] /= s
        return T.astype(np.float32)

    def _tag_member_points(self, kf, det_idx, obj):
        """Mark map points inside the detection mask as object members
        (MapPoint.h:85-88)."""
        det = kf.detections[det_idx]
        if det.mask is None:
            return
        h, w = det.mask.shape
        for kp_i in np.nonzero(kf.map_point_ids >= 0)[0]:
            x, y = kf.feats["xy"][kp_i].astype(np.int64)
            if 0 <= x < w and 0 <= y < h and det.mask[y, x]:
                p = self.map.points.get(int(kf.map_point_ids[kp_i]))
                if p is not None and not p.in_any_object:
                    p.in_any_object = True
                    p.object_id = obj.id
                    p.keyframe_id_added_to_object = kf.id
                    obj.point_ids.add(p.id)

    # ------------------------------------------------------------------
    def _cull_objects(self, kf):
        """Drop stale low-evidence objects (MapObjectCulling rules,
        LocalMapping_util.cc:29-82): dynamic objects unseen for >= 2
        keyframes; recent static objects without more than CULL_MAX_OBS
        observations within CULL_WINDOW_KFS keyframes of creation."""
        for obj in list(self.map.objects.values()):
            if obj.bad:
                continue
            if obj.dynamic:
                newest = max(obj.observations) if obj.observations else obj.ref_kf_id
                if kf.id - newest >= 2:
                    self.map.erase_object(obj.id)
                    self.map.n_dynamic_objects -= 1
                continue
            age = kf.id - obj.ref_kf_id
            if CULL_WINDOW_KFS <= age < CULL_WINDOW_KFS + 2 and len(obj.observations) <= CULL_MAX_OBS:
                self.map.erase_object(obj.id)
