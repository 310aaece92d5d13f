"""Monocular object pipeline: shape reconstruction supported by map points.

Port of dspslam_tpu/objects/mono_pipeline.py, the reference's mono
LocalMapping stages (LocalMapping_util.cc:210-438):

* CreateNewObjectsFromDetections: keypoints inside a detection's mask vote
  with their map points; a detection whose points belong to an existing
  object associates to it, otherwise a new (shape-less) MapObject is born
  owning those points;
* ProcessDetectedObjects: after a warm-up (~15 keyframes of point
  accumulation) and every 5th keyframe, an object's pose is seeded from the
  PCA cuboid of its member points (objects/cuboid.py), and the joint
  Sim(3) + code GN runs with the member points as surface evidence and the
  detection's background rays as render evidence. A first reconstruction
  tries the seed and its 180-degree flip (LocalMapping_util.cc:396-407) as
  one B = 2 call of the batched GN and keeps the lower-loss result, the
  first on a tie, as the JAX package's two calls do.

With the canonical decoder on the card every GN iteration launches kernel
K1 twice (surface points, then the render-Jacobian rows); `gn_calls`
counts the calls and `expected_k1_launches()` turns them into launches.
Meshes are extracted synchronously.
"""

from __future__ import annotations

import numpy as np

from ..shape import gn, mesh as mesh_mod
from ..slam.map import Map, MapObject, to_torch
from . import cuboid
from .detections import Detection
from .pipeline import _decoder_device, _record_event

MIN_POINTS_RECON = 50
MIN_RAYS_RECON = 20
WARMUP_KFS = 15
RECON_EVERY = 5
MIN_VOTES = 5


class MonoObjectPipeline:
    # association votes with map points inside the detection mask, so the
    # LocalMapper applies a keyframe's triangulation before apply_keyframe
    # and never defers keyframe work
    uses_map_points = True

    def __init__(self, slam_map: Map, decoder, gn_config: gn.GNConfig, max_surface_points: int = 256,
                 max_rays: int = 512, extract_meshes: bool = True, voxels_dim: int = 64,
                 warmup_kfs: int = WARMUP_KFS, recon_every: int = RECON_EVERY):
        self.map = slam_map
        self.decoder = decoder
        self.device = _decoder_device(decoder)
        self.cfg = gn_config
        self.caps = (max_surface_points, max_rays)
        self.recon = gn.batched_reconstruct(decoder, gn_config)
        self.extract_meshes = extract_meshes
        self.mesher = mesh_mod.MeshExtractor(decoder, gn_config.code_len, voxels_dim, self.device)
        self.warmup_kfs = warmup_kfs
        self.recon_every = recon_every
        self.kf_count = 0
        self.reconstructed: set[int] = set()
        # joint GN calls made (a first reconstruction's two candidates are
        # one call) and their batch sizes
        self.gn_calls = 0
        self.gn_batches: list[int] = []
        # ms between CUDA events around each GN call's launches (the card
        # only)
        self.gn_device_ms: list[float] = []

    def expected_k1_launches(self) -> int:
        """K1 launches the counted GN calls make with the canonical decoder
        on the card: two per iteration."""
        return 2 * self.cfg.num_iterations * self.gn_calls

    # ------------------------------------------------------------------
    def process_keyframe(self, kf, local_kf_ids=None):
        self.kf_count += 1
        if not kf.detections:
            return
        self._associate_or_create(kf)
        if self.kf_count >= self.warmup_kfs and self.kf_count % self.recon_every == 0:
            self._reconstruct_ready(kf)

    # The LocalMapper's dispatch / apply split: association votes with the
    # keyframe's fresh map points, so the whole stage runs at apply time,
    # after the keyframe's triangulation; there is nothing to overlap.
    def dispatch_keyframe(self, kf, local_kf_ids=None):
        return None

    def apply_keyframe(self, kf, pending):
        self.process_keyframe(kf)

    # ------------------------------------------------------------------
    def _points_in_mask(self, kf, det: Detection):
        """Map-point ids whose keypoints fall inside the detection mask."""
        if det.mask is None:
            return []
        h, w = det.mask.shape
        out = []
        for kp_i in np.nonzero(kf.map_point_ids >= 0)[0]:
            x, y = kf.feats["xy"][kp_i].astype(np.int64)
            if 0 <= x < w and 0 <= y < h and det.mask[y, x]:
                out.append(int(kf.map_point_ids[kp_i]))
        return out

    def _associate_or_create(self, kf):
        for det_idx, det in enumerate(kf.detections):
            pt_ids = self._points_in_mask(kf, det)
            if len(pt_ids) < MIN_VOTES:
                continue
            votes: dict[int, int] = {}
            free_pts = []
            for p_id in pt_ids:
                p = self.map.points.get(p_id)
                if p is None or p.bad:
                    continue
                if p.in_any_object:
                    votes[p.object_id] = votes.get(p.object_id, 0) + 1
                else:
                    free_pts.append(p)
            best = max(votes, key=votes.get) if votes else None
            if best is not None and votes[best] >= MIN_VOTES and best in self.map.objects:
                obj = self.map.objects[best]
            else:
                obj = MapObject(np.eye(4, dtype=np.float32), np.zeros(self.cfg.code_len, np.float32), kf.id)
                obj.has_valid_pose = False
                self.map.add_object(obj)
            obj.observations[kf.id] = det_idx
            kf.object_associations[det_idx] = obj.id
            for p in free_pts:
                p.in_any_object = True
                p.object_id = obj.id
                p.keyframe_id_added_to_object = kf.id
                obj.point_ids.add(p.id)

    # ------------------------------------------------------------------
    def _member_points_world(self, obj):
        pts = [
            self.map.points[p].position for p in obj.point_ids
            if p in self.map.points and not self.map.points[p].bad
            and not self.map.points[p].outlier_in_object
        ]
        return np.stack(pts) if pts else np.zeros((0, 3), np.float32)

    def _reconstruct_ready(self, kf):
        for det_idx, obj_id in kf.object_associations.items():
            obj = self.map.objects.get(obj_id)
            det = kf.detections[det_idx]
            if obj is None or obj.bad:
                continue
            pts_w = self._member_points_world(obj)
            n_rays = 0 if det.rays is None else len(det.rays)
            if len(pts_w) < MIN_POINTS_RECON or n_rays <= MIN_RAYS_RECON:
                continue
            pca = cuboid.compute_cuboid_pca(pts_w)
            if pca is None:
                continue
            # flag PCA outliers on the member points
            for p_id, keep in zip(sorted(obj.point_ids), pca["inlier_mask"]):
                p = self.map.points.get(p_id)
                if p is not None and not keep:
                    p.outlier_in_object = True

            if obj_id not in self.reconstructed:
                # keep member points inside the decoder's valid domain (the
                # 0.40 * l car prior underestimates on sparse mono clouds)
                T_seed = cuboid.floor_scale_to_domain(pca["T_wo_sim3"], pts_w)
                candidates = [T_seed, cuboid.flipped_pose(T_seed)]
            else:
                candidates = [obj.T_wo]
            best = self._best_of(self._run_gn(kf, det, pts_w, candidates, obj.code))
            if best is None or not best["is_good"]:
                continue
            obj.set_pose_sim3((np.linalg.inv(kf.T_cw) @ best["t_cam_obj"]).astype(np.float32))
            obj.last_measured_kf_id = kf.id
            obj.last_measured_frame_id = kf.frame_id
            obj.code = best["code"]
            obj.has_valid_pose = True
            self.reconstructed.add(obj_id)
            if self.extract_meshes:
                m = self.mesher.extract_mesh_from_code(obj.code)
                obj.vertices, obj.faces = m["vertices"], m["faces"]

    @staticmethod
    def _best_of(results: list) -> dict | None:
        """The lowest-loss finite result, the first on a tie."""
        best = None
        for res in results:
            if not np.isfinite(res["t_cam_obj"]).all():
                continue
            if best is None or res["loss"] < best["loss"]:
                best = res
        return best

    def _run_gn(self, kf, det, pts_w, T_wo_candidates, code) -> list[dict]:
        """One joint GN call over the candidate initial poses (B of them),
        with the member points (camera frame) as surface evidence and the
        detection's rays as render evidence. Returns one numpy dict per
        candidate."""
        P, R = self.caps
        B = len(T_wo_candidates)
        pts_c = pts_w @ kf.T_cw[:3, :3].T + kf.T_cw[:3, 3]
        pts = np.zeros((P, 3), np.float32)
        mask = np.zeros(P, np.float32)
        n = min(len(pts_c), P)
        pts[:n] = pts_c[:n]
        mask[:n] = 1.0
        rays = np.zeros((R, 3), np.float32)
        ray_mask = np.zeros(R, np.float32)
        fg = np.zeros(R, np.float32)
        depth = np.zeros(R, np.float32)
        m = min(len(det.rays), R)
        rays[:m] = det.rays[:m]
        ray_mask[:m] = 1.0
        nf = min(det.num_foreground, m)
        fg[:nf] = 1.0
        if det.depth is not None and len(det.depth):
            depth[:nf] = det.depth[:nf]
        T_co = np.stack([kf.T_cw @ T for T in T_wo_candidates]).astype(np.float32)

        def batch(a):
            return to_torch(np.repeat(a[None], B, axis=0), self.device)

        codes = np.asarray(code, np.float32)[: self.cfg.code_len]
        args = [to_torch(T_co, self.device)] + [batch(a) for a in (pts, mask, rays, ray_mask, depth, fg, codes)]
        start = _record_event(self.device, timing=True)
        out = self.recon(*args)
        stop = _record_event(self.device, timing=True)
        self.gn_calls += 1
        self.gn_batches.append(B)
        res = {k: v.cpu().numpy() for k, v in out.items()}
        if start is not None:
            self.gn_device_ms.append(start.elapsed_time(stop))
        return [{"t_cam_obj": res["t_cam_obj"][b], "code": res["code"][b],
                 "is_good": bool(res["is_good"][b]), "loss": float(res["loss"][b])} for b in range(B)]
