"""Relocalization after tracking loss.

Port of dspslam_tpu/slam/relocalization.py (Tracking::Relocalization,
Tracking.cc:1374-1504): BoW candidates from the keyframe database (the
top 5 scoring >= 0.05), 2D-3D correspondences from descriptor matching
against each candidate's map points (`matcher.match_features` on the
device), a wide-baseline initial pose from RANSAC PnP on the host
(`slam.pnp`, the candidate's pose when it is degenerate), then the robust
GN pose optimizer (`slam.pose_opt`) at a fixed POINT_CAP.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend import matcher
from . import pnp, pose_opt
from .map import entry_device, to_torch

MIN_INLIERS = 20
POINT_CAP = 2048


class Relocalizer:
    def __init__(self, slam_map, voc, db, intrinsics, device=None):
        self.map = slam_map
        self.voc = voc
        self.db = db
        self.device = entry_device(device, "Relocalizer")
        self.intrinsics_np = np.asarray(intrinsics, np.float32)
        self.intrinsics = torch.from_numpy(self.intrinsics_np.copy()).to(self.device)

    def try_relocalize(self, frame) -> bool:
        """Attempt pose recovery; sets frame.T_cw and map_point_ids on
        success. Returns True if relocalized."""
        bow = self.voc.bow_vector(frame.feats_torch(self.device)["desc"], frame.feats["valid"])
        candidates = self.db.query(bow, 0.05, exclude=set())[:5]
        for cand_id, _score in candidates:
            kf = self.map.keyframes.get(cand_id)
            if kf is None or kf.bad:
                continue
            if self._solve_against(frame, kf):
                return True
        return False

    def _solve_against(self, frame, kf) -> bool:
        idx, _ = matcher.match_features(
            frame.feats_torch(self.device), kf.feats_torch(self.device), max_dist=matcher.TH_LOW,
        )
        idx = idx.cpu().numpy()
        pairs = []     # (frame_kp, map_point)
        for i in np.nonzero(idx >= 0)[0]:
            p_id = kf.map_point_ids[idx[i]]
            if p_id < 0:
                continue
            p = self.map.points.get(int(p_id))
            if p is not None and not p.bad:
                pairs.append((i, p))
        if len(pairs) < MIN_INLIERS:
            return False
        # wide-baseline initial pose from RANSAC PnP (PnPsolver parity);
        # falls back to the candidate keyframe's pose when degenerate
        fx, fy, cx, cy = (float(v) for v in self.intrinsics_np[:4])
        K_mat = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        pts3 = np.stack([p.position for _, p in pairs])
        uv = np.stack([frame.feats["xy"][kp_i] for kp_i, _ in pairs])
        T_init, _ = pnp.ransac_pnp(pts3, uv, K_mat)
        T_start = T_init if T_init is not None else kf.T_cw
        n = min(len(pairs), POINT_CAP)
        pts_w = np.zeros((POINT_CAP, 3), np.float32)
        obs = np.zeros((POINT_CAP, 3), np.float32)
        inv_s2 = np.ones(POINT_CAP, np.float32)
        vmask = np.zeros(POINT_CAP, np.float32)
        smask = np.zeros(POINT_CAP, np.float32)
        for j, (kp_i, p) in enumerate(pairs[:n]):
            pts_w[j] = p.position
            obs[j, :2] = frame.feats["xy"][kp_i]
            ur = frame.u_right[kp_i] if frame.u_right is not None else -1.0
            if ur > 0:
                obs[j, 2] = ur
                smask[j] = 1.0
            inv_s2[j] = 1.0 / frame.feats["sigma2"][kp_i]
            vmask[j] = 1.0
        dev = self.device
        T, inlier, n_in = pose_opt.optimize_pose(
            to_torch(np.asarray(T_start, np.float32), dev), to_torch(pts_w, dev),
            to_torch(obs, dev), to_torch(inv_s2, dev), to_torch(vmask, dev),
            to_torch(smask, dev), self.intrinsics,
        )
        if int(n_in) < MIN_INLIERS:
            return False
        T = T.cpu().numpy()
        if not np.isfinite(T).all():
            return False
        frame.T_cw = T
        inlier = inlier.cpu().numpy()
        frame.map_point_ids[:] = -1
        for j, (kp_i, p) in enumerate(pairs[:n]):
            if inlier[j] > 0:
                frame.map_point_ids[kp_i] = p.id
        return True
