"""Detection -> MapObject data association.

A copy of dspslam_tpu/objects/association.py (host numpy). Host-side
re-expression of the reference's two association mechanisms:

* centroid gating (Tracking::ObjectDataAssociation, Tracking_util.cc:
  59-152): each new detection matches the nearest local map object by
  horizontal (x, z) camera-frame distance, with a 5 m gate, constant-
  velocity prediction for dynamic objects, and best-detection-wins when
  two detections compete for one object;
* map-point voting (Tracking::AssociateObjectsByProjection,
  Tracking_util.cc:209-287, mono): keypoints inside the detection mask
  vote with their map points' object ids.
"""

from __future__ import annotations

import numpy as np

ASSOC_GATE = 5.0       # meters, loose association gate
MIN_PTS_ASSOCIATED = 25
MIN_PTS_NEW = 50


def associate_detections_centroid(
    kf,                      # slam.map.KeyFrame with .detections set
    local_objects: list,     # list of MapObject candidates
    T_cw: np.ndarray,
    frame_gap: float = 1.0,
):
    """Greedy nearest-centroid gating. Mutates kf.object_associations and
    returns (assoc: {det_idx: object}, new_det_indices, bad_det_indices)."""
    assoc: dict[int, object] = {}
    new_dets: list[int] = []
    bad_dets: list[int] = []
    if not kf.detections:
        return assoc, new_dets, bad_dets
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    best_dist_per_obj: dict[int, tuple[float, int]] = {}  # obj id -> (dist, det)

    for i, det in enumerate(kf.detections):
        t_det = det.T_cam_obj[:3, 3]
        best_obj, best_d = None, np.inf
        for obj in local_objects:
            if obj is None or obj.bad:
                continue
            two = obj.T_wo[:3, 3]
            if obj.dynamic:
                two = two + obj.velocity * frame_gap
            d3 = R @ two + t - t_det
            d = float(np.hypot(d3[0], d3[2]))
            if d < best_d:
                best_d, best_obj = d, obj
        if best_obj is not None and best_d < ASSOC_GATE:
            if det.num_surface_points < MIN_PTS_ASSOCIATED:
                bad_dets.append(i)
            prev = best_dist_per_obj.get(best_obj.id)
            if prev is None or best_d < prev[0]:
                if prev is not None:
                    # previous winner becomes new
                    assoc.pop(prev[1], None)
                    new_dets.append(prev[1])
                best_dist_per_obj[best_obj.id] = (best_d, i)
                assoc[i] = best_obj
            else:
                new_dets.append(i)
        else:
            new_dets.append(i)
            if det.num_surface_points < MIN_PTS_NEW:
                bad_dets.append(i)

    for det_idx, obj in assoc.items():
        kf.object_associations[det_idx] = obj.id
        obj.observations[kf.id] = det_idx
    return assoc, new_dets, bad_dets


def associate_by_map_point_votes(
    kf, frame_map_point_ids: np.ndarray, kp_in_mask: list[np.ndarray], points, objects
):
    """Mono path: for each detection, keypoints inside its mask vote with
    their map-point object ids; majority wins (Tracking_util.cc:209-287).

    kp_in_mask: per-detection boolean array over frame keypoints.
    Returns {det_idx: object_id_or_-1_for_new}.
    """
    out = {}
    for i, in_mask in enumerate(kp_in_mask):
        votes: dict[int, int] = {}
        for kp_idx in np.nonzero(in_mask)[0]:
            p_id = frame_map_point_ids[kp_idx]
            if p_id < 0:
                continue
            p = points.get(p_id)
            if p is None or p.bad or not p.in_any_object:
                continue
            votes[p.object_id] = votes.get(p.object_id, 0) + 1
        if votes:
            best = max(votes, key=votes.get)
            if votes[best] >= 5 and best in objects and not objects[best].bad:
                out[i] = best
                continue
        out[i] = -1
    return out


def _log_se3_norm(T: np.ndarray) -> float:
    """|| log(T) || for a 4x4 SE(3) matrix (host numpy; the measurement
    gate of LocalMapping_util.cc:115 uses the g2o SE3Quat log norm)."""
    R = T[:3, :3]
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(cos_theta))
    if theta < 1e-6:
        return float(np.linalg.norm(T[:3, 3]))
    if theta > np.pi - 1e-3:
        # R - R.T degenerates near pi; take the axis from the dominant
        # diagonal of (R + I)/2 = axis axis^T
        a2 = np.clip((np.diag(R) + 1.0) / 2.0, 0.0, 1.0)
        w = theta * np.sqrt(a2)
    else:
        w_hat = (R - R.T) * (theta / (2.0 * np.sin(theta)))
        w = np.array([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])
    # V^-1 t with the standard closed form
    half = theta / 2.0
    k = (1.0 - half / np.tan(half)) / (theta * theta)
    wx = np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
    )
    Vinv = np.eye(3) - 0.5 * wx + k * (wx @ wx)
    rho = Vinv @ T[:3, 3]
    return float(np.sqrt(np.dot(rho, rho) + np.dot(w, w)))


# measurement classification outcomes (GetNewObservations,
# LocalMapping_util.cc:117-151)
STATIC_MEASUREMENT = "static"       # keep SE3 measurement for BA
DYNAMIC_UPDATE = "dynamic"          # moved: update pose + velocity
DISASSOCIATE = "disassociate"       # mature object jumped: false match


def classify_measurement(
    obj, T_co_measured: np.ndarray, T_cw: np.ndarray,
    translation_thresh: float = 1.0, log_thresh: float = 1.5,
):
    """Classify a pose-only GN measurement against the map prediction
    (LocalMapping::GetNewObservations, LocalMapping_util.cc:100-151):

    * already-dynamic object -> DYNAMIC_UPDATE always (track it);
    * static object whose measured camera-frame (x, z) motion < 1 m AND
      whose SE(3) log error < 1.5 -> STATIC_MEASUREMENT;
    * large change on a young object (<= 2 observations) -> it was
      probably never static: DYNAMIC_UPDATE;
    * large change on a mature object -> false association: DISASSOCIATE.
    """
    T_co_init = T_cw @ obj.T_wo_se3
    d3 = T_co_measured[:3, 3] - T_co_init[:3, 3]
    dist2d = float(np.hypot(d3[0], d3[2]))
    log_err = _log_se3_norm(np.linalg.inv(T_co_init) @ T_co_measured)
    if obj.dynamic:
        return DYNAMIC_UPDATE
    if dist2d < translation_thresh and log_err < log_thresh:
        return STATIC_MEASUREMENT
    if len(obj.observations) <= 2:
        return DYNAMIC_UPDATE
    return DISASSOCIATE


def update_dynamic_object(obj, T_co_measured: np.ndarray, T_cw: np.ndarray,
                          frame_gap: float):
    """Move a dynamic object to its measured pose and re-estimate the
    constant-velocity model (LocalMapping_util.cc:117-124). Velocity is
    kept in the WORLD frame in meters/frame — the association predictor
    adds `velocity * frames_since_last_kf` to the world centroid
    (Tracking_util.cc:108-110); the reference stores the object-frame log
    translation instead, which only agrees for small rotations, so we use
    the frame the predictor actually consumes."""
    T_wo_new = np.linalg.inv(T_cw) @ T_co_measured
    motion = T_wo_new[:3, 3] - obj.T_wo_se3[:3, 3]
    obj.velocity = (motion / max(frame_gap, 1.0)).astype(np.float32)
    obj.set_pose_se3(T_wo_new.astype(np.float32))
