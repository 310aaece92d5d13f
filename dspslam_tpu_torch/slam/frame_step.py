"""Fused per-frame tracking programs: stereo, monocular and RGB-D.

Port of dspslam_tpu/slam/frame_step.py: one call runs the whole per-frame
device pipeline — ORB extraction (kernel K2 for every pyramid level of the
frame in one launch on the card), the frame's depth (row-matched stereo,
the RGB-D depth image, or none for mono: u_right = -1 masks the stereo
residual), the motion stage (projection matching + pose GN against the
last frame's points), then the local-map stage — and the caller fetches
one result per frame.

The program never syncs with the host: no `.item()`, no boolean-mask
indexing, no Python branch on a tensor, fixed loop counts, and every
constant it needs is cached on the device. So in eager PyTorch the host
can queue frame k+1 before frame k's results are back
(the `*_chained` programs, the pipelined forms).

Matching conflicts (several map points matched to one keypoint) are
resolved by a scatter-min on descriptor distance.
"""

from __future__ import annotations

import torch

from ..frontend import matcher, orb, stereo
from ..ops import lie
from ..utils import timing
from . import pose_opt

BIG = 1 << 20


def _scatter_min(n: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(n,) per-slot minimum of `values` scattered to `index`, BIG where
    nothing lands (`jnp.full((n,), BIG).at[index].min(values)`)."""
    out = torch.full((n,), BIG, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, index, values, "amin", include_self=True)


def _resolve_and_pack(idx, dist, feats, u_right, cand_pos, cand_valid):
    """Device-side conflict resolution + observation packing. idx: (N,)
    candidate -> keypoint matches (-1 none). Returns the optimize_pose
    inputs plus the winning candidate mask (N,)."""
    n_kp = feats["xy"].shape[0]
    matched = idx >= 0
    safe_kp = torch.clamp(idx, min=0).to(torch.int64)
    # best (min-distance) candidate per keypoint
    best = _scatter_min(n_kp, safe_kp, torch.where(matched, dist, BIG))
    win = matched & (dist <= best[safe_kp])
    # dedupe exact ties: keep the lowest candidate index per keypoint
    cand = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    first = _scatter_min(n_kp, safe_kp, torch.where(win, cand, BIG))
    win = win & (cand == first[safe_kp])

    ur = u_right[safe_kp]
    obs = torch.cat([feats["xy"][safe_kp], torch.where(ur > 0, ur, 0.0)[:, None]], dim=-1)
    smask = (ur > 0).to(torch.float32) * win
    inv_s2 = 1.0 / feats["sigma2"][safe_kp]
    vmask = win.to(torch.float32) * cand_valid
    return cand_pos, obs, inv_s2, vmask, smask, win


def _match_stages(orb_params, radii, intrinsics, feats_l, u_right,
                  T_pred, last_pos, last_desc, last_level, last_dist, last_valid,
                  local_pos, local_desc, local_level, local_dist, local_valid):
    """Motion stage + local stage over extracted features.

    The map points' levels and creation distances are accepted for the
    JAX signature's sake; the projection search runs with its octave gate
    off (matcher.match_by_projection's default), so they are not read."""
    fx, fy, cx, cy = (intrinsics[i] for i in range(4))
    width = 2.0 * cx
    height = 2.0 * cy

    def project(T, pos, valid):
        pc = pos @ T[:3, :3].t() + T[:3, 3]
        z = torch.clamp(pc[:, 2], min=1e-6)
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        ok = (pc[:, 2] > 0.1) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        return torch.stack([u, v], -1), valid * ok

    def stage(T_init, pos, desc, valid, radius):
        with timing.span("track_search"):
            proj, v = project(T_init, pos, valid)
            idx, dist = matcher.match_by_projection(proj, v, desc, None, feats_l, radius=radius)
            pts_w, obs, inv_s2, vmask, smask, _ = _resolve_and_pack(
                idx, dist, feats_l, u_right, pos, v
            )
        T, inlier, n_in = pose_opt.optimize_pose(
            T_init, pts_w, obs, inv_s2, vmask, smask, intrinsics
        )
        return T, idx, inlier * vmask, n_in

    T1, _, _, n1 = stage(T_pred, last_pos, last_desc, last_valid, radii[0])
    T2, idx2, inl2, n2 = stage(T1, local_pos, local_desc, local_valid, radii[1])
    return {
        "T_motion": T1, "n_motion": n1,
        "T_cw": T2, "match_idx": idx2, "inlier": inl2, "n_inliers": n2,
    }


def _two_stage_track(orb_params, radii, img_l, img_r, bf, max_disparity, intrinsics,
                     T_pred, last, local):
    """Shared stereo body: extraction + stereo + motion / local stages."""
    with timing.span("track_orb"):
        feats_l, feats_r = orb.extract_stereo(img_l, img_r, orb_params)
    with timing.span("track_stereo"):
        st = stereo.stereo_match(feats_l, feats_r, img_l, img_r, bf, max_disparity)
    result = _match_stages(
        orb_params, radii, intrinsics, feats_l, st["u_right"], T_pred, *last, *local
    )
    return feats_l, st, result


def track_frame_stereo(orb_params: orb.ORBParams, radii: tuple, img_l, img_r, bf,
                       max_disparity, intrinsics, T_pred,
                       last_pos, last_desc, last_level, last_dist, last_valid,
                       local_pos, local_desc, local_level, local_dist, local_valid):
    """One stereo frame: returns (feats_l, stereo_out, result dict).

    radii = (motion_radius, local_radius); T_pred (4, 4) is the motion
    model's prediction; last_* / local_* are the last frame's and the
    local map's points: pos (C, 3), desc (C, 8) int32, level (C,),
    creation distance (C,), valid (C,)."""
    return _two_stage_track(
        orb_params, radii, img_l, img_r, bf, max_disparity, intrinsics, T_pred,
        (last_pos, last_desc, last_level, last_dist, last_valid),
        (local_pos, local_desc, local_level, local_dist, local_valid),
    )


def _se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[:3, :3]
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = R.t()
    out[:3, 3] = -R.t() @ T[:3, 3]
    return out


def track_frame_stereo_chained(orb_params: orb.ORBParams, radii: tuple, vel_alpha: float,
                               img_l, img_r, bf, max_disparity, intrinsics,
                               T_cw_prev, vel_prev,
                               last_pos, last_desc, last_level, last_dist, last_valid,
                               local_pos, local_desc, local_level, local_dist, local_valid):
    """Pipelined form: the motion prediction, the velocity update and the
    next frame's motion-stage candidate set are computed on the device, so
    frame k+1 can be queued before frame k's results are fetched.

    Returns (feats_l, stereo_out, result, chain) where chain = (T_cw,
    velocity, pos, desc, level, dist, valid) feeds the next call's
    T_cw_prev, vel_prev and last_* arguments unchanged."""
    T_pred = vel_prev @ T_cw_prev
    feats_l, st, result = _two_stage_track(
        orb_params, radii, img_l, img_r, bf, max_disparity, intrinsics, T_pred,
        (last_pos, last_desc, last_level, last_dist, last_valid),
        (local_pos, local_desc, local_level, local_dist, local_valid),
    )
    result, chain = _chain_epilogue(
        vel_alpha, T_cw_prev, vel_prev, result, local_pos, local_desc, local_level, local_dist,
    )
    return feats_l, st, result, chain


def _chain_epilogue(vel_alpha, T_cw_prev, vel_prev, result,
                    local_pos, local_desc, local_level, local_dist):
    """Device-side velocity update + next-frame chain state."""
    T2 = result["T_cw"]
    # smoothed constant-velocity update (Tracker._update_velocity)
    v_obs = T2 @ _se3_inverse(T_cw_prev)
    dv = lie.log_se3(v_obs @ _se3_inverse(vel_prev))
    vel_new = lie.exp_se3(vel_alpha * dv) @ vel_prev
    result = dict(result, velocity=vel_new)
    chain = (T2, vel_new, local_pos, local_desc, local_level, local_dist, result["inlier"])
    return result, chain



def _no_right(feats: dict) -> torch.Tensor:
    """u_right = -1 for every keypoint: the monocular form of the stages."""
    return torch.full(feats["valid"].shape, -1.0, dtype=torch.float32, device=feats["valid"].device)


def track_frame_mono(orb_params: orb.ORBParams, radii: tuple, img, intrinsics, T_pred,
                     last_pos, last_desc, last_level, last_dist, last_valid,
                     local_pos, local_desc, local_level, local_dist, local_valid):
    """One monocular frame: returns (feats, result dict). u_right = -1
    drops the stereo residual from the pose GN. Needs a distortion-free
    camera: the tracker undistorts keypoints on the host, in its modular
    path, for lens-distorted ones."""
    with timing.span("track_orb"):
        feats = orb.extract(img, orb_params)
    result = _match_stages(
        orb_params, radii, intrinsics, feats, _no_right(feats), T_pred,
        last_pos, last_desc, last_level, last_dist, last_valid,
        local_pos, local_desc, local_level, local_dist, local_valid,
    )
    return feats, result


def track_frame_mono_chained(orb_params: orb.ORBParams, radii: tuple, vel_alpha: float, img,
                             intrinsics, T_cw_prev, vel_prev,
                             last_pos, last_desc, last_level, last_dist, last_valid,
                             local_pos, local_desc, local_level, local_dist, local_valid):
    """Pipelined monocular form (see track_frame_stereo_chained): returns
    (feats, result, chain)."""
    T_pred = vel_prev @ T_cw_prev
    feats, result = track_frame_mono(
        orb_params, radii, img, intrinsics, T_pred,
        last_pos, last_desc, last_level, last_dist, last_valid,
        local_pos, local_desc, local_level, local_dist, local_valid,
    )
    result, chain = _chain_epilogue(
        vel_alpha, T_cw_prev, vel_prev, result, local_pos, local_desc, local_level, local_dist,
    )
    return feats, result, chain


def _rgbd_stereo_from_depth(feats: dict, depth_img: torch.Tensor, bf: float) -> dict:
    """Per-keypoint depth (nearest pixel of the sensor's depth image) and
    the virtual right-view coordinate (Frame::ComputeStereoFromRGBD)."""
    H, W = depth_img.shape
    xy = feats["xy"]
    xs = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    ys = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    d = depth_img[ys, xs].to(torch.float32)
    live = (feats["valid"] > 0) & (d > 0)
    d = torch.where(live, d, -1.0)
    u_right = torch.where(live, xy[:, 0] - bf / torch.clamp(d, min=1e-6), -1.0)
    return {"depth": d, "u_right": u_right}


def track_frame_rgbd(orb_params: orb.ORBParams, radii: tuple, img, depth_img, bf, intrinsics,
                     T_pred, last_pos, last_desc, last_level, last_dist, last_valid,
                     local_pos, local_desc, local_level, local_dist, local_valid):
    """One RGB-D frame: extraction, the depth lookup and the motion / local
    stages; the virtual u_right feeds the same stereo residual as true
    stereo. Returns (feats, depth_out, result). Distortion-free cameras."""
    with timing.span("track_orb"):
        feats = orb.extract(img, orb_params)
    st = _rgbd_stereo_from_depth(feats, depth_img, bf)
    result = _match_stages(
        orb_params, radii, intrinsics, feats, st["u_right"], T_pred,
        last_pos, last_desc, last_level, last_dist, last_valid,
        local_pos, local_desc, local_level, local_dist, local_valid,
    )
    return feats, st, result


def track_frame_rgbd_chained(orb_params: orb.ORBParams, radii: tuple, vel_alpha: float, img,
                             depth_img, bf, intrinsics, T_cw_prev, vel_prev,
                             last_pos, last_desc, last_level, last_dist, last_valid,
                             local_pos, local_desc, local_level, local_dist, local_valid):
    """Pipelined RGB-D form (see track_frame_stereo_chained): returns
    (feats, depth_out, result, chain)."""
    T_pred = vel_prev @ T_cw_prev
    feats, st, result = track_frame_rgbd(
        orb_params, radii, img, depth_img, bf, intrinsics, T_pred,
        last_pos, last_desc, last_level, last_dist, last_valid,
        local_pos, local_desc, local_level, local_dist, local_valid,
    )
    result, chain = _chain_epilogue(
        vel_alpha, T_cw_prev, vel_prev, result, local_pos, local_desc, local_level, local_dist,
    )
    return feats, st, result, chain
