"""The numbers that decide `correct`: gaps between what the timed path
produced and what the plain references (benchmark/reference/) work out from
the same inputs, and the trajectory against the world's true poses.

Each function returns plain floats. A cell compares the numbers that
limits/<cell>.json names with their limits; `PERF.md` gives the readings
each limit was set from.
"""

from __future__ import annotations

import numpy as np
import torch


def umeyama(src: np.ndarray, dst: np.ndarray, scale: bool):
    """(s, R, t) minimising |dst - (s R src + t)| over (N, 3) point sets."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(b.T @ a / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / (a * a).sum(1).mean()) if scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_over_travel(est_centers: np.ndarray, gt_centers: np.ndarray, scale: bool) -> float:
    """RMS position error after an SE(3) (or, with `scale`, Sim(3))
    alignment, over the true distance travelled between those frames."""
    est, gt = np.asarray(est_centers, np.float64), np.asarray(gt_centers, np.float64)
    s, R, t = umeyama(est, gt, scale)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    travel = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return float(np.sqrt(np.mean(err ** 2))) / max(travel, 1e-9)


def _host(t):
    return t.detach().double().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)


def ba_gaps(args: tuple, prog: dict, ref: dict) -> dict:
    """Gaps of one local BA solve: the largest difference of a free
    camera's or object's pose entry (rotation entries, translations in
    meters); the median over live points of the distance between the two
    solutions' positions over the point's distance from the nearest free
    camera (at least 1 m)."""
    kf_fixed = _host(args[1])
    pt_valid = _host(args[3]) > 0
    free = kf_fixed == 0
    cam = np.abs(_host(prog["kf_poses"])[free, :3, :] - _host(ref["kf_poses"])[free, :3, :]).max(initial=0.0)
    obj_state = args[12] if len(args) > 12 else None
    if obj_state is not None:
        ofree = _host(obj_state["fixed"]) == 0
        cam = max(cam, np.abs(_host(prog["obj_poses"])[ofree, :3, :]
                              - _host(ref["obj_poses"])[ofree, :3, :]).max(initial=0.0))
    p_prog, p_ref = _host(prog["points"])[pt_valid], _host(ref["points"])[pt_valid]
    centers = -np.einsum("kji,kj->ki", _host(ref["kf_poses"])[:, :3, :3], _host(ref["kf_poses"])[:, :3, 3])
    # distance of each point from the nearest window camera: its depth scale
    depth = np.min(np.linalg.norm(p_ref[:, None, :] - centers[free][None, :, :], axis=-1), axis=1) \
        if free.any() and len(p_ref) else np.ones(len(p_ref))
    pt = float(np.median(np.linalg.norm(p_prog - p_ref, axis=1) / np.maximum(depth, 1.0))) if len(p_ref) else 0.0
    return {"ba_cam_gap": float(cam), "ba_point_gap": pt}


def pose_gap(args: tuple, prog: tuple, ref: tuple) -> float:
    """Gap of one pose optimisation of the tracker: the largest difference
    of an entry of the two solutions' T_cw (rotation entries, the
    translation in meters)."""
    return float(np.abs(_host(prog[0])[:3, :] - _host(ref[0])[:3, :]).max())


def worst(readings: list[dict]) -> dict:
    """The largest reading of each number over a list of readings."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out
