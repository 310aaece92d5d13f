"""Joint pose + shape Gauss-Newton reconstruction, batched over objects.

Port of dspslam_tpu/shape/gn.py. Every function takes the objects of a
keyframe in a leading batch dimension B; an iteration is one pass of
batched tensor ops plus ONE batched solve of the B x (7 + L) x (7 + L)
normal systems, and the iterations are a Python loop.

Normal equations (the reference's conventions):
  H = k1 * Jr^T Jr / n_r  +  k2 * Js^T Js / n_s        (plain J, no IRLS in H)
  b = -k1 * Jr^T (w_r r_r) / n_r - k2 * Js^T (w_s r_s) / n_s   (Huber-weighted r)
  code prior: H_code += k3 I, b_code -= k3 * code
  rotation prior (k4) on the pose block, damping on pose and on scale.
An object whose iteration is not healthy (non-finite loss or step, a
failed solve, or fewer than `min_render_points` valid render samples
while it has foreground rays) keeps its previous state for that
iteration, and `is_good` reports whether all its iterations were healthy.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from ..ops import lie
from ..ops.robust import robust_residuals
from ..utils import timing
from . import losses


@dataclasses.dataclass(frozen=True)
class GNConfig:
    """Hyperparameters of the joint optimizer (reference config_kitti.json
    defaults; mono datasets use k1=10, k3=2.5, k4=0, b2=0.02, iters=5,
    s_damp=100)."""

    code_len: int = 64
    num_depth_samples: int = 50
    cut_off: float = 0.01
    k1: float = 1.0        # render-term weight
    k2: float = 100.0      # sdf-term weight
    k3: float = 0.25       # code prior
    k4: float = 1e7        # rotation prior
    b1: float = 0.20       # Huber threshold, render residuals
    b2: float = 0.025      # Huber threshold, sdf residuals
    learning_rate: float = 1.0
    scale_damping: float = 1.0
    pose_damping: float = 1.0
    num_iterations: int = 10
    max_grad_points: int = 1024
    min_render_points: int = 10
    # decode at most int(R * S * fraction) render-grid samples per object,
    # the valid ones first (None decodes the whole grid)
    render_eval_fraction: float | None = None
    # trust region on the per-iteration log-scale step: the scale/code
    # product is weakly constrained, so unbounded steps can inflate the
    # scale far from the detector's metric prior before the code catches up
    max_scale_step: float = 0.1
    # pose-only object ICP
    pose_only_iterations: int = 5
    pose_only_inlier_thresh: float = 0.05
    pose_only_damping: float = 1e-2


POSE_DIM = 7


def _masked_normal_eqs(J, robust_res, mask):
    """(H (B, D, D), b (B, D)) with the reference's 1/N row normalization."""
    n = torch.clamp(torch.sum(mask, dim=-1), min=1.0)[:, None]
    Jt = J.transpose(-1, -2)
    H = (Jt @ J) / n[..., None]
    b = -(Jt @ robust_res[..., None])[..., 0] / n
    return H, b


def reconstruct_object(
    decoder,
    config: GNConfig,
    t_cam_obj: torch.Tensor,   # (B, 4, 4) initial Sim(3) object -> camera
    pts_cam: torch.Tensor,     # (B, P, 3) surface points (camera frame, padded)
    pts_mask: torch.Tensor,    # (B, P)
    rays: torch.Tensor,        # (B, R, 3) ray directions (padded)
    ray_mask: torch.Tensor,    # (B, R)
    depth_obs: torch.Tensor,   # (B, R) foreground depths (0 where background)
    fg_mask: torch.Tensor,     # (B, R) 1.0 foreground
    code_init: torch.Tensor | None = None,  # (B, >= L)
):
    """Jointly optimize the Sim(3) pose and shape code of B objects.

    Returns dict(t_cam_obj (B, 4, 4), code (B, L), is_good (B,), loss (B,)).
    """
    B = t_cam_obj.shape[0]
    L = config.code_len
    dev, dt = t_cam_obj.device, t_cam_obj.dtype
    code = (
        torch.zeros((B, L), device=dev, dtype=dt)
        if code_init is None else code_init[:, :L].to(dt)
    )
    t_obj_cam = lie.inverse_sim3(t_cam_obj)
    loss = torch.zeros((B,), device=dev, dtype=dt)
    is_good = torch.ones((B,), device=dev, dtype=torch.bool)
    eye_code = config.k3 * torch.eye(L, device=dev, dtype=dt)
    eye_pose = config.pose_damping * torch.eye(POSE_DIM, device=dev, dtype=dt)
    # the render-validity gate applies only to detections with foreground
    # rays: mono detections carry background rays alone, and a small
    # PCA-seeded scale can leave no sample inside the canonical unit ball
    render_required = torch.sum(fg_mask, dim=-1) > 0
    # a static cap (a Python int from the shapes), so the loop stays sync-free
    max_eval_points = (
        None if config.render_eval_fraction is None
        else int(rays.shape[1] * config.num_depth_samples * config.render_eval_fraction)
    )

    for _ in range(config.num_iterations):
        with timing.span("gn_iter"):
            with timing.span("gn_sdf"):
                J_s, r_s, m_s = losses.sdf_surface_loss(
                    decoder, pts_cam, pts_mask, t_obj_cam, code
                )
                rr_s, sdf_loss, _ = robust_residuals(r_s, config.b2, m_s)
            with timing.span("gn_render"):
                J_r, r_r, m_r, aux = losses.render_loss(
                    decoder, rays, ray_mask, depth_obs, fg_mask, t_obj_cam, code,
                    num_samples=config.num_depth_samples, cut_off=config.cut_off,
                    max_grad_points=config.max_grad_points, max_eval_points=max_eval_points,
                )
                rr_r, render_loss_val, _ = robust_residuals(r_r, config.b1, m_r)
            with timing.span("gn_solve"):
                J_rot, r_rot = losses.rotation_prior_loss(t_obj_cam)

                H_s, b_s = _masked_normal_eqs(J_s, rr_s, m_s)
                H_r, b_r = _masked_normal_eqs(J_r, rr_r, m_r)
                H = config.k1 * H_r + config.k2 * H_s
                b = config.k1 * b_r + config.k2 * b_s
                H[:, POSE_DIM:, POSE_DIM:] += eye_code
                b[:, POSE_DIM:] -= config.k3 * code
                H[:, :POSE_DIM, :POSE_DIM] += config.k4 * (J_rot[:, :, None] * J_rot[:, None, :])
                b[:, :POSE_DIM] -= config.k4 * J_rot * r_rot[:, None]
                H[:, :POSE_DIM, :POSE_DIM] += eye_pose
                H[:, POSE_DIM - 1, POSE_DIM - 1] += config.scale_damping

                dx, info = torch.linalg.solve_ex(H, b)
                dx[:, POSE_DIM - 1] = torch.clamp(
                    dx[:, POSE_DIM - 1], -config.max_scale_step, config.max_scale_step
                )
                t_obj_cam_new = lie.exp_sim3(config.learning_rate * dx[:, :POSE_DIM]) @ t_obj_cam
                code_new = code + config.learning_rate * dx[:, POSE_DIM:]

                loss = config.k1 * render_loss_val + config.k2 * sdf_loss
                healthy = (
                    torch.isfinite(loss)
                    & torch.all(torch.isfinite(dx), dim=-1)
                    & (info == 0)
                    & ((aux["n_valid_query"] >= config.min_render_points) | ~render_required)
                )
                t_obj_cam = torch.where(healthy[:, None, None], t_obj_cam_new, t_obj_cam)
                code = torch.where(healthy[:, None], code_new, code)
                is_good = is_good & healthy

    return {
        "t_cam_obj": lie.inverse_sim3(t_obj_cam),
        "code": code,
        "is_good": is_good,
        "loss": loss,
    }


def estimate_pose_cam_obj(
    decoder,
    config: GNConfig,
    t_cam_obj_se3: torch.Tensor,  # (B, 4, 4) SE(3) object -> camera
    scale: torch.Tensor,          # (B,) object scale
    pts_cam: torch.Tensor,        # (B, P, 3)
    pts_mask: torch.Tensor,       # (B, P)
    code: torch.Tensor,           # (B, L)
):
    """Pose-only SE(3) GN ICP on SDF residuals for B objects.

    The scale is baked into the rotation block during the solve and
    factored back out at the end. After the fifth iteration (index 4) the
    surface points are re-gated to inliers (|res| <= thresh), as in the
    reference. Returns dict(t_cam_obj (B, 4, 4) SE(3), loss (B,)).
    """
    with timing.span("gn_pose_only"):
        dev, dt = t_cam_obj_se3.device, t_cam_obj_se3.dtype
        t_cam_obj = t_cam_obj_se3.clone()
        t_cam_obj[:, :3, :3] *= scale[:, None, None]
        t_obj_cam = torch.linalg.inv(t_cam_obj)
        mask = pts_mask
        loss = torch.zeros(scale.shape, device=dev, dtype=dt)
        damping = config.pose_only_damping * torch.eye(6, device=dev, dtype=dt)
        for e in range(config.pose_only_iterations):
            J, r, m = losses.sdf_surface_loss(decoder, pts_cam, mask, t_obj_cam, code)
            _, loss, _ = robust_residuals(r, config.pose_only_inlier_thresh, m)
            J6 = J[..., :6]
            n = torch.clamp(torch.sum(m, dim=-1), min=1.0)[:, None]
            H = (J6.transpose(-1, -2) @ J6) / n[..., None] + damping
            b = -(J6.transpose(-1, -2) @ r[..., None])[..., 0] / n  # plain residual
            dx = torch.linalg.solve_ex(H, b)[0]
            t_obj_cam = lie.exp_se3(dx) @ t_obj_cam
            if e == 4:
                mask = mask * (torch.abs(r) <= config.pose_only_inlier_thresh)
        t_cam_obj_out = torch.linalg.inv(t_obj_cam)
        t_cam_obj_out[:, :3, :3] /= scale[:, None, None]
        return {"t_cam_obj": t_cam_obj_out, "loss": loss}


def batched_estimate_pose(decoder, config: GNConfig):
    """fn(t_cam_obj (B,4,4), scale (B,), pts (B,P,3), pts_mask (B,P),
    code (B,L)) -> dict of batched pose-only results."""
    return partial(estimate_pose_cam_obj, decoder, config)


def batched_reconstruct(decoder, config: GNConfig):
    """fn(t_cam_obj (B,4,4), pts (B,P,3), pts_mask (B,P), rays (B,R,3),
    ray_mask (B,R), depth (B,R), fg_mask (B,R), code_init (B,L)) -> dict of
    batched results: all detections of a keyframe in one pass."""
    return partial(reconstruct_object, decoder, config)
