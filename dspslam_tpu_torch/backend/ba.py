"""Bundle adjustment: Schur-complement Gauss-Newton on SE(3), with
camera-object relative-pose edges.

Port of dspslam_tpu/backend/ba.py (the reference's Optimizer::
{Local,Global}JointBundleAdjustment over g2o, Optimizer_util.cc:36-771):

* landmarks are marginalized with dense padded tensors: per-point 3x3
  Hessians invert in a batch (`inv_ex`), the camera-point coupling W
  assembles by scatter-add (`index_add_`) into a (K, P, 6, 3) block tensor, and the
  reduced camera system S = Hcc - W Hpp^-1 W^T is one product;
* object landmarks join the reduced system directly: each detection adds a
  6-dof edge e = log(T_co_meas^-1 . T_cw . T_wo) between its keyframe and
  object (EdgeSE3LieAlgebra, ObjectPoseGraph.h:57-89), information 1e3 I,
  Huber delta sqrt(0.1 * 1e3) (Optimizer_util.cc:80-84); its tangent
  Jacobians are the closed form Jl^-1(e) Ad(.) (the JAX package takes them
  from `jax.jacfwd`; they agree to f32 rounding);
* the reference's schedule (5 iterations, drop chi2 outliers, 10 more,
  Optimizer_util.cc:588-663; `schedule`, global BA runs one round of 10)
  is a fixed loop with Levenberg-Marquardt
  acceptance decided on the device (`torch.where`): no `.item()`, no host
  branch, so a solve is dispatched without waiting on the card.

All observation slots are padded; masks make padded slots contribute zero.
Callers fix at least the window's oldest keyframe (`kf_fixed`). The
scatter-adds sum in another order than XLA's, so results agree with the
JAX package to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from ..ops import lie
from ..utils import timing

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
# hard cap: edges beyond ~35 px error are unrecoverable junk; they are
# excised from each linearization, the reference's edge removal
# `chi2() > th || !isDepthPositive()` (Optimizer_util.cc:641-663)
CHI2_HARD_CAP = 1e4
MIN_DEPTH = 0.05
OBJ_INFO = 1e3                      # invSigmaObject (Optimizer_util.cc:80)
OBJ_HUBER_DELTA2 = 0.1 * OBJ_INFO   # thHuberObject^2
OBJ_CHI2_OUTLIER = 1e3              # edge removal threshold


def _point_residuals(T_cw_all, pts, obs_kf, obs_pt, obs_uvr, obs_stereo, intrinsics):
    """Residual (O, 3), J_pose (O, 3, 6), J_point (O, 3, 3) and depth (O,)
    for all observation slots."""
    fx, fy, cx, cy, bf = (intrinsics[i] for i in range(5))
    T = T_cw_all[obs_kf]                                    # (O, 4, 4)
    pc = torch.einsum("oij,oj->oi", T[:, :3, :3], pts[obs_pt]) + T[:, :3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    inv_z = 1.0 / torch.clamp(z, min=1e-6)
    inv_z2 = inv_z * inv_z
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    res = torch.stack([u - obs_uvr[:, 0], v - obs_uvr[:, 1], (ur - obs_uvr[:, 2]) * obs_stereo], dim=-1)

    zero = torch.zeros_like(x)
    du = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * inv_z2], dim=-1)
    dpix_dpc = torch.stack([du, dv, dur * obs_stereo[:, None]], dim=-2)   # (O, 3, 3)
    J_pose = dpix_dpc @ lie.points_to_pose_jacobian_se3(pc)               # (O, 3, 6)
    J_pt = dpix_dpc @ T[:, :3, :3]                                        # (O, 3, 3)
    return res, J_pose, J_pt, z


def object_residual(T_cw, T_wo, T_co_meas):
    """e = log_se3(T_co_meas^-1 @ T_cw @ T_wo) -> (..., 6)."""
    return lie.log_se3(lie.inverse_se3(T_co_meas) @ T_cw @ T_wo)


def object_residuals_and_jac(T_cw_all, T_wo_all, obj_kf, obj_id, obj_Tco):
    """Residual (Q, 6) and the tangent Jacobians (Q, 6, 6) with respect to
    left perturbations of the camera and of the object, in closed form:
    with E = Z^-1 T_cw T_wo and e = log E, a camera perturbation enters as
    exp(Ad(Z^-1) d) E and an object one as exp(Ad(Z^-1 T_cw) d) E, so
    J = Jl^-1(e) Ad(.). (Forward-mode autodiff through the Lie functions
    gives the same Jacobians at ~20x the launches.)"""
    T_c, T_o = T_cw_all[obj_kf], T_wo_all[obj_id]
    Z_inv = lie.inverse_se3(obj_Tco)
    ZT_c = Z_inv @ T_c
    r = lie.log_se3(ZT_c @ T_o)
    Jl_inv = lie.se3_left_jacobian_inv(r)
    return r, Jl_inv @ lie.adjoint_se3(Z_inv), Jl_inv @ lie.adjoint_se3(ZT_c)


def _scatter_add(n: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Sum the (O, ...) blocks of `src` into n slots by `index` (O,): one
    1-D `index_add_` over the flattened blocks (the CPU's N-D index_add_
    is ~6x slower; on the card both are atomic adds)."""
    shape = src.shape[1:]
    m = src[0].numel()
    flat = (index[:, None] * m + torch.arange(m, device=index.device)).reshape(-1)
    out = torch.zeros(n * m, dtype=src.dtype, device=src.device)
    return out.index_add_(0, flat, src.reshape(-1)).reshape(n, *shape)


def _huber_cost(chi2, th):
    return torch.where(chi2 <= th, chi2, 2.0 * torch.sqrt(torch.clamp(chi2, min=0.0) * th) - th)


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """(K, d, d) blocks -> the (K d, K d) block-diagonal matrix."""
    K, d = blocks.shape[0], blocks.shape[-1]
    eye = torch.eye(K, dtype=blocks.dtype, device=blocks.device)
    return (eye[:, None, :, None] * blocks[:, :, None, :]).reshape(K * d, K * d)


def _flat(blocks: torch.Tensor) -> torch.Tensor:
    """(K, L, a, b) blocks -> the (K a, L b) matrix."""
    K, L, a, b = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(K * a, L * b)


def bundle_adjust(kf_poses, kf_fixed, points, pt_valid, obs_kf, obs_pt, obs_uvr, obs_stereo,
                  obs_inv_sigma2, obs_valid, intrinsics, damping: float = 1e-3,
                  obj_state: dict | None = None, schedule: tuple = (5, 10)) -> dict:
    """Windowed (joint) bundle adjustment; returns updated state + masks.

    kf_poses (K, 4, 4) T_cw; kf_fixed (K,) 1.0 = held; points (P, 3);
    pt_valid (P,); obs_kf / obs_pt (O,) slots; obs_uvr (O, 3) [u, v,
    u_right]; obs_stereo (O,) 1.0 where u_right is observed;
    obs_inv_sigma2 (O,); obs_valid (O,); intrinsics (5,) [fx fy cx cy bf].
    obj_state (optional) enables the joint camera-object problem: {poses
    (M, 4, 4) T_wo, fixed (M,), edge_kf (Q,), edge_obj (Q,), edge_Tco
    (Q, 4, 4), edge_valid (Q,)}. schedule: GN iterations per round, chi2
    outliers dropped between rounds.
    Returns dict(kf_poses, points, obs_inlier, obj_poses, obj_edge_inlier).
    """
    dev, dt = kf_poses.device, kf_poses.dtype
    K, P = kf_poses.shape[0], points.shape[0]
    obs_kf, obs_pt = obs_kf.long(), obs_pt.long()
    has_obj = obj_state is not None
    if has_obj:
        M = obj_state["poses"].shape[0]
        obj_fixed = obj_state["fixed"]
        edge_kf, edge_obj = obj_state["edge_kf"].long(), obj_state["edge_obj"].long()
        edge_Tco, edge_valid0 = obj_state["edge_Tco"], obj_state["edge_valid"]
    else:
        M = 0
    chi2_th = torch.where(obs_stereo > 0, CHI2_STEREO, CHI2_MONO)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def residuals(kf_T, pts):
        return _point_residuals(kf_T, pts, obs_kf, obs_pt, obs_uvr, obs_stereo, intrinsics)

    def robust_cost(kf_T, pts, obj_T, inlier, edge_inlier):
        """Total Huber cost, the LM acceptance criterion. Depth is clamped
        (not excised), so steps that push points behind the camera raise
        the cost instead of hiding it."""
        res = residuals(kf_T, pts)[0]
        chi2 = torch.sum(res * res, dim=-1) * obs_inv_sigma2
        c = torch.sum(_huber_cost(chi2, chi2_th) * inlier * obs_valid)
        if has_obj:
            r_o = object_residual(kf_T[edge_kf], obj_T[edge_obj], edge_Tco)
            chi2_o = torch.sum(r_o * r_o, dim=-1) * OBJ_INFO
            c = c + torch.sum(_huber_cost(chi2_o, OBJ_HUBER_DELTA2) * edge_inlier)
        return c

    def gn_step(carry):
        kf_T, pts, inlier, obj_T, edge_inlier, lam, cost_prev = carry
        res, J_c, J_p, z = residuals(kf_T, pts)
        chi2 = torch.sum(res * res, dim=-1) * obs_inv_sigma2
        hub = torch.where(chi2 <= chi2_th, 1.0, torch.sqrt(chi2_th / torch.clamp(chi2, min=1e-12)))
        # excise unrecoverable edges for this linearization only
        live = ((chi2 <= CHI2_HARD_CAP) & (z > MIN_DEPTH)).to(dt)
        w = inlier * obs_valid * obs_inv_sigma2 * hub * live             # (O,)
        JcW = J_c * w[:, None, None]
        JpW = J_p * w[:, None, None]
        # block assembly by scatter-add
        Hcc = _scatter_add(K, obs_kf, torch.einsum("oij,oik->ojk", JcW, J_c))
        bc = _scatter_add(K, obs_kf, -torch.einsum("oij,oi->oj", JcW, res))
        Hpp = _scatter_add(P, obs_pt, torch.einsum("oij,oik->ojk", JpW, J_p))
        bp = _scatter_add(P, obs_pt, -torch.einsum("oij,oi->oj", JpW, res))
        W = _scatter_add(K * P, obs_kf * P + obs_pt,
                         torch.einsum("oij,oik->ojk", JcW, J_p)).reshape(K, P, 6, 3)

        # Marquardt scaling (lam * diag(H)); the absolute floor keeps
        # padded point blocks invertible
        Hpp = Hpp + torch.diag_embed(lam * torch.diagonal(Hpp, dim1=1, dim2=2)) + 1e-6 * eye3
        Hpp_inv = torch.linalg.inv_ex(Hpp)[0] * pt_valid[:, None, None]

        # reduced camera system
        S_diag = Hcc + torch.diag_embed(lam * torch.diagonal(Hcc, dim1=1, dim2=2)) + 1e-6 * eye6
        WH = torch.einsum("kpab,pbc->kpac", W, Hpp_inv)                    # (K, P, 6, 3)
        S = _block_diag(S_diag) - WH.permute(0, 2, 1, 3).reshape(6 * K, 3 * P) @ \
            W.permute(0, 2, 1, 3).reshape(6 * K, 3 * P).T
        rhs = bc - torch.einsum("kpac,pc->ka", WH, bp)

        if has_obj:
            r_o, Jc_o, Jo_o = object_residuals_and_jac(kf_T, obj_T, edge_kf, edge_obj, edge_Tco)
            chi2_o = torch.sum(r_o * r_o, dim=-1) * OBJ_INFO
            hub_o = torch.where(chi2_o <= OBJ_HUBER_DELTA2, 1.0,
                                torch.sqrt(OBJ_HUBER_DELTA2 / torch.clamp(chi2_o, min=1e-12)))
            w_o = edge_inlier * hub_o * OBJ_INFO                          # (Q,)
            JcW_o = Jc_o * w_o[:, None, None]
            JoW_o = Jo_o * w_o[:, None, None]
            S = S + _block_diag(_scatter_add(K, edge_kf, torch.einsum("qij,qik->qjk", JcW_o, Jc_o)))
            H_oo = _scatter_add(M, edge_obj, torch.einsum("qij,qik->qjk", JoW_o, Jo_o))
            H_oo = H_oo + torch.diag_embed(lam * torch.diagonal(H_oo, dim1=1, dim2=2)) + 1e-6 * eye6
            H_co = _flat(_scatter_add(K * M, edge_kf * M + edge_obj,
                                      torch.einsum("qij,qik->qjk", JcW_o, Jo_o)).reshape(K, M, 6, 6))
            H_full = torch.cat([torch.cat([S, H_co], dim=1),
                                torch.cat([H_co.T, _block_diag(H_oo)], dim=1)], dim=0)
            rhs_c = rhs + _scatter_add(K, edge_kf, -torch.einsum("qij,qi->qj", JcW_o, r_o))
            rhs_o = _scatter_add(M, edge_obj, -torch.einsum("qij,qi->qj", JoW_o, r_o))
            rhs_full = torch.cat([rhs_c.reshape(-1), rhs_o.reshape(-1)])
            free = torch.cat([1.0 - kf_fixed, 1.0 - obj_fixed])
        else:
            H_full, rhs_full, free = S, rhs.reshape(-1), 1.0 - kf_fixed

        # clamp fixed variables: identity rows / columns, zero rhs
        free_diag = free[:, None].expand(-1, 6).reshape(-1)
        H_full = H_full * (free_diag[:, None] * free_diag[None, :]) + torch.diag(1.0 - free_diag)
        dx = torch.linalg.solve_ex(H_full, rhs_full * free_diag)[0]
        # trust region: bounded, finite increments
        dx = torch.clamp(torch.where(torch.isfinite(dx), dx, 0.0), -0.5, 0.5)
        dx_c = dx[: 6 * K].reshape(K, 6)
        kf_T_new = lie.exp_se3(dx_c) @ kf_T
        obj_T_new = lie.exp_se3(dx[6 * K:].reshape(M, 6)) @ obj_T if has_obj else obj_T

        # back-substitute landmark updates
        dx_p = torch.einsum("pab,pb->pa", Hpp_inv, bp - torch.einsum("kpab,ka->pb", W, dx_c))
        dx_p = torch.clamp(torch.where(torch.isfinite(dx_p), dx_p, 0.0), -0.5, 0.5)
        pts_new = pts + dx_p * pt_valid[:, None]

        # Levenberg-Marquardt acceptance, decided on the device
        cost_new = robust_cost(kf_T_new, pts_new, obj_T_new, inlier, edge_inlier)
        accept = torch.isfinite(cost_new) & (cost_new < cost_prev)
        lam_new = torch.clamp(torch.where(accept, lam / 3.0, lam * 3.0), 1e-7, 1e8)
        return (torch.where(accept, kf_T_new, kf_T), torch.where(accept, pts_new, pts), inlier,
                torch.where(accept, obj_T_new, obj_T), edge_inlier, lam_new,
                torch.where(accept, cost_new, cost_prev))

    def reclassify(carry):
        kf_T, pts, inlier, obj_T, edge_inlier, lam, _ = carry
        res, _, _, z = residuals(kf_T, pts)
        chi2 = torch.sum(res * res, dim=-1) * obs_inv_sigma2
        # chi2 > th OR !isDepthPositive (Optimizer_util.cc:641-663)
        inlier = ((chi2 <= chi2_th) & (z > MIN_DEPTH)).to(dt) * obs_valid
        if has_obj:
            r_o = object_residual(kf_T[edge_kf], obj_T[edge_obj], edge_Tco)
            chi2_o = torch.sum(r_o * r_o, dim=-1) * OBJ_INFO
            edge_inlier = (chi2_o <= OBJ_CHI2_OUTLIER).to(dt) * edge_valid0
        # the acceptance baseline is re-evaluated under the new inlier set
        return kf_T, pts, inlier, obj_T, edge_inlier, lam, robust_cost(kf_T, pts, obj_T, inlier, edge_inlier)

    obj_T0 = obj_state["poses"] if has_obj else torch.zeros((0, 4, 4), dtype=dt, device=dev)
    edge_i0 = edge_valid0 if has_obj else torch.zeros((0,), dtype=dt, device=dev)
    carry = (kf_poses, points, obs_valid, obj_T0, edge_i0, torch.full((), damping, dtype=dt, device=dev),
             robust_cost(kf_poses, points, obj_T0, obs_valid, edge_i0))
    for round_idx, n_iters in enumerate(schedule):
        for _ in range(n_iters):
            with timing.span("ba_lm_step"):
                carry = gn_step(carry)
        if round_idx < len(schedule) - 1:
            with timing.span("ba_reclassify"):
                carry = reclassify(carry)
    kf_T, pts, inlier, obj_T, edge_inlier = carry[:5]
    return {"kf_poses": kf_T, "points": pts, "obs_inlier": inlier, "obj_poses": obj_T,
            "obj_edge_inlier": edge_inlier}
