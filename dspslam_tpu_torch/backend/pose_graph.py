"""Sim(3) pose-graph optimization (essential graph).

Port of dspslam_tpu/backend/pose_graph.py (Optimizer::
OptimizeEssentialGraph, Optimizer.cc:780-1044, g2o VertexSim3Expmap +
EdgeSim3): after a loop closure, keyframe poses are re-optimized as Sim(3)
elements S_cw over the essential graph (spanning tree + strong covisibility
+ loop edges) with relative-pose residuals

    e_ij = log_sim3( S_ij_meas . S_jw . S_iw^-1 ),

zero when the current relative pose matches the measured one.

Three things make this converge in f32, as the JAX package records:

1. Levenberg-Marquardt with accept / reject: an exact Gauss-Newton step on
   a freshly closed loop overshoots the nonlinear objective. Acceptance is
   decided on the device (`torch.where`), so the dense solve runs with no
   host sync.
2. The delta parameterization (`_make_linearizer`): per-vertex corrections
   D_k with S_kw = D_k . S0_kw, so every composition multiplies edge-scale
   transforms and f32 rounding stays ~1e-7 of the residual.
3. The wide Taylor guards of ops/lie.py.

The per-edge Jacobians are closed form where the JAX package takes
`jax.jacfwd`: with E = Z D_j P D_i^-1 and r = log E, a left perturbation of
D_j enters as exp(Ad(Z) d) E and one of D_i as exp(-Ad(E) d) E, so
J_j = Jl(r)^-1 Ad(Z) and J_i = -Jl(r)^-1 Ad(E), with the Sim(3) left
Jacobian Jl(r) = sum_n ad(r)^n / (n + 1)! summed on the device.

* `optimize_pose_graph`: dense (K, K, 7, 7) normal equations, right for
  <= ~512 vertices.
* `optimize_pose_graph_cg`: matrix-free, H applied edge-wise with a
  block-Jacobi preconditioner. Its conjugate gradient has a data-dependent
  exit (`jax.scipy.sparse.linalg.cg(tol=1e-8)`): here it runs eagerly, the
  state stops changing once converged (an update mask, so the result
  equals an early exit) and the host reads the convergence flag every
  `CG_CHECK_EVERY` iterations.
"""

from __future__ import annotations

import torch

from ..ops import lie

CG_CHECK_EVERY = 16
_JL_TERMS = 12      # ad(r)^n / (n+1)! terms of the left Jacobian


def _ad_sim3(x: torch.Tensor) -> torch.Tensor:
    """Lie-algebra adjoint of sim(3) tangents (..., 7) [v, w, s] ->
    (..., 7, 7): ad(x1) x2 = [x1, x2] for the generators
    [[hat(w) + s I, v], [0, 0]]."""
    v, w, s = x[..., :3], x[..., 3:6], x[..., 6]
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(*x.shape[:-1], 3, 3)
    z33 = torch.zeros_like(eye)
    z31 = torch.zeros_like(v)[..., None]
    z13 = torch.zeros_like(v)[..., None, :]
    top = torch.cat([s[..., None, None] * eye + lie.hat(w), lie.hat(v), -v[..., None]], -1)
    mid = torch.cat([z33, lie.hat(w), z31], -1)
    bot = torch.cat([z13, z13, torch.zeros_like(s)[..., None, None]], -1)
    return torch.cat([top, mid, bot], -2)


def _adjoint_sim3(T: torch.Tensor) -> torch.Tensor:
    """Group adjoint of Sim(3) (..., 4, 4) -> (..., 7, 7): exp(Ad(T) x) =
    T exp(x) T^-1."""
    s, R, t = lie.split_sim3(T)
    z33 = torch.zeros_like(R)
    z31 = torch.zeros_like(t)[..., None]
    z13 = torch.zeros_like(t)[..., None, :]
    one = torch.ones_like(s)[..., None, None]
    top = torch.cat([T[..., :3, :3], lie.hat(t) @ R, -t[..., None]], -1)
    mid = torch.cat([z33, R, z31], -1)
    bot = torch.cat([z13, z13, one], -1)
    return torch.cat([top, mid, bot], -2)


def _left_jacobian(r: torch.Tensor) -> torch.Tensor:
    """Sim(3) left Jacobian sum_n ad(r)^n / (n + 1)! at tangents (..., 7)."""
    ad = _ad_sim3(r)
    eye = torch.eye(7, dtype=r.dtype, device=r.device).expand_as(ad)
    term, J = eye, eye
    for n in range(1, _JL_TERMS):
        term = (term @ ad) / (n + 1)
        J = J + term
    return J


def edge_residuals_and_jacobians(E: torch.Tensor, Z: torch.Tensor):
    """r = log E (e, 7) with the Jacobians (e, 7, 7) for left perturbations
    of the two vertices: J_i = -Jl(r)^-1 Ad(E), J_j = Jl(r)^-1 Ad(Z)."""
    r = lie.log_sim3(E)
    rhs = torch.cat([-_adjoint_sim3(E), _adjoint_sim3(Z)], -1)
    J = torch.linalg.solve_ex(_left_jacobian(r), rhs)[0]
    return r, J[..., :7], J[..., 7:]


def _make_linearizer(poses0, edge_i, edge_j, edge_meas, edge_valid):
    """Delta parameterization: optimize per-vertex corrections D_k with
    S_kw = D_k . S0_kw. The per-edge composition

        r_e = log_sim3( Z . D_j . P_e . D_i^-1 ),   P_e = S0_jw . S0_iw^-1

    only multiplies matrices with edge-scale translations, so f32 rounding
    is ~1e-7 of the residual; P_e is composed once per solve."""
    P = poses0[edge_j] @ lie.inverse_sim3(poses0[edge_i])

    def compose(D_all):
        return edge_meas @ D_all[edge_j] @ P @ lie.inverse_sim3(D_all[edge_i])

    def res_and_jac(D_all):
        return edge_residuals_and_jacobians(compose(D_all), edge_meas)

    def chi2(D_all):
        r = lie.log_sim3(compose(D_all))
        return torch.sum(edge_valid * torch.sum(r * r, dim=-1))

    return res_and_jac, chi2


def _free_mask(fixed, fix_scale):
    free = (1.0 - fixed)[:, None].expand(-1, 7)
    if fix_scale:
        # tangent order [t(3), r(3), log-s]: clamp the scale dim
        # (reference bFixScale, Optimizer.cc:810)
        dims = torch.ones(7, dtype=fixed.dtype, device=fixed.device)
        free = free * torch.cat([dims[:6], 0.0 * dims[6:]])[None, :]
    return free


def _scatter_add(n: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Sum the (E, ...) blocks of `src` into n slots by `index` (E,)."""
    out = torch.zeros((n,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    return out.index_add_(0, index, src)


def _lm_loop(poses, solve_fn, chi2_fn, iterations, damping0):
    """LM outer loop: solve with the current lambda, accept the step only
    if chi2 drops (else raise lambda and retry next iteration), all on the
    device."""
    S_all = poses
    lam = torch.full((), damping0, dtype=poses.dtype, device=poses.device)
    chi2_old = chi2_fn(poses)
    for _ in range(iterations):
        dx = solve_fn(S_all, lam)
        S_new = lie.exp_sim3(dx) @ S_all
        chi2_new = chi2_fn(S_new)
        accept = chi2_new < chi2_old
        S_all = torch.where(accept, S_new, S_all)
        lam = torch.where(accept, torch.clamp(lam * 0.4, min=1e-7), torch.clamp(lam * 8.0, max=1e4))
        chi2_old = torch.where(accept, chi2_new, chi2_old)
    return S_all


def _normal_blocks(r, Ji, Jj, edge_valid):
    w = edge_valid[:, None, None]
    JiW, JjW = Ji * w, Jj * w
    return JiW, JjW, -torch.einsum("eab,ea->eb", JiW, r), -torch.einsum("eab,ea->eb", JjW, r)


def optimize_pose_graph(poses, fixed, edge_i, edge_j, edge_meas, edge_valid,
                        iterations: int = 25, damping: float = 1e-3, fix_scale: bool = False):
    """Dense LM over Sim(3) tangents. poses (K, 4, 4) S_cw; fixed (K,) 1.0 =
    held; edge_i / edge_j (E,); edge_meas (E, 4, 4) measured S_ij =
    S_iw . S_jw^-1; edge_valid (E,). Returns the optimized (K, 4, 4)."""
    K = poses.shape[0]
    edge_i, edge_j = edge_i.long(), edge_j.long()
    res_and_jac, chi2 = _make_linearizer(poses, edge_i, edge_j, edge_meas, edge_valid)
    deltas = torch.eye(4, dtype=poses.dtype, device=poses.device).expand(K, 4, 4).contiguous()
    free = _free_mask(fixed, fix_scale).reshape(-1)
    eye = torch.eye(7 * K, dtype=poses.dtype, device=poses.device)

    def solve(S_all, lam):
        r, Ji, Jj = res_and_jac(S_all)
        JiW, JjW, bi, bj = _normal_blocks(r, Ji, Jj, edge_valid)
        blocks = torch.cat([
            torch.einsum("eab,eac->ebc", JiW, Ji), torch.einsum("eab,eac->ebc", JjW, Jj),
            torch.einsum("eab,eac->ebc", JiW, Jj), torch.einsum("eab,eac->ebc", JjW, Ji),
        ])
        cell = torch.cat([edge_i * K + edge_i, edge_j * K + edge_j,
                          edge_i * K + edge_j, edge_j * K + edge_i])
        H = _scatter_add(K * K, cell, blocks).reshape(K, K, 7, 7)
        b = _scatter_add(K, torch.cat([edge_i, edge_j]), torch.cat([bi, bj]))
        Hd = H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        Hd = Hd * (free[:, None] * free[None, :]) + torch.diag(1.0 - free)
        Hd = Hd + lam * eye
        rhs = b.reshape(-1) * free
        return (torch.linalg.solve_ex(Hd, rhs)[0] * free).reshape(K, 7)

    out = _lm_loop(deltas, solve, chi2, iterations, damping)
    return out @ poses


def _cg(matvec, precond, b, maxiter: int, tol: float, stats):
    """Preconditioned conjugate gradient with `jax.scipy.sparse.linalg.cg`'s
    recurrences and exit test (|r|^2 <= tol^2 |b|^2, or maxiter). Converged
    state is frozen by a mask; the host reads the flag every
    CG_CHECK_EVERY iterations."""
    atol2 = tol * tol * torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p, gamma = z, torch.sum(r * z)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for it in range(maxiter):
        running = torch.sum(r * r) > atol2
        if it % CG_CHECK_EVERY == 0 and not bool(running):
            break
        Ap = matvec(p)
        alpha = gamma / torch.sum(p * Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = precond(r_)
        gamma_ = torch.sum(r_ * z_)
        p_ = z_ + (gamma_ / gamma) * p
        x, r = torch.where(running, x_, x), torch.where(running, r_, r)
        p, gamma = torch.where(running, p_, p), torch.where(running, gamma_, gamma)
        k = k + running.to(torch.int64)
    if stats is not None:
        stats.setdefault("cg_iters", []).append(int(k))
    return x


def optimize_pose_graph_cg(poses, fixed, edge_i, edge_j, edge_meas, edge_valid,
                           iterations: int = 25, damping: float = 1e-3, fix_scale: bool = False,
                           cg_iters: int = 2048, stats: dict | None = None):
    """Matrix-free LM: each step solves the damped normal equations by
    block-Jacobi-preconditioned CG with H applied edge-wise; H is never
    materialized. `stats`, when given, gets the CG iterations of each LM
    step under "cg_iters"."""
    K = poses.shape[0]
    edge_i, edge_j = edge_i.long(), edge_j.long()
    res_and_jac, chi2 = _make_linearizer(poses, edge_i, edge_j, edge_meas, edge_valid)
    deltas = torch.eye(4, dtype=poses.dtype, device=poses.device).expand(K, 4, 4).contiguous()
    free = _free_mask(fixed, fix_scale)
    eye7 = torch.eye(7, dtype=poses.dtype, device=poses.device)
    ev = edge_valid[:, None]

    def solve(S_all, lam):
        r, Ji, Jj = res_and_jac(S_all)
        JiW, JjW, bi, bj = _normal_blocks(r, Ji, Jj, edge_valid)
        b = _scatter_add(K, torch.cat([edge_i, edge_j]), torch.cat([bi, bj])) * free

        # block-Jacobi preconditioner (free dims only; identity elsewhere)
        Hbd = _scatter_add(K, torch.cat([edge_i, edge_j]),
                           torch.cat([torch.einsum("eab,eac->ebc", JiW, Ji),
                                      torch.einsum("eab,eac->ebc", JjW, Jj)]))
        Hbd = Hbd * free[:, :, None] * free[:, None, :]
        Hbd = Hbd + eye7[None] * (lam + 1e-6)
        Hbd = Hbd + eye7[None] * (1.0 - free)[..., None] * eye7[None]
        M_blocks = torch.linalg.inv_ex(Hbd)[0]

        def matvec(x):
            x = x * free
            re = (torch.einsum("eab,eb->ea", Ji, x[edge_i])
                  + torch.einsum("eab,eb->ea", Jj, x[edge_j])) * ev
            y = _scatter_add(K, torch.cat([edge_i, edge_j]),
                             torch.cat([torch.einsum("eab,ea->eb", Ji, re),
                                        torch.einsum("eab,ea->eb", Jj, re)]))
            return y * free + lam * x + x * (1.0 - free)

        def precond(x):
            return torch.einsum("kab,kb->ka", M_blocks, x)

        return _cg(matvec, precond, b, cg_iters, 1e-8, stats) * free

    out = _lm_loop(deltas, solve, chi2, iterations, damping)
    return out @ poses
