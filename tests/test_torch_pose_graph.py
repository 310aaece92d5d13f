"""Sim(3) pose graph: dspslam_tpu.backend.pose_graph against the PyTorch
port's, on the graphs of tests/test_place.py::TestPoseGraph (a drifted
10-vertex chain with a loop edge, padded here to the circle's 64 vertices
and 64 edges, so that JAX compiles one program for both)
and tests/test_pose_graph_scale.py::test_cg_solver_matches_dense (a
drifted 64-vertex circle).

Tolerances: on random edges (entries up to ~6) the closed-form edge
Jacobians agree with float64 central differences within 1e-5 and with
JAX's f32 `jacfwd` within 2e-4 (JAX's own f32 rounding: it is 2.8e-5 /
4.6e-5 from float64 there, the port 1.2e-6 / 1.6e-6); optimized poses agree
within 1e-4 for the dense and for the CG solver. The port's CG freezes its
state once converged, so it equals a CG that exits early, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.backend import pose_graph as jpg
from dspslam_tpu.ops import lie as jlie
from dspslam_tpu_torch.backend import pose_graph as tpg
from dspslam_tpu_torch.ops import lie as tlie
from torch_threads import one_torch_thread  # noqa: F401


def _rand_sim3(rng, t=1.0, rot=0.3, s=0.05):
    x = np.concatenate([rng.normal(0, t, 3), rng.normal(0, rot, 3), rng.normal(0, s, 1)])
    return np.asarray(jlie.exp_sim3(jnp.asarray(x, jnp.float32)))


def test_edge_jacobians_match_jacfwd():
    rng = np.random.default_rng(0)
    E = 24
    Z, Dj, Di = (np.stack([_rand_sim3(rng) for _ in range(E)]) for _ in range(3))
    P = np.stack([_rand_sim3(rng, t=3.0) for _ in range(E)])

    def f(xi, xj, Z, Dj, P, Di):
        return jlie.log_sim3(Z @ (jlie.exp_sim3(xj) @ Dj) @ P
                             @ jlie.inverse_sim3(jlie.exp_sim3(xi) @ Di))

    z = jnp.zeros(7)
    Ji = jax.vmap(lambda *a: jax.jacfwd(f, 0)(z, z, *a))(Z, Dj, P, Di)
    Jj = jax.vmap(lambda *a: jax.jacfwd(f, 1)(z, z, *a))(Z, Dj, P, Di)
    E_mat = np.asarray(jnp.asarray(Z) @ Dj @ P @ jax.vmap(jlie.inverse_sim3)(jnp.asarray(Di)))
    r, ti, tj = tpg.edge_residuals_and_jacobians(torch.from_numpy(E_mat.copy()), torch.from_numpy(Z))
    assert ti.dtype == torch.float32
    np.testing.assert_allclose(r.numpy(), np.asarray(jax.vmap(jlie.log_sim3)(E_mat)), atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(Ji), atol=2e-4)
    np.testing.assert_allclose(tj.numpy(), np.asarray(Jj), atol=2e-4)

    # float64 central differences of the same composition
    E64, Z64 = torch.from_numpy(E_mat).double(), torch.from_numpy(Z).double()
    h = 1e-6
    for J, left in ((ti, False), (tj, True)):
        cols = []
        for d in range(7):
            dx = torch.zeros(E, 7, dtype=torch.float64)
            dx[:, d] = h
            plus, minus = tlie.exp_sim3(dx), tlie.exp_sim3(-dx)
            if left:       # Z exp(d) Z^-1 E
                Zi = tlie.inverse_sim3(Z64)
                fp, fm = Z64 @ plus @ Zi @ E64, Z64 @ minus @ Zi @ E64
            else:          # E exp(-d)
                fp, fm = E64 @ minus, E64 @ plus
            cols.append((tlie.log_sim3(fp) - tlie.log_sim3(fm)) / (2 * h))
        np.testing.assert_allclose(J.numpy(), torch.stack(cols, -1).numpy(), atol=1e-5)


def _chain_graph():
    """tests/test_place.py's chain: truth x = i, drifted estimate 1.1 i."""
    K = 10
    true = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    true[:, 0, 3] = -np.arange(K, dtype=np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    poses[:K, 0, 3] = -np.arange(K, dtype=np.float32) * 1.1
    fixed = np.ones(64, np.float32)
    fixed[1:K] = 0
    ei, ej = np.zeros(64, np.int32), np.zeros(64, np.int32)
    em = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    ev = np.zeros(64, np.float32)
    pairs = [(i, i - 1) for i in range(1, K)] + [(9, 0)]
    for n, (i, j) in enumerate(pairs):
        ei[n], ej[n], em[n], ev[n] = i, j, true[i] @ np.linalg.inv(true[j]), 1.0
    return (poses, fixed, ei, ej, em, ev), true


def _circle_graph():
    """tests/test_pose_graph_scale.py's drifted 64-vertex circle."""
    def yawmat(y):
        c, s = np.cos(y), np.sin(y)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    K = 64
    R_circ = K * 0.5 / (2 * np.pi)
    true, est = [], []
    dyaw, dt = 0.0, np.zeros(3)
    for k in range(K):
        th = 2 * np.pi * k / K
        C = np.array([R_circ * np.sin(th), 0.0, R_circ * (1 - np.cos(th))], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = yawmat(th), C
        true.append(np.linalg.inv(T).astype(np.float32))
        dyaw += 1e-4
        dt = dt + np.array([0.002, 0.0008, 0.0])
        Td = T.copy()
        Td[:3, :3], Td[:3, 3] = yawmat(th + dyaw), C + dt
        est.append(np.linalg.inv(Td).astype(np.float32))
    true, est = np.stack(true), np.stack(est)
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1.0
    pairs = [(k, k - 1) for k in range(1, K)] + [(K - 1, 0)]
    ei = np.array([i for i, _ in pairs], np.int32)
    ej = np.array([j for _, j in pairs], np.int32)
    em = np.stack([true[i] @ np.linalg.inv(true[j]) for i, j in pairs]).astype(np.float32)
    return (est, fixed, ei, ej, em, np.ones(len(pairs), np.float32)), true


def _cam(T):
    return -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])


def test_dense_matches_jax_on_drift_chain():
    args, true = _chain_graph()
    j = np.asarray(jpg.optimize_pose_graph(*[jnp.asarray(a) for a in args]))
    t = tpg.optimize_pose_graph(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4)
    assert np.abs(t[:10, 0, 3] - true[:, 0, 3]).max() < 0.05


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_circle_matches_jax(solver):
    args, true = _circle_graph()
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    if solver == "dense":
        j = np.asarray(jpg.optimize_pose_graph(*jargs))
        t = tpg.optimize_pose_graph(*targs).numpy()
    else:
        j = np.asarray(jpg.optimize_pose_graph_cg(*jargs, cg_iters=256))
        stats = {}
        t = tpg.optimize_pose_graph_cg(*targs, cg_iters=256, stats=stats).numpy()
        assert len(stats["cg_iters"]) == 25 and max(stats["cg_iters"]) <= 256
    np.testing.assert_allclose(t, j, atol=1e-4)
    init_err = np.abs(_cam(args[0]) - _cam(true)).max()
    assert np.abs(_cam(t) - _cam(true)).max() < 0.05 * init_err


def test_masked_cg_equals_early_exit():
    """A 40-dim SPD system: the port's CG (masked after convergence, host
    check every CG_CHECK_EVERY iterations) against a plain CG loop that
    breaks at the first converged iteration."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(40, 40))
    A = torch.from_numpy((A @ A.T + 40 * np.eye(40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))
    diag = torch.diagonal(A)

    def mv(x):
        return A @ x

    def pre(x):
        return x / diag

    stats = {}
    x_port = tpg._cg(mv, pre, b, 2048, 1e-6, stats)
    x = torch.zeros_like(b)
    r = b - mv(x)
    z = pre(r)
    p, gamma, k = z, torch.sum(r * z), 0
    while torch.sum(r * r) > 1e-12 * torch.sum(b * b) and k < 2048:
        Ap = mv(p)
        alpha = gamma / torch.sum(p * Ap)
        x, r = x + alpha * p, r - alpha * Ap
        z = pre(r)
        gamma_ = torch.sum(r * z)
        p, gamma, k = z + (gamma_ / gamma) * p, gamma_, k + 1
    assert stats["cg_iters"] == [k] and 0 < k % tpg.CG_CHECK_EVERY
    assert torch.equal(x_port, x)
