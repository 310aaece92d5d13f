"""Motion-only pose GN of the PyTorch port against dspslam_tpu/slam/pose_opt.py,
plus the SE(3) pieces it needs (ops/lie.py, ops/lie_np.py).

Observations are seeded: world points in front of a camera, projected
through a perturbed ground-truth pose with pixel noise, 20% of them
replaced by outliers. Tolerances: Jacobians 1e-6 (a few f32 products);
the GN pose 1e-4 after 4 x 10 iterations (f32 normal equations summed in
another order, solved 40 times); the inlier mask EXACTLY (no residual sits
within f32 noise of a chi2 threshold in these inputs, which the test
checks with a 1% margin).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.ops import lie as jlie
from dspslam_tpu.ops import lie_np as jlie_np
from dspslam_tpu.slam import pose_opt as jpo
from dspslam_tpu_torch.ops import graphs
from dspslam_tpu_torch.ops import lie as tlie
from dspslam_tpu_torch.ops import lie_np as tlie_np
from dspslam_tpu_torch.slam import pose_opt as tpo
from torch_threads import one_torch_thread  # noqa: F401

FX, FY, CX, CY, BF = 400.0, 400.0, 240.0, 80.0, 160.0
INTR = np.array([FX, FY, CX, CY, BF], np.float32)


def test_points_to_pose_jacobian_se3_and_adjoint():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 3, (2, 17, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlie.points_to_pose_jacobian_se3(torch.from_numpy(pts)).numpy(),
        np.asarray(jlie.points_to_pose_jacobian_se3(jnp.asarray(pts))), atol=1e-6, rtol=0)
    T = np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.5, (5, 6)).astype(np.float32))))
    np.testing.assert_allclose(
        tlie.adjoint_se3(torch.from_numpy(np.array(T))).numpy(),
        np.asarray(jlie.adjoint_se3(jnp.asarray(T))), atol=1e-6, rtol=0)


def test_lie_np_is_the_jax_package_copy():
    rng = np.random.default_rng(1)
    for _ in range(5):
        a = jlie_np.exp_se3(rng.normal(0, 0.3, 6))
        b = jlie_np.exp_se3(rng.normal(0, 0.3, 6))
        np.testing.assert_array_equal(tlie_np.interp_se3(a, b, 0.6), jlie_np.interp_se3(a, b, 0.6))
        np.testing.assert_array_equal(tlie_np.log_se3(a), jlie_np.log_se3(a))


def _problem(seed: int, stereo: bool, n=300, cap=400):
    rng = np.random.default_rng(seed)
    T_gt = np.asarray(jlie.exp_se3(jnp.asarray(
        np.r_[rng.normal(0, 0.3, 3), rng.normal(0, 0.05, 3)].astype(np.float32))))
    pc = np.c_[rng.uniform(-6, 6, n), rng.uniform(-2, 2, n), rng.uniform(4, 30, n)]
    R, t = T_gt[:3, :3].astype(np.float64), T_gt[:3, 3].astype(np.float64)
    pts_w = (pc - t) @ R                                   # T_gt maps them back to pc
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    obs = np.c_[u, v, u - BF / pc[:, 2]] + rng.normal(0, 0.7, (n, 3))
    outl = rng.uniform(size=n) < 0.2
    obs[outl, :2] += rng.uniform(-40, 40, (outl.sum(), 2))
    sigma2 = 1.2 ** (2 * rng.integers(0, 3, n))
    out = {
        "pts_w": np.zeros((cap, 3)), "obs": np.zeros((cap, 3)), "inv_s2": np.ones(cap),
        "valid": np.zeros(cap), "smask": np.zeros(cap),
    }
    out["pts_w"][:n], out["obs"][:n], out["inv_s2"][:n] = pts_w, obs, 1.0 / sigma2
    out["valid"][:n] = 1.0
    out["smask"][:n] = 1.0 if stereo else 0.0
    if not stereo:
        out["obs"][:, 2] = 0.0
    out = {k: v.astype(np.float32) for k, v in out.items()}
    T_init = np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.02, 6).astype(np.float32)))) @ T_gt
    return T_init.astype(np.float32), out


@pytest.mark.parametrize("stereo", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_matches_jax(stereo, seed):
    T0, p = _problem(seed, stereo)
    args = [p["pts_w"], p["obs"], p["inv_s2"], p["valid"], p["smask"]]
    T_j, in_j, n_j = jpo.optimize_pose(jnp.asarray(T0), *map(jnp.asarray, args), jnp.asarray(INTR))
    T_t, in_t, n_t = tpo.optimize_pose(torch.from_numpy(T0), *map(torch.from_numpy, args),
                                       torch.from_numpy(INTR))
    assert np.abs(T_t.numpy() - np.asarray(T_j)).max() <= 1e-4
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))
    assert float(n_t) == float(n_j) and 0.6 * 300 < float(n_j) < 0.9 * 300
    # no residual sits within 1% of its chi2 threshold at the final pose
    res, _ = jpo._residuals_and_jac(T_j, *map(jnp.asarray, [p["pts_w"], p["obs"], p["smask"]]), *INTR)
    chi2 = np.sum(np.asarray(res) ** 2, -1) * p["inv_s2"]
    th = np.where(p["smask"] > 0, jpo.CHI2_STEREO, jpo.CHI2_MONO)
    live = p["valid"] > 0
    assert (np.abs(chi2[live] / th[live] - 1.0) > 0.01).all()


def test_project_stereo_matches_jax():
    T0, p = _problem(2, True)
    ref = jpo.project_stereo(jnp.asarray(T0), jnp.asarray(p["pts_w"]), *INTR)
    out = tpo.project_stereo(torch.from_numpy(T0), torch.from_numpy(p["pts_w"]), *INTR.tolist())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-6)


SETTINGS = (1e-3, (4, 10), (1.0, 1.0, 1.0, 1.0))


def _args(seed, stereo, n, cap):
    T0, p = _problem(seed, stereo, n=n, cap=cap)
    return tuple(torch.from_numpy(a) for a in
                 (T0, p["pts_w"], p["obs"], p["inv_s2"], p["valid"], p["smask"], INTR))


@pytest.mark.parametrize("cap", [64, 4096])
@pytest.mark.parametrize("stereo", [True, False])
def test_pose_graph_body_matches_eager(stereo, cap):
    """The body the pose GN's CUDA graph captures (`ops/graphs.py`), run
    here without one on its static buffers: the eager GN's result, and a
    second load's inputs are read (no stale buffer)."""
    g, poses = None, []
    for seed in (3, 4):
        args = _args(seed, stereo, min(300, cap // 2), cap)
        ref = tpo.optimize_pose(*args)
        if g is None:
            g = graphs.Graphs(args, tpo.CUDA_GRAPHS.bodies(*SETTINGS))
        g.load(args)
        for body in g.bodies:
            g.run(body)
        T, inlier, n_in = g.outputs()
        assert (T - ref[0]).abs().max() <= 1e-6
        assert torch.equal(inlier, ref[1]) and float(n_in) == float(ref[2])
        poses.append(T)
    assert not torch.equal(poses[0], poses[1])


def test_cholesky_solve_spd_matches_solve_ex(monkeypatch):
    """The card's solve on damped SPD systems scaled like the GN's, and the
    whole GN with it in place of `solve_ex`."""
    g = torch.Generator().manual_seed(0)
    scale = torch.tensor([400.0, 400.0, 400.0, 3000.0, 3000.0, 3000.0])
    for _ in range(50):
        J = torch.randn(600, 6, generator=g) * scale
        H = J.t() @ J + 1e-3 * torch.eye(6)
        b = torch.randn(6, generator=g) * 1e4
        ref = torch.linalg.solve_ex(H, b).result
        assert (tpo.cholesky_solve_spd(H, b) - ref).norm() <= 1e-5 * ref.norm()
    for stereo in (True, False):
        args = _args(5, stereo, 300, 400)
        ref = tpo.optimize_pose(*args)
        with monkeypatch.context() as m:
            m.setattr(tpo, "_solve", tpo.cholesky_solve_spd)
            out = tpo.optimize_pose(*args)
        assert (out[0] - ref[0]).abs().max() <= 1e-5 and torch.equal(out[1], ref[1])
