"""Bundle adjustment: dspslam_tpu.backend.ba.bundle_adjust against the PyTorch
port's, on the cases of tests/test_backend.py::TestBundleAdjustment (5
keyframes, 100 points, 0.25 px noise; a joint problem with one object seen
by 4 keyframes), made from one numpy seed.

Tolerances: poses within 1e-4 and points within 1e-3 after the 5 + 10
iteration schedule and after the global BA's single round of 10 (f32 normal equations summed in another order, through
15 LM steps), equal inlier masks, object-edge Jacobians within 1e-5 of
JAX's `jacfwd`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.backend import ba as jba
from dspslam_tpu.ops import lie as jlie
from dspslam_tpu_torch.backend import ba as tba
from dspslam_tpu_torch.ops import lie as tlie

FX, FY, CX, CY, BF = 500.0, 500.0, 320.0, 240.0, 200.0
INTR = np.asarray([FX, FY, CX, CY, BF], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: with parallel
    test workers, each worker's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(x):
    return tlie.exp_se3(torch.as_tensor(np.asarray(x, np.float32))).numpy()


def make_world(rng, n_pts, n_kf):
    pts = np.stack([rng.uniform(-5, 5, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 20, n_pts)], axis=-1).astype(np.float32)
    poses = np.stack([_exp([0.4 * i, 0, 0, 0, 0.02 * i, 0]) for i in range(n_kf)])
    return pts, poses


def project_all(rng, poses, pts, noise):
    obs_kf, obs_pt, obs_uvr = [], [], []
    for k, T in enumerate(poses):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        u = FX * pc[:, 0] / pc[:, 2] + CX
        v = FY * pc[:, 1] / pc[:, 2] + CY
        ok = (pc[:, 2] > 0.1) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
        for p in np.nonzero(ok)[0]:
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uvr.append([u[p], v[p], u[p] - BF / pc[p, 2]] + rng.normal(0, noise, 3))
    return np.asarray(obs_kf, np.int32), np.asarray(obs_pt, np.int32), np.asarray(obs_uvr, np.float32)


def pad_problem(poses, pts, k, p, uvr, K, P, O):
    n = len(k)
    obs_kf, obs_pt = np.zeros(O, np.int32), np.zeros(O, np.int32)
    obs_uvr, obs_valid = np.zeros((O, 3), np.float32), np.zeros(O, np.float32)
    obs_kf[:n], obs_pt[:n], obs_uvr[:n], obs_valid[:n] = k, p, uvr, 1
    kf_poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf_poses[: len(poses)] = poses
    points, pt_valid = np.zeros((P, 3), np.float32), np.zeros(P, np.float32)
    points[: len(pts)], pt_valid[: len(pts)] = pts, 1
    return kf_poses, points, pt_valid, obs_kf, obs_pt, obs_uvr, obs_valid


def run_both(kf_poses, kf_fixed, points, pt_valid, obs_kf, obs_pt, obs_uvr, obs_stereo,
             obs_valid, obj_state=None, schedule=None):
    O = len(obs_kf)
    args = [kf_poses, kf_fixed, points, pt_valid, obs_kf, obs_pt, obs_uvr, obs_stereo,
            np.ones(O, np.float32), obs_valid, INTR]
    kw = {} if schedule is None else {"schedule": schedule}
    j = jba.bundle_adjust(*[jnp.asarray(a) for a in args], 1e-3,
                          None if obj_state is None else {k: jnp.asarray(v) for k, v in obj_state.items()},
                          **kw)
    t = tba.bundle_adjust(*[torch.from_numpy(a) for a in args], 1e-3,
                          None if obj_state is None else {k: torch.from_numpy(v) for k, v in obj_state.items()},
                          **kw)
    return {k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()}


def _noisy_problem():
    """test_refines_noisy_geometry's problem, plus 12 gross outliers and
    mono-only observations (u_right unobserved) on every third slot."""
    rng = np.random.default_rng(42)
    pts_true, poses_true = make_world(rng, 100, 5)
    k, p, uvr = project_all(rng, poses_true, pts_true, 0.25)
    uvr[:12, :2] += rng.normal(0, 40.0, (12, 2)).astype(np.float32)
    poses_init = poses_true.copy()
    for i in range(1, 5):
        poses_init[i] = _exp(rng.normal(0, 0.02, 6)) @ poses_init[i]
    pts_init = pts_true + rng.normal(0, 0.08, pts_true.shape).astype(np.float32)
    K, P, O = 5, 128, 1024
    kf_poses, points, pt_valid, obs_kf, obs_pt, obs_uvr, obs_valid = pad_problem(
        poses_init, pts_init, k, p, uvr, K, P, O)
    kf_fixed = np.zeros(K, np.float32)
    kf_fixed[0] = 1
    obs_stereo = np.ones(O, np.float32)
    obs_stereo[::3] = 0
    return (kf_poses, kf_fixed, points, pt_valid, obs_kf, obs_pt, obs_uvr, obs_stereo, obs_valid), \
        (poses_true, poses_init, pts_true, pts_init, len(k))


@pytest.fixture(scope="module")
def noisy_geometry():
    problem, extra = _noisy_problem()
    j, t = run_both(*problem)
    return (j, t) + extra


def test_global_ba_schedule_matches_jax(noisy_geometry):
    """schedule=(10,), the global BA's: one round of 10 iterations and no
    outlier drop, against JAX on the same window; the default (5, 10) is
    the fixture's run above."""
    problem, _ = _noisy_problem()
    j, t = run_both(*problem, schedule=(10,))
    assert np.abs(t["kf_poses"] - j["kf_poses"]).max() <= 1e-4
    assert np.abs(t["points"] - j["points"]).max() <= 1e-3
    # no reclassification: every valid observation is still an inlier
    np.testing.assert_array_equal(t["obs_inlier"], problem[-1])
    np.testing.assert_array_equal(j["obs_inlier"], problem[-1])
    assert not np.array_equal(t["kf_poses"], noisy_geometry[1]["kf_poses"])


def test_refines_noisy_geometry_matches_jax(noisy_geometry):
    j, t, _, _, _, _, n = noisy_geometry
    assert np.abs(t["kf_poses"] - j["kf_poses"]).max() <= 1e-4
    assert np.abs(t["points"] - j["points"]).max() <= 1e-3
    np.testing.assert_array_equal(t["obs_inlier"], j["obs_inlier"])
    # the gross outliers were dropped, the rest kept
    assert t["obs_inlier"][:12].sum() <= 2 and t["obs_inlier"][12:n].mean() > 0.9


def test_refines_noisy_geometry(noisy_geometry):
    _, t, poses_true, poses_init, pts_true, pts_init, _ = noisy_geometry
    new = torch.from_numpy(t["kf_poses"])
    for i in range(1, 5):
        err0 = tlie.log_se3(torch.from_numpy(poses_init[i] @ np.linalg.inv(poses_true[i]))).norm()
        err1 = tlie.log_se3(new[i] @ torch.from_numpy(np.linalg.inv(poses_true[i]))).norm()
        assert err1 < 0.5 * err0
    np.testing.assert_allclose(t["kf_poses"][0], poses_init[0], atol=1e-6)
    new_pts = t["points"][: len(pts_true)]
    assert np.median(np.linalg.norm(new_pts - pts_true, axis=-1)) < \
        np.median(np.linalg.norm(pts_init - pts_true, axis=-1))


@pytest.fixture(scope="module")
def joint_problem():
    rng = np.random.default_rng(7)
    pts_true, poses_true = make_world(rng, 80, 4)
    k, p, uvr = project_all(rng, poses_true, pts_true, 0.2)
    K, P, O = 4, 128, 1024
    kf_poses, points, pt_valid, obs_kf, obs_pt, obs_uvr, obs_valid = pad_problem(
        poses_true, pts_true, k, p, uvr, K, P, O)
    kf_fixed = np.zeros(K, np.float32)
    kf_fixed[0] = 1
    T_wo_true = _exp([1.0, 0.2, 12.0, 0.0, 0.4, 0.0])
    M, Q = 2, 8
    obj_poses = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    obj_poses[0] = _exp([0.1, -0.08, 0.12, 0.03, -0.04, 0.02]) @ T_wo_true
    obj_state = {
        "poses": obj_poses, "fixed": np.array([0.0, 1.0], np.float32),
        "edge_kf": np.zeros(Q, np.int32), "edge_obj": np.zeros(Q, np.int32),
        "edge_Tco": np.tile(np.eye(4, dtype=np.float32), (Q, 1, 1)),
        "edge_valid": np.zeros(Q, np.float32),
    }
    for i in range(4):
        obj_state["edge_kf"][i] = i
        obj_state["edge_Tco"][i] = poses_true[i] @ T_wo_true
        obj_state["edge_valid"][i] = 1
    # a fifth edge with a grossly wrong measurement: the reclassification
    # between the rounds drops it
    obj_state["edge_kf"][4] = 2
    obj_state["edge_Tco"][4] = _exp([2.0, 0.0, -3.0, 0.5, 0.0, 0.0]) @ poses_true[2] @ T_wo_true
    obj_state["edge_valid"][4] = 1
    j, t = run_both(kf_poses, kf_fixed, points, pt_valid, obs_kf, obs_pt, obs_uvr,
                    np.ones(O, np.float32), obs_valid, obj_state)
    return j, t, T_wo_true


def test_joint_ba_matches_jax(joint_problem):
    j, t, _ = joint_problem
    for key in ("kf_poses", "obj_poses"):
        assert np.abs(t[key] - j[key]).max() <= 1e-4, key
    assert np.abs(t["points"] - j["points"]).max() <= 1e-3
    np.testing.assert_array_equal(t["obs_inlier"], j["obs_inlier"])
    np.testing.assert_array_equal(t["obj_edge_inlier"], j["obj_edge_inlier"])


def test_joint_ba_recovers_object_pose(joint_problem):
    _, t, T_wo_true = joint_problem
    err = tlie.log_se3(torch.from_numpy(t["obj_poses"][0] @ np.linalg.inv(T_wo_true)))
    assert float(err.norm()) < 0.01
    np.testing.assert_allclose(t["obj_poses"][1], np.eye(4), atol=1e-5)
    np.testing.assert_array_equal(t["obj_edge_inlier"][:5], [1, 1, 1, 1, 0])


def test_object_edge_jacobians_match_jax_jacfwd():
    rng = np.random.default_rng(3)
    Q = 16
    T_cw = np.stack([_exp(np.r_[rng.normal(0, 2, 3), rng.normal(0, 0.6, 3)]) for _ in range(Q)])
    T_wo = np.stack([_exp(np.r_[rng.normal(0, 5, 3), rng.normal(0, 0.8, 3)]) for _ in range(Q)])
    # measurements near the truth, and a few exactly at it (|e| = 0)
    Z = np.stack([_exp(rng.normal(0, 0.1, 6) * (i % 4 != 0)) @ T_cw[i] @ T_wo[i] for i in range(Q)])
    idx = np.arange(Q, dtype=np.int32)
    rj, Jcj, Joj = jba._object_residuals_and_jac(jnp.asarray(T_cw), jnp.asarray(T_wo), jnp.asarray(idx),
                                                 jnp.asarray(idx), jnp.asarray(Z))
    rt, Jct, Jot = tba.object_residuals_and_jac(*(torch.from_numpy(a) for a in (T_cw, T_wo)),
                                                torch.from_numpy(idx).long(), torch.from_numpy(idx).long(),
                                                torch.from_numpy(Z.astype(np.float32)))
    assert np.abs(rt.numpy() - np.asarray(rj)).max() <= 1e-5
    assert np.abs(Jct.numpy() - np.asarray(Jcj)).max() <= 1e-5
    assert np.abs(Jot.numpy() - np.asarray(Joj)).max() <= 1e-5


def test_object_edge_residual_zero_at_truth():
    T_cw = torch.from_numpy(_exp([0.3, 0.1, -0.2, 0.05, 0.1, 0.0]))
    T_wo = torch.from_numpy(_exp([1.0, 0.0, 5.0, 0.0, 0.3, 0.0]))
    r = tba.object_residual(T_cw, T_wo, T_cw @ T_wo)
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-5)
    rj = jba._object_residual_single(jnp.asarray(T_cw.numpy()), jnp.asarray(T_wo.numpy()),
                                     jnp.asarray((T_cw @ T_wo).numpy()))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-6)
