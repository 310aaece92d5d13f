"""Parity of the PyTorch port's Lie-group and robust ops with the JAX package.

Inputs are drawn with numpy from a seed and fed to both packages. Random
tangents include tiny rotations (|theta| < 1e-3) and scales near zero, which
sit inside the series branches of `_sinc_coeffs` (theta^2 < 0.01) and
`sim3_w_matrix` (theta^2 + s^2 < 0.01).

Tolerance: 1e-5 absolute on unit-scale outputs. Both sides are f32; the
only differences are the order of f32 operations and the last ulps of
sin/cos/exp/sqrt (~1e-7 relative), amplified by at most a few 4x4
products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.ops import lie as jlie
from dspslam_tpu.ops import robust as jrobust
from dspslam_tpu_torch.ops import lie as tlie
from dspslam_tpu_torch.ops import robust as trobust
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _tangents(dim: int, seed: int = 0) -> np.ndarray:
    """(24, dim) tangents: 8 generic, 8 with |theta| < 1e-3, 8 with both a
    tiny rotation and scale ~0 (dim 7) or exactly zero rotation."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (24, dim))
    x[8:16, 3:6] *= 1e-3 / np.linalg.norm(x[8:16, 3:6], axis=-1, keepdims=True) * 0.5
    x[16:, 3:6] = rng.normal(0, 1e-5, (8, 3))
    x[20:, 3:6] = 0.0
    if dim == 7:
        x[16:, 6] = rng.normal(0, 1e-7, 8)
        x[12:16, 6] = rng.normal(0, 0.03, 4)
    return x.astype(np.float32)


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=atol, rtol=0)


@pytest.mark.parametrize("fn", ["exp_so3", "so3_left_jacobian", "hat"])
def test_so3_maps(fn):
    w = _tangents(6)[:, 3:6]
    _close(getattr(tlie, fn)(torch.from_numpy(w)), getattr(jlie, fn)(jnp.asarray(w)))


def test_vee_inverts_hat():
    w = torch.from_numpy(_tangents(6)[:, 3:6])
    _close(tlie.vee(tlie.hat(w)), w.numpy(), atol=0)


@pytest.mark.parametrize("fn,dim", [("exp_se3", 6), ("exp_sim3", 7)])
def test_exp(fn, dim):
    x = _tangents(dim)
    _close(getattr(tlie, fn)(torch.from_numpy(x)), getattr(jlie, fn)(jnp.asarray(x)))


def test_sim3_w_matrix_series_and_closed_form():
    x = _tangents(7, seed=1)
    w, s = x[:, 3:6], x[:, 6]
    # both branches are exercised: the series region and the closed form
    use_series = (np.sum(w * w, -1) + s * s) < 0.01
    assert use_series.any() and (~use_series).any()
    _close(
        tlie.sim3_w_matrix(torch.from_numpy(w), torch.from_numpy(s)),
        jlie.sim3_w_matrix(jnp.asarray(w), jnp.asarray(s)),
    )


@pytest.mark.parametrize("fn,exp,dim", [("log_se3", "exp_se3", 6), ("log_sim3", "exp_sim3", 7)])
def test_log(fn, exp, dim):
    x = _tangents(dim, seed=2)
    T = np.array(getattr(jlie, exp)(jnp.asarray(x)))
    # log amplifies f32 rounding of T near theta = 0 (1/sin terms): 1e-4
    _close(getattr(tlie, fn)(torch.from_numpy(T)), getattr(jlie, fn)(jnp.asarray(T)), atol=1e-4)


@pytest.mark.parametrize("fn", ["inverse_se3", "inverse_sim3"])
def test_inverse(fn):
    dim = 6 if fn == "inverse_se3" else 7
    T = np.array((jlie.exp_se3 if dim == 6 else jlie.exp_sim3)(jnp.asarray(_tangents(dim, 3))))
    _close(getattr(tlie, fn)(torch.from_numpy(T)), getattr(jlie, fn)(jnp.asarray(T)))


def test_split_sim3():
    T = np.array(jlie.exp_sim3(jnp.asarray(_tangents(7, 4))))
    for a, b in zip(tlie.split_sim3(torch.from_numpy(T)), jlie.split_sim3(jnp.asarray(T))):
        _close(a, b)


def test_transform_points_and_pose_jacobian():
    rng = np.random.default_rng(5)
    T = np.array(jlie.exp_sim3(jnp.asarray(_tangents(7, 5))))[:4]   # (4, 4, 4)
    pts = rng.normal(size=(4, 10, 3)).astype(np.float32)
    # 1e-5 relative to the O(1) points and scales: 4x magnitudes here
    _close(
        tlie.transform_points(torch.from_numpy(T), torch.from_numpy(pts)),
        jlie.transform_points(jnp.asarray(T), jnp.asarray(pts)), atol=4 * ATOL,
    )
    _close(
        tlie.points_to_pose_jacobian_sim3(torch.from_numpy(pts)),
        jlie.points_to_pose_jacobian_sim3(jnp.asarray(pts)), atol=0,
    )


def test_rt_to_mat44_broadcasts():
    R = torch.eye(3).expand(5, 3, 3)
    t = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    T = tlie.rt_to_mat44(R, t)
    _close(T, jlie.rt_to_mat44(jnp.asarray(R.numpy()), jnp.asarray(t.numpy())), atol=0)


# ---------------------------------------------------------------------------
# robust


def _residuals(seed=6):
    rng = np.random.default_rng(seed)
    res = (rng.normal(0, 0.2, (3, 40)) * rng.choice([1, 10], (3, 40))).astype(np.float32)
    res[:, :3] = 0.0                                   # the r == 0 branch
    mask = (rng.uniform(size=(3, 40)) > 0.3).astype(np.float32)
    return res, mask


def test_huber_weights():
    res, _ = _residuals()
    _close(trobust.huber_weights(torch.from_numpy(res), 0.2),
           jrobust.huber_weights(jnp.asarray(res), 0.2), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_robust_residuals_reduce_per_object(masked):
    """The port reduces the loss over the last axis (objects lead); each row
    must equal the JAX call on that row alone."""
    res, mask = _residuals()
    t_rob, t_loss, t_w = trobust.robust_residuals(
        torch.from_numpy(res), 0.2, torch.from_numpy(mask) if masked else None
    )
    for i in range(res.shape[0]):
        j_rob, j_loss, j_w = jrobust.robust_residuals(
            jnp.asarray(res[i]), 0.2, jnp.asarray(mask[i]) if masked else None
        )
        _close(t_rob[i], j_rob, atol=1e-6)
        _close(t_w[i], j_w, atol=1e-6)
        np.testing.assert_allclose(float(t_loss[i]), float(j_loss), rtol=1e-5)
