"""Parity of the port's shape stack (losses, Gauss-Newton, mesh) with the
JAX package, and the JAX package's sphere-decoder GN tests run on the port.

The small DeepSDF decoder used here (code 8, hidden (32,) * 4, latent at
layer 2) is built so that its SDF is close to a sphere of radius
0.5 + 0.3 * code[0]: 20 first-layer units relu(d_i . xyz) over evenly
spread directions d_i sum to about ||xyz|| * 20 / 4, and one unit carries
the code. Seeded noise on every weight keeps it a generic network. A
sphere-like field keeps the GN problem well conditioned, so the two
packages' trajectories can be compared after several iterations.

Tolerances: residuals and Jacobians within 1e-5 absolute plus 1e-4
relative (both sides are f32 and differ only in operation order; Jacobian
entries reach O(10)). GN poses and codes within 1e-4 after 3 iterations:
each iteration's 71 x 71 solve amplifies the ~1e-7 relative differences
of the normal equations by the condition number of the damped system.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu.ops import lie as jlie
from dspslam_tpu.shape import gn as jgn
from dspslam_tpu.shape import losses as jlosses
from dspslam_tpu.shape import mesh as jmesh
from dspslam_tpu_torch.models import deepsdf
from dspslam_tpu_torch.ops import lie
from dspslam_tpu_torch.shape import gn, losses, mesh

from test_shape import (
    C0_TRUE,
    CENTER,
    CODE_LEN,
    R_TRUE,
    SCALE,
    make_rays,
    make_surface_points,
    true_pose,
)
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(code_len=CODE_LEN, hidden=(32,) * 4, latent_in=(2,))


def sphere_like_params(seed=0, noise=1e-3):
    """(in, out) numpy weights of the small decoder, sdf ~ ||x|| - 0.5 - 0.3 c0."""
    cfg = jdeepsdf.DecoderConfig(**SMALL)
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, noise, (i, o)).astype(np.float32) for i, o in cfg.layer_dims()]
    bs = [rng.normal(0, noise, (o,)).astype(np.float32) for _, o in cfg.layer_dims()]
    n_dir = 20
    k = np.arange(n_dir) + 0.5                      # Fibonacci sphere
    z = 1.0 - 2.0 * k / n_dir
    phi = np.pi * (1.0 + 5**0.5) * k
    dirs = np.stack([np.sqrt(1 - z * z) * np.cos(phi), np.sqrt(1 - z * z) * np.sin(phi), z], -1)
    ws[0][CODE_LEN:, :n_dir] += dirs.T
    ws[0][0, n_dir] += 0.3
    bs[0][n_dir] += 1.0
    for layer in (1, 2, 3):                          # carry units 0..20 through
        ws[layer][np.arange(n_dir + 1), np.arange(n_dir + 1)] += 1.0
    ws[4][:n_dir, 0] += 4.0 / n_dir
    ws[4][n_dir, 0] += -1.0
    bs[4][0] += 0.5
    return {"w": ws, "b": bs}


@pytest.fixture(scope="module")
def small():
    params_np = sphere_like_params()
    cfg = jdeepsdf.DecoderConfig(**SMALL)
    jparams = {k: [jnp.asarray(a) for a in v] for k, v in params_np.items()}
    dec = deepsdf.params_from_jax(params_np, deepsdf.DecoderConfig(**SMALL))
    return jdeepsdf.make_decoder_fn(cfg), jparams, dec


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol)


def perturbed_poses(B, seed, size=0.1):
    dx = np.random.default_rng(seed).normal(0, size, (B, 7)).astype(np.float32)
    return np.array(jlie.exp_sim3(jnp.asarray(dx)) @ true_pose())


def test_small_decoder_is_sphere_like(small):
    _, _, dec = small
    d = np.random.default_rng(0).normal(size=(200, 3))
    x = 0.7 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    inp = torch.from_numpy(np.concatenate([np.zeros((200, CODE_LEN)), x], -1).astype(np.float32))
    assert np.abs(dec(inp).numpy() - np.tanh(0.2)).max() < 0.05


class TestLosses:
    def test_sdf_surface_loss(self, small):
        jfn, jparams, dec = small
        B = 2
        pts, mask = make_surface_points(n=48)
        T = perturbed_poses(B, seed=1)
        code = np.random.default_rng(2).normal(0, 0.1, (B, CODE_LEN)).astype(np.float32)
        mask_b = np.stack([np.asarray(mask), (np.arange(48) < 30).astype(np.float32)])
        J, r, m = losses.sdf_surface_loss(
            dec, t(np.stack([pts] * B)), t(mask_b), lie.inverse_sim3(t(T)), t(code)
        )
        for b in range(B):
            Jj, rj, mj = jlosses.sdf_surface_loss(
                jfn, jparams, pts, jnp.asarray(mask_b[b]), jlie.inverse_sim3(jnp.asarray(T[b])),
                jnp.asarray(code[b]),
            )
            close(J[b], Jj)
            close(r[b], rj)
            close(m[b], mj, atol=0)

    def test_render_loss(self, small):
        jfn, jparams, dec = small
        B, S, K = 2, 16, 128
        rays, ray_mask, depth, fg_mask = make_rays(n_fg=40, n_bg=24, seed=3)
        T = perturbed_poses(B, seed=4)
        code = np.random.default_rng(5).normal(0, 0.1, (B, CODE_LEN)).astype(np.float32)
        stack = lambda a: t(np.stack([np.asarray(a)] * B))
        J, r, m, aux = losses.render_loss(
            dec, stack(rays), stack(ray_mask), stack(depth), stack(fg_mask),
            lie.inverse_sim3(t(T)), t(code), num_samples=S, max_grad_points=K,
        )
        for b in range(B):
            Jj, rj, mj, auxj = jlosses.render_loss(
                jfn, jparams, rays, ray_mask, depth, fg_mask,
                jlie.inverse_sim3(jnp.asarray(T[b])), jnp.asarray(code[b]),
                num_samples=S, max_grad_points=K,
            )
            assert int(aux["n_valid_query"][b]) == int(auxj["n_valid_query"]) > 0
            assert float(aux["n_grad"][b]) == float(auxj["n_grad"]) > 0
            close(m[b], mj, atol=0, rtol=0)
            close(J[b], Jj)
            close(r[b], rj)
            close(aux["d_u"][b], auxj["d_u"])

    def test_topk_tie_break_matches_jax(self):
        """More in-band samples than K: the port must pick the same rows as
        jax.lax.top_k (lowest indices first among equal scores)."""
        K = 24
        rays, ray_mask, depth, fg_mask = make_rays(seed=6)
        T = perturbed_poses(1, seed=7, size=0.02)
        params_j = jdeepsdf.make_sphere_params(code_len=CODE_LEN)
        dec = deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=CODE_LEN))
        t_obj_cam = jlie.inverse_sim3(jnp.asarray(T[0]))
        code = jnp.zeros(CODE_LEN).at[0].set(C0_TRUE)
        full = jlosses.render_loss(
            jdeepsdf.sphere_decoder_fn, params_j, rays, ray_mask, depth, fg_mask,
            t_obj_cam, code, max_grad_points=96 * 50,
        )[3]["n_grad"]
        assert float(full) > K
        Jj, rj, mj, _ = jlosses.render_loss(
            jdeepsdf.sphere_decoder_fn, params_j, rays, ray_mask, depth, fg_mask,
            t_obj_cam, code, max_grad_points=K,
        )
        J, r, m, aux = losses.render_loss(
            dec, t(rays)[None], t(ray_mask)[None], t(depth)[None], t(fg_mask)[None],
            lie.inverse_sim3(t(T)), t(code)[None], max_grad_points=K,
        )
        assert float(aux["n_grad"][0]) == K
        close(m[0], mj, atol=0, rtol=0)
        close(J[0], Jj)
        close(r[0], rj)

    def test_rotation_prior_loss(self):
        T = perturbed_poses(6, seed=8, size=0.5)
        J, r = losses.rotation_prior_loss(lie.inverse_sim3(t(T)))
        for b in range(6):
            Jj, rj = jlosses.rotation_prior_loss(jlie.inverse_sim3(jnp.asarray(T[b])))
            close(J[b], Jj)
            close(r[b], rj)


@pytest.mark.parametrize("k4,iters,atol", [(0.0, 3, 1e-4), (1e7, 1, 1e-3)])
def test_batched_reconstruct_matches_jax_small_decoder(small, k4, iters, atol):
    """Poses are upright (the rotation prior's minimum). With the default
    rotation-prior weight k4 = 1e7 the pose block of H carries 1e7-sized
    entries beside O(1) ones, so f32 rounding alone moves a step by ~5e-4
    per iteration: both packages land that far from a float64 run of the
    port, in different directions. That case compares one iteration at
    1e-3; k4 = 0 (as in tests/test_shape.py) compares three at 1e-4."""
    jfn, jparams, dec = small
    B, P, R, S, K = 3, 64, 64, 16, 128
    pts, pts_mask = make_surface_points(n=P, seed=9)
    rays, ray_mask, depth, fg_mask = make_rays(n_fg=40, n_bg=24, seed=10)
    T = perturbed_poses(B, seed=11) @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    code0 = np.zeros((B, CODE_LEN), np.float32)
    cfg_kw = dict(code_len=CODE_LEN, num_depth_samples=S, max_grad_points=K,
                  num_iterations=iters, k4=k4)
    stack = lambda a: np.stack([np.asarray(a)] * B)
    args = [T, stack(pts), stack(pts_mask), stack(rays), stack(ray_mask), stack(depth),
            stack(fg_mask), code0]
    ref = jgn.batched_reconstruct(jfn, jgn.GNConfig(**cfg_kw))(
        jparams, *[jnp.asarray(a) for a in args]
    )
    out = gn.batched_reconstruct(dec, gn.GNConfig(**cfg_kw))(*[t(a) for a in args])
    assert out["is_good"].all() and np.asarray(ref["is_good"]).all()
    close(out["t_cam_obj"], ref["t_cam_obj"], atol=atol, rtol=0)
    close(out["code"], ref["code"], atol=atol, rtol=0)
    close(out["loss"], ref["loss"], atol=1e-6, rtol=1e-3)


def test_pose_only_matches_jax(small):
    jfn, jparams, dec = small
    B = 2
    pts, pts_mask = make_surface_points(seed=12)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, 3] = CENTER + np.array([[0.2, -0.1, 0.15], [-0.1, 0.1, 0.0]], np.float32)
    scale = np.full((B,), SCALE, np.float32)
    code = np.zeros((B, CODE_LEN), np.float32)
    cfg = dict(code_len=CODE_LEN)
    stack = lambda a: np.stack([np.asarray(a)] * B)
    ref = jgn.batched_estimate_pose(jfn, jgn.GNConfig(**cfg))(
        jparams, jnp.asarray(T), jnp.asarray(scale), jnp.asarray(stack(pts)),
        jnp.asarray(stack(pts_mask)), jnp.asarray(code),
    )
    out = gn.batched_estimate_pose(dec, gn.GNConfig(**cfg))(
        t(T), t(scale), t(stack(pts)), t(stack(pts_mask)), t(code)
    )
    close(out["t_cam_obj"], ref["t_cam_obj"], atol=1e-4, rtol=0)
    close(out["loss"], ref["loss"], atol=1e-6, rtol=1e-3)


# ---------------------------------------------------------------------------
# tests/test_shape.py's sphere-decoder GN tests, run on the port


def sphere():
    return deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=CODE_LEN, r0=0.5))


class TestJointGNSphere:
    def problem(self, seed=3):
        pts, pts_mask = make_surface_points(seed=seed)
        rays, ray_mask, depth, fg_mask = make_rays(seed=seed + 1)
        return [t(a)[None] for a in (pts, pts_mask, rays, ray_mask, depth, fg_mask)]

    def config(self, **kw):
        base = dict(code_len=CODE_LEN, k1=1.0, k2=100.0, k3=0.25, k4=0.0,
                    num_iterations=10, max_grad_points=256, scale_damping=1.0)
        base.update(kw)
        return gn.GNConfig(**base)

    def test_recovers_pose_and_code(self):
        dx = torch.tensor([[0.15, -0.1, 0.15, 0.05, -0.05, 0.03, 0.1]])
        t_init = lie.exp_sim3(dx) @ t(true_pose())
        out = gn.reconstruct_object(sphere(), self.config(), t_init, *self.problem())
        assert bool(out["is_good"][0])
        s, _, trans = lie.split_sim3(out["t_cam_obj"][0])
        np.testing.assert_allclose(trans.numpy(), CENTER, atol=0.08)
        world_r = float(s) * (0.5 + 0.3 * float(out["code"][0, 0]))
        np.testing.assert_allclose(world_r, SCALE * R_TRUE, rtol=0.05)

    def test_flags_bad_on_empty_rays(self):
        t_bad = torch.eye(4)[None].clone()
        t_bad[0, :3, 3] = torch.tensor([200.0, 0.0, 4.0])
        out = gn.reconstruct_object(sphere(), self.config(), t_bad, *self.problem())
        assert not bool(out["is_good"][0])

    def test_batched_matches_single(self):
        cfg = self.config(num_iterations=3)
        dx = torch.tensor([[0.1, 0.0, -0.1, 0.02, 0.0, 0.0, 0.05]])
        t_init = lie.exp_sim3(dx) @ t(true_pose())
        prob = self.problem()
        single = gn.reconstruct_object(sphere(), cfg, t_init, *prob)
        B = 3
        batch = gn.batched_reconstruct(sphere(), cfg)(
            t_init.expand(B, 4, 4), *[a.expand(B, *a.shape[1:]) for a in prob],
            torch.zeros((B, CODE_LEN)),
        )
        np.testing.assert_allclose(
            batch["t_cam_obj"][1].numpy(), single["t_cam_obj"][0].numpy(), atol=1e-4
        )


def test_pose_only_recovers_translation():
    pts, pts_mask = make_surface_points(seed=7)
    T_se3 = torch.eye(4)[None].clone()
    T_se3[0, :3, 3] = torch.from_numpy(CENTER + np.array([0.3, -0.2, 0.25], np.float32))
    code = torch.zeros((1, CODE_LEN))
    code[0, 0] = C0_TRUE
    out = gn.estimate_pose_cam_obj(
        sphere(), gn.GNConfig(code_len=CODE_LEN), T_se3, torch.tensor([SCALE]),
        t(pts)[None], t(pts_mask)[None], code,
    )
    T = out["t_cam_obj"][0].numpy()
    np.testing.assert_allclose(T[:3, 3], CENTER, atol=0.05)
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-4)


# ---------------------------------------------------------------------------
# mesh


def test_decode_sdf_grid_matches_jax(small):
    jfn, jparams, dec = small
    code = np.random.default_rng(13).normal(0, 0.1, CODE_LEN).astype(np.float32)
    ref = jmesh.decode_sdf_grid(jfn, jparams, jnp.asarray(code), 17)
    out = mesh.decode_sdf_grid(dec, t(code), 17, chunk=1000)
    close(out, ref, rtol=0)


def test_extractor_end_to_end():
    code = torch.zeros(CODE_LEN)
    code[0] = C0_TRUE
    out = mesh.MeshExtractor(sphere(), code_len=CODE_LEN, voxels_dim=33).extract_mesh_from_code(code)
    r = np.linalg.norm(out["vertices"], axis=-1)
    np.testing.assert_allclose(r, R_TRUE, atol=0.07)
    assert out["faces"].min() >= 0 and out["faces"].max() < len(out["vertices"])


# ---------------------------------------------------------------------------
# tests/test_render_jacobian_subset.py on the port: at the reference caps
# (512 rays x 50 samples) the in-band gradient set is thin, so the K = 1024
# subset is lossless and GN lands on the full-Jacobian optimum; K below the
# in-band count truncates real rows and the trajectory departs.


class TestRenderJacobianSubset:
    R_REF, S_REF = 512, 50
    BENIGN_DX = torch.tensor([[0.15, -0.1, 0.15, 0.05, -0.05, 0.03, 0.1]])

    def problem(self):
        pts, pts_mask = make_surface_points(n=256)
        rays, ray_mask, depth, fg_mask = make_rays(n_fg=312, n_bg=200)
        return [t(a)[None] for a in (pts, pts_mask, rays, ray_mask, depth, fg_mask)]

    def run(self, K, iters, prob):
        cfg = gn.GNConfig(code_len=CODE_LEN, k1=1.0, k2=100.0, k3=0.25, k4=0.0,
                          num_iterations=iters, max_grad_points=K, scale_damping=1.0,
                          num_depth_samples=self.S_REF)
        t_init = lie.exp_sim3(self.BENIGN_DX) @ t(true_pose())
        out = gn.reconstruct_object(sphere(), cfg, t_init, *prob)
        return out["t_cam_obj"][0].numpy(), out["code"][0].numpy(), float(out["loss"][0])

    def test_inband_gradient_set_fits_under_k1024(self):
        _, _, rays, ray_mask, depth, fg_mask = self.problem()
        for dx in ([0.0] * 7, self.BENIGN_DX[0].tolist(), [0.0] * 6 + [0.3]):
            T = lie.exp_sim3(torch.tensor([dx])) @ t(true_pose())
            code = torch.zeros((1, CODE_LEN))
            aux = losses.render_loss(
                sphere(), rays, ray_mask, depth, fg_mask, lie.inverse_sim3(T), code,
                num_samples=self.S_REF, max_grad_points=self.R_REF * self.S_REF,
            )[3]
            assert 0 < float(aux["n_grad"][0]) < 1024

    def test_subset_matches_full_jacobian_optimum(self):
        prob = self.problem()
        T_sub, c_sub, loss_sub = self.run(1024, 10, prob)
        T_full, c_full, loss_full = self.run(self.R_REF * self.S_REF, 10, prob)
        np.testing.assert_allclose(T_sub, T_full, atol=0.02)
        np.testing.assert_allclose(c_sub, c_full, atol=0.02)
        assert abs(loss_sub - loss_full) <= 0.02 * max(loss_full, 1e-3)

    def test_breaking_threshold_below_inband_count(self):
        prob = self.problem()
        T_full, _, _ = self.run(self.R_REF * self.S_REF, 10, prob)
        T_64, _, _ = self.run(64, 10, prob)
        assert np.abs(T_64 - T_full).max() > 0.05
