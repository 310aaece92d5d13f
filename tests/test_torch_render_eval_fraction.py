"""`GNConfig.render_eval_fraction`, port against the JAX package: the render
term decodes only int(R * S * fraction) grid samples per object, the valid
ones first in `lax.top_k`'s order (lowest index first among ties), and every
other sample reads sdf 1e3.

Small sizes (2 objects, 64 rays x 16 samples, the sphere-like 4 x 32 decoder
of tests/test_torch_shape.py). At a fraction that truncates nothing the
port's result equals its uncapped result exactly; at one that truncates,
both packages decode the same grid points (1e-6: the same f32 transform)
and give the same residuals and Jacobians, with test_torch_shape.py's
tolerances (1e-5 absolute plus 1e-4 relative; one GN iteration at k4 = 1e7
within 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu.ops import lie as jlie
from dspslam_tpu.shape import gn as jgn
from dspslam_tpu.shape import losses as jlosses
from dspslam_tpu_torch.models import deepsdf
from dspslam_tpu_torch.ops import lie
from dspslam_tpu_torch.shape import gn, losses

from test_shape import CODE_LEN, make_rays, make_surface_points
from test_torch_shape import SMALL, close, perturbed_poses, sphere_like_params, t
from torch_threads import one_torch_thread  # noqa: F401

B, R, S, K = 2, 64, 16, 128


class Recording(torch.nn.Module):
    """A decoder that keeps the inputs of its forward calls (the render
    grid's decode)."""

    def __init__(self, decoder):
        super().__init__()
        self.decoder = decoder
        self.inputs = []

    def forward(self, x):
        self.inputs.append(x)
        return self.decoder(x)

    def sdf_and_input_grad(self, x):
        return self.decoder.sdf_and_input_grad(x)


@pytest.fixture(scope="module")
def problem():
    params_np = sphere_like_params()
    jparams = {k: [jnp.asarray(a) for a in v] for k, v in params_np.items()}
    rays, ray_mask, depth, fg_mask = make_rays(n_fg=40, n_bg=24, seed=3)
    T = perturbed_poses(B, seed=4)
    code = np.random.default_rng(5).normal(0, 0.1, (B, CODE_LEN)).astype(np.float32)
    n_valid = [int(jlosses.render_loss(
        jdeepsdf.make_decoder_fn(jdeepsdf.DecoderConfig(**SMALL)), jparams, rays, ray_mask, depth, fg_mask,
        jlie.inverse_sim3(jnp.asarray(T[b])), jnp.asarray(code[b]), num_samples=S, max_grad_points=K,
    )[3]["n_valid_query"]) for b in range(B)]
    assert 0 < min(n_valid) and max(n_valid) + 5 < R * S     # a cap below R * S truncates nothing
    return {"params_np": params_np, "jparams": jparams, "rays": (rays, ray_mask, depth, fg_mask), "T": T,
            "code": code, "n_valid": n_valid}


def caps(problem):
    """{'none': a cap above every object's valid count, 'some': one below the
    smallest}, each as (max_eval_points, the fraction giving it)."""
    out = {}
    for name, k in (("none", max(problem["n_valid"]) + 5), ("some", min(problem["n_valid"]) // 2)):
        out[name] = (k, k / (R * S))            # k / 1024 is exact, so int(R * S * f) == k
        assert int(R * S * out[name][1]) == k
    return out


def port_render(problem, max_eval_points):
    dec = Recording(deepsdf.params_from_jax(problem["params_np"], deepsdf.DecoderConfig(**SMALL)))
    stack = lambda a: t(np.stack([np.asarray(a)] * B))
    out = losses.render_loss(
        dec, *[stack(a) for a in problem["rays"]], lie.inverse_sim3(t(problem["T"])), t(problem["code"]),
        num_samples=S, max_grad_points=K, max_eval_points=max_eval_points,
    )
    return out, dec.inputs


def jax_render(problem, b, max_eval_points):
    inputs = []
    jfn = jdeepsdf.make_decoder_fn(jdeepsdf.DecoderConfig(**SMALL))

    def recording(params, x):
        if not isinstance(x, jax.core.Tracer):        # the grid's decode, not the vmapped gradient
            inputs.append(np.asarray(x))
        return jfn(params, x)

    out = jlosses.render_loss(
        recording, problem["jparams"], *problem["rays"], jlie.inverse_sim3(jnp.asarray(problem["T"][b])),
        jnp.asarray(problem["code"][b]), num_samples=S, max_grad_points=K, max_eval_points=max_eval_points,
    )
    return out, inputs


def test_a_cap_that_truncates_nothing_gives_the_uncapped_result_exactly(problem):
    k, _ = caps(problem)["none"]
    (J, r, m, aux), decoded = port_render(problem, k)
    (J0, r0, m0, aux0), decoded0 = port_render(problem, None)
    assert [x.shape[0] for x in decoded] == [B * k] and [x.shape[0] for x in decoded0] == [B * R * S]
    for a, b in ((J, J0), (r, r0), (m, m0), *((aux[n], aux0[n]) for n in aux)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cap", ["none", "some"])
def test_render_loss_decodes_and_returns_what_jax_does(problem, cap):
    k, _ = caps(problem)[cap]
    (J, r, m, aux), decoded = port_render(problem, k)
    assert len(decoded) == 1 and decoded[0].shape == (B * k, CODE_LEN + 3)
    rows = decoded[0].reshape(B, k, CODE_LEN + 3)
    for b in range(B):
        (Jj, rj, mj, auxj), decoded_j = jax_render(problem, b, k)
        assert len(decoded_j) == 1 and decoded_j[0].shape == (k, CODE_LEN + 3)
        close(rows[b], decoded_j[0], atol=1e-6, rtol=0)
        assert int(aux["n_valid_query"][b]) == int(auxj["n_valid_query"])
        assert float(aux["n_grad"][b]) == float(auxj["n_grad"]) > 0
        close(m[b], mj, atol=0, rtol=0)
        close(J[b], Jj)
        close(r[b], rj)
        close(aux["d_u"][b], auxj["d_u"])
    if cap == "some":
        # truncation drops valid samples, so fewer rows carry a gradient
        (_, _, m0, _), _ = port_render(problem, None)
        assert float(m.sum()) < float(m0.sum())


def gn_args(problem):
    pts, pts_mask = make_surface_points(n=64, seed=9)
    stack = lambda a: np.stack([np.asarray(a)] * B)
    T = problem["T"] @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    return [T, stack(pts), stack(pts_mask), *[stack(a) for a in problem["rays"]],
            np.zeros((B, CODE_LEN), np.float32)]


def test_one_gn_iteration_matches_jax(problem):
    """The port's GN passes int(R * S * fraction) as the cap (as JAX's
    does): one iteration equals JAX's at each fraction, and a fraction that
    truncates nothing equals no fraction exactly."""
    args = gn_args(problem)
    dec = deepsdf.params_from_jax(problem["params_np"], deepsdf.DecoderConfig(**SMALL))
    jfn = jdeepsdf.make_decoder_fn(jdeepsdf.DecoderConfig(**SMALL))
    base = gn.GNConfig(code_len=CODE_LEN, num_depth_samples=S, max_grad_points=K, num_iterations=1)
    uncapped = gn.batched_reconstruct(dec, base)(*[t(a) for a in args])
    for cap, (_, fraction) in caps(problem).items():
        cfg = dataclasses.replace(base, render_eval_fraction=fraction)
        out = gn.batched_reconstruct(dec, cfg)(*[t(a) for a in args])
        ref = jgn.batched_reconstruct(jfn, jgn.GNConfig(**dataclasses.asdict(cfg)))(
            problem["jparams"], *[jnp.asarray(a) for a in args]
        )
        close(out["t_cam_obj"], ref["t_cam_obj"], atol=1e-3, rtol=0)
        close(out["code"], ref["code"], atol=1e-3, rtol=0)
        close(out["loss"], ref["loss"], atol=1e-6, rtol=1e-3)
        assert out["is_good"].tolist() == np.asarray(ref["is_good"]).tolist()
        if cap == "none":
            assert all(torch.equal(out[key], uncapped[key]) for key in out)
