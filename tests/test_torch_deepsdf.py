"""Parity of the port's DeepSDF decoder and kernel K1's plain version with
the JAX package (the kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py).

Weights and inputs are drawn with numpy from a seed and given to both
packages (the JAX pytree {'w': [(in, out)], 'b': [...]}, mapped onto the
module by `params_from_jax`). The Pallas kernel runs in interpret mode on
the CPU, as the JAX package's own tests run it.

Tolerances (from tests/test_pallas_kernel.py): sdf within 1e-5; input
gradient 99th-percentile error < 1e-4 with at most max(3, N/1000) rows
above 1e-4, because a point on a ReLU boundary (z == 0 up to rounding)
may take the other, equally valid subgradient in a different summation
order.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu.ops.pallas import decoder_kernel as jdk
from dspslam_tpu_torch.kernels import decoder_fused
from dspslam_tpu_torch.models import deepsdf
from dspslam_tpu_torch.utils import timing
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(code_len=8, hidden=(32,) * 4, latent_in=(2,))


def numpy_params(layer_dims, seed=0, bias_scale=0.05):
    """He-normal (in, out) weights and small biases, as numpy."""
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(np.float32)
          for i, o in layer_dims]
    bs = [(rng.normal(size=(o,)) * bias_scale).astype(np.float32) for _, o in layer_dims]
    return {"w": ws, "b": bs}


def jax_params(params_np):
    return {k: [jnp.asarray(a) for a in v] for k, v in params_np.items()}


def assert_grad_close(grad, grad_ref):
    err = np.abs(np.asarray(grad) - np.asarray(grad_ref)).max(axis=1)
    assert np.quantile(err, 0.99) < 1e-4
    assert (err > 1e-4).sum() <= max(3, len(err) // 1000)


def inputs(n, dim, seed=1):
    return (np.random.default_rng(seed).normal(size=(n, dim)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def canonical():
    params_np = numpy_params(jdeepsdf.DecoderConfig().layer_dims())
    return params_np, deepsdf.params_from_jax(params_np)


def test_layer_dims_and_supports_match_jax():
    for kw in ({}, SMALL, dict(code_len=64, latent_in=()), dict(use_tanh=True)):
        assert deepsdf.DecoderConfig(**kw).layer_dims() == jdeepsdf.DecoderConfig(**kw).layer_dims()
        assert deepsdf.supports(deepsdf.DecoderConfig(**kw)) == jdk.supports(
            jdeepsdf.DecoderConfig(**kw)
        )


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, use_tanh=True), {}],
                         ids=["small", "small_use_tanh", "canonical"])
def test_forward_matches_jax(kw):
    cfg_j, cfg_t = jdeepsdf.DecoderConfig(**kw), deepsdf.DecoderConfig(**kw)
    params_np = numpy_params(cfg_j.layer_dims(), seed=2)
    x = inputs(64, cfg_j.in_dim, seed=3)
    ref = jdeepsdf.apply(jax_params(params_np), jnp.asarray(x), cfg_j)
    out = deepsdf.params_from_jax(params_np, cfg_t)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("n", [300, 7])
def test_k1_plain_matches_pallas_interpret(canonical, n):
    params_np, dec = canonical
    x = inputs(n, 67, seed=n)
    sdf_ref, grad_ref = jdk.fused_sdf_and_input_grad(jax_params(params_np), jnp.asarray(x), True)
    sdf, grad = decoder_fused.sdf_and_input_grad_plain(
        list(dec.weights), list(dec.biases), torch.from_numpy(x)
    )
    np.testing.assert_allclose(sdf.numpy(), np.asarray(sdf_ref), atol=1e-5)
    assert_grad_close(grad.numpy(), grad_ref)


def test_cpu_tensors_take_the_plain_version(canonical):
    _, dec = canonical
    before = timing.totals().get("k1_launches", 0)
    x = torch.from_numpy(inputs(5, 67))
    sdf, grad = dec.sdf_and_input_grad(x)
    sdf_p, grad_p = decoder_fused.sdf_and_input_grad_plain(list(dec.weights), list(dec.biases), x)
    assert torch.equal(sdf, sdf_p) and torch.equal(grad, grad_p)
    assert timing.totals().get("k1_launches", 0) == before


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, use_tanh=True)], ids=["small", "small_use_tanh"])
def test_plain_input_grad_matches_jax_autodiff(kw):
    cfg_j = jdeepsdf.DecoderConfig(**kw)
    params_np = numpy_params(cfg_j.layer_dims(), seed=4)
    x = inputs(200, cfg_j.in_dim, seed=5)
    sdf_ref, grad_ref = jdeepsdf.sdf_and_input_grad(
        jdeepsdf.make_decoder_fn(cfg_j), jax_params(params_np), jnp.asarray(x)
    )
    dec = deepsdf.params_from_jax(params_np, deepsdf.DecoderConfig(**kw))
    sdf, grad = dec.sdf_and_input_grad(torch.from_numpy(x))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(sdf_ref), atol=1e-5)
    assert_grad_close(grad.numpy(), grad_ref)


def test_sphere_decoder_matches_jax():
    x = inputs(50, 67, seed=6)
    x[:, -3:] *= 5.0
    ref_sdf, ref_grad = jdeepsdf.sdf_and_input_grad(
        jdeepsdf.sphere_decoder_fn, jdeepsdf.make_sphere_params(), jnp.asarray(x)
    )
    dec = deepsdf.SphereDecoder(deepsdf.make_sphere_params())
    sdf, grad = dec.sdf_and_input_grad(torch.from_numpy(x))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(ref_sdf), atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-6)
    np.testing.assert_allclose(dec(torch.from_numpy(x)).numpy(), np.asarray(ref_sdf), atol=1e-6)


def test_init_params_uses_the_generator():
    cfg = deepsdf.DecoderConfig(**SMALL)
    a = deepsdf.init_params(cfg, torch.Generator().manual_seed(0))
    b = deepsdf.init_params(cfg, torch.Generator().manual_seed(0))
    c = deepsdf.init_params(cfg, torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a.weights, b.weights))
    assert not torch.equal(a.weights[0], c.weights[0])
    assert not any(p.requires_grad for p in a.parameters())


def write_experiment(path, config, params_np, weight_norm, seed=0):
    """A reference-format DeepSDF experiment dir (specs.json +
    ModelParameters/latest.pth) holding `params_np` ((in, out) layout),
    optionally as weight-norm g / v pairs with a DataParallel prefix."""
    rng = np.random.default_rng(seed)
    state = {}
    for i, (w, b) in enumerate(zip(params_np["w"], params_np["b"])):
        wt = torch.from_numpy(np.ascontiguousarray(w.T))
        if weight_norm:
            g = torch.from_numpy(rng.uniform(0.5, 2.0, (wt.shape[0], 1)).astype(np.float32))
            state[f"module.lin{i}.weight_g"] = g
            state[f"module.lin{i}.weight_v"] = wt
        else:
            state[f"lin{i}.weight"] = wt
        state[f"{'module.' if weight_norm else ''}lin{i}.bias"] = torch.from_numpy(b)
    (path / "ModelParameters").mkdir(parents=True)
    specs = {
        "CodeLength": config.code_len,
        "NetworkArch": "deep_sdf_decoder",
        "NetworkSpecs": {
            "dims": list(config.hidden),
            "latent_in": list(config.latent_in),
            "weight_norm": weight_norm,
            "use_tanh": config.use_tanh,
        },
    }
    (path / "specs.json").write_text(json.dumps(specs))
    torch.save({"epoch": 1, "model_state_dict": state}, path / "ModelParameters" / "latest.pth")


@pytest.mark.parametrize("weight_norm", [True, False])
def test_load_torch_checkpoint_matches_jax_loader(tmp_path, weight_norm):
    cfg = deepsdf.DecoderConfig(**SMALL)
    write_experiment(tmp_path, cfg, numpy_params(cfg.layer_dims(), seed=7), weight_norm)
    cfg_j, params_j = jdeepsdf.load_torch_checkpoint(str(tmp_path))
    cfg_t, dec = deepsdf.load_torch_checkpoint(str(tmp_path))
    assert cfg_t.layer_dims() == cfg_j.layer_dims()
    assert (cfg_t.code_len, cfg_t.latent_in) == (cfg_j.code_len, cfg_j.latent_in)
    for wt, wj in zip(dec.weights, params_j["w"]):
        # weight-norm folding in f32 (torch) vs f64-promoted numpy (JAX side)
        np.testing.assert_allclose(wt.numpy().T, np.asarray(wj), atol=1e-6, rtol=1e-6)
    x = inputs(20, cfg.in_dim, seed=8)
    np.testing.assert_allclose(
        dec(torch.from_numpy(x)).numpy(),
        np.asarray(jdeepsdf.apply(params_j, jnp.asarray(x), cfg_j)), atol=1e-5,
    )
