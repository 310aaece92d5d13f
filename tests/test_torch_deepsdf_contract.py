"""The DeepSDF decoder's configuration contract, port against the JAX
package: `compute_dtype` (bf16 with f32 accumulation), `matmul_precision`,
the generic input-gradient path for every decoder that kernel K1 does not
compute, the dispatch between the two, the TF32 switch's scope, and the
configs that checkpoints carry.

Weights and inputs are drawn with numpy from a seed and given to both
packages. Tolerances:
- float32: sdf within 1e-5 and input gradients as tests/test_torch_deepsdf.py
  holds them (99th percentile < 1e-4, at most max(3, N/1000) rows above);
- bfloat16: two f32 summation orders round a few activations to the other
  bf16 neighbour (2^-8 relative), and the difference carries through the
  layers. So the port's bf16 result must lie within 1e-2 of JAX's bf16 sdf
  and, in RMS and in the gradient's Frobenius norm, within a quarter of the
  distance between JAX's bf16 and f32 results: it computes bf16's
  arithmetic, not f32's (measured on 256 rows of the canonical decoder:
  sdf 1.5e-3-3.1e-3, gradient 0.3-1.4%, against 15% from f32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu_torch.apps import train_deepsdf
from dspslam_tpu_torch.kernels import decoder_fused
from dspslam_tpu_torch.models import deepsdf, deepsdf_train
from dspslam_tpu_torch.utils import timing

WIDE = dict(code_len=8, hidden=(64,) * 4, latent_in=(2,), use_tanh=True)
BF16_SDF_TOL = 1e-2
BF16_SHARE_OF_F32_GAP = 0.25


@pytest.fixture(autouse=True)
def tf32_off():
    """The process-wide state geometry expects: TF32 off, restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def numpy_params(layer_dims, seed):
    rng = np.random.default_rng(seed)
    return {"w": [(rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(np.float32) for i, o in layer_dims],
            "b": [(rng.normal(size=(o,)) * 0.05).astype(np.float32) for _, o in layer_dims]}


def jax_params(params_np):
    return {k: [jnp.asarray(a) for a in v] for k, v in params_np.items()}


def inputs(n, dim, seed):
    return (np.random.default_rng(seed).normal(size=(n, dim)) * 0.3).astype(np.float32)


def configs(kw, dtype):
    """The same decoder in both packages at compute dtype 'f32' or 'bf16'."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    return jdeepsdf.DecoderConfig(**kw, compute_dtype=jdt), deepsdf.DecoderConfig(**kw, compute_dtype=tdt)


def assert_grad_close(grad, grad_ref):
    err = np.abs(grad - grad_ref).max(axis=1)
    assert np.quantile(err, 0.99) < 1e-4
    assert (err > 1e-4).sum() <= max(3, len(err) // 1000)


def rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def test_config_defaults():
    """JAX's compute dtype; the port's precision default is "highest" where
    JAX's is "default" (ROADMAP R10: TF32 moves the card's GN)."""
    j, t = jdeepsdf.DecoderConfig(), deepsdf.DecoderConfig()
    assert t.compute_dtype == torch.float32 and j.compute_dtype == jnp.float32
    assert (t.matmul_precision, j.matmul_precision) == ("highest", "default")


@pytest.mark.parametrize("kw", [dict(code_len=8, hidden=(32,) * 4, latent_in=(2,)), {}], ids=["small", "canonical"])
def test_bf16_forward_matches_jax_apply(kw):
    (cj, ct), (cj32, _) = configs(kw, "bf16"), configs(kw, "f32")
    params_np = numpy_params(cj.layer_dims(), seed=2)
    x = inputs(256, cj.in_dim, seed=3)
    ref = np.asarray(jdeepsdf.apply(jax_params(params_np), jnp.asarray(x), cj))
    ref32 = np.asarray(jdeepsdf.apply(jax_params(params_np), jnp.asarray(x), cj32))
    out = deepsdf.params_from_jax(params_np, ct)(torch.from_numpy(x))
    assert out.dtype == torch.float32
    out = out.numpy()
    assert np.abs(out - ref).max() <= BF16_SDF_TOL
    assert rms(out - ref) <= BF16_SHARE_OF_F32_GAP * rms(ref - ref32)


def test_generic_path_matches_jax_for_a_non_canonical_layout():
    cj, ct = configs(WIDE, "f32")
    params_np = numpy_params(cj.layer_dims(), seed=4)
    x = inputs(300, cj.in_dim, seed=5)
    sdf_ref, grad_ref = jdeepsdf.sdf_and_input_grad(jdeepsdf.make_decoder_fn(cj), jax_params(params_np),
                                                    jnp.asarray(x))
    sdf, grad = deepsdf.sdf_and_input_grad_generic(deepsdf.params_from_jax(params_np, ct), torch.from_numpy(x))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(sdf_ref), atol=1e-5)
    assert_grad_close(grad.numpy(), np.asarray(grad_ref))


def test_generic_path_matches_jax_for_the_bf16_canonical_decoder():
    (cj, ct), (cj32, _) = configs({}, "bf16"), configs({}, "f32")
    params_np = numpy_params(cj.layer_dims(), seed=6)
    x = inputs(256, cj.in_dim, seed=7)
    jp = jax_params(params_np)
    sdf_ref, grad_ref = map(np.asarray, jdeepsdf.sdf_and_input_grad(jdeepsdf.make_decoder_fn(cj), jp, jnp.asarray(x)))
    sdf32, grad32 = map(np.asarray, jdeepsdf.sdf_and_input_grad(jdeepsdf.make_decoder_fn(cj32), jp, jnp.asarray(x)))
    dec = deepsdf.params_from_jax(params_np, ct)
    sdf, grad = (t.numpy() for t in dec.sdf_and_input_grad(torch.from_numpy(x)))
    assert np.abs(sdf - sdf_ref).max() <= BF16_SDF_TOL
    assert rms(sdf - sdf_ref) <= BF16_SHARE_OF_F32_GAP * rms(sdf_ref - sdf32)
    gap = np.linalg.norm(grad_ref - grad32)
    assert np.linalg.norm(grad - grad_ref) <= BF16_SHARE_OF_F32_GAP * gap


def test_supports_rejects_bf16_and_other_layouts():
    assert deepsdf.supports(deepsdf.DecoderConfig())
    assert deepsdf.supports(deepsdf.DecoderConfig(matmul_precision="default"))
    assert not deepsdf.supports(deepsdf.DecoderConfig(compute_dtype=torch.bfloat16))
    assert not deepsdf.supports(deepsdf.DecoderConfig(**WIDE))


@pytest.mark.parametrize("kw,route", [({}, "k1"), (dict(compute_dtype=torch.bfloat16), "generic"),
                                      (WIDE, "generic")], ids=["canonical_f32", "canonical_bf16", "wide"])
def test_dispatch_by_config(monkeypatch, kw, route):
    """A decoder K1 computes goes to K1's wrapper (on a CPU tensor its plain
    version, with no launch); every other one to the generic path."""
    calls = []
    k1, generic = decoder_fused.sdf_and_input_grad, deepsdf.sdf_and_input_grad_generic
    monkeypatch.setattr(decoder_fused, "sdf_and_input_grad",
                        lambda *a, **k: calls.append("k1") or k1(*a, **k))
    monkeypatch.setattr(deepsdf, "sdf_and_input_grad_generic",
                        lambda *a, **k: calls.append("generic") or generic(*a, **k))
    cfg = deepsdf.DecoderConfig(**kw)
    dec = deepsdf.params_from_jax(numpy_params(cfg.layer_dims(), seed=8), cfg)
    x = torch.from_numpy(inputs(5, cfg.in_dim, seed=9))
    launches = timing.totals().get("k1_launches", 0)
    sdf, grad = dec.sdf_and_input_grad(x)
    assert calls == [route] and timing.totals().get("k1_launches", 0) == launches
    if route == "k1":
        sdf_p, grad_p = decoder_fused.sdf_and_input_grad_plain(list(dec.weights), list(dec.biases), x)
        assert torch.equal(sdf, sdf_p) and torch.equal(grad, grad_p)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_precisions_are_float32_on_the_cpu(dtype):
    x = torch.from_numpy(inputs(64, 67, seed=10))
    params_np = numpy_params(deepsdf.DecoderConfig().layer_dims(), seed=11)
    out = {}
    for precision in ("highest", "default", "high"):
        kw = dict(matmul_precision=precision, compute_dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
        dec = deepsdf.params_from_jax(params_np, deepsdf.DecoderConfig(**kw))
        out[precision] = (dec(x), *dec.sdf_and_input_grad(x))
    for precision in ("default", "high"):
        assert all(torch.equal(a, b) for a, b in zip(out[precision], out["highest"]))


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="'fastest'"):
        deepsdf.DecoderConfig(matmul_precision="fastest")
    with pytest.raises(ValueError, match="'float32'"):
        with deepsdf.matmul_precision_scope("float32"):
            pass
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("start", [False, True])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_tf32_switch_is_scoped_to_the_decoders_products(monkeypatch, start, precision):
    """Inside every product of a decoder call (forward, the generic path's
    backward, a train step's backward) the switch says the config's
    precision; after the call, and after an exception raised inside one, it
    is back where it was."""
    torch.backends.cuda.matmul.allow_tf32 = start
    seen = []
    product = deepsdf.linear

    def recording(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return product(*a, **k)

    class Backward(torch.autograd.Function):
        """Identity whose backward reads the switch."""
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return g

    monkeypatch.setattr(deepsdf, "linear", lambda x, *a: recording(Backward.apply(x), *a))
    cfg = deepsdf.DecoderConfig(**WIDE, matmul_precision=precision)
    dec = deepsdf.params_from_jax(numpy_params(cfg.layer_dims(), seed=12), cfg)
    x = torch.from_numpy(inputs(16, cfg.in_dim, seed=13))
    want = deepsdf.TF32_BY_PRECISION[precision]

    dec(x)
    dec.sdf_and_input_grad(x)
    state = deepsdf_train.state_from(dec, np.zeros((2, 8), np.float32))
    batch = {"shape_idx": torch.tensor([0, 1] * 8), "xyz": x[:, -3:], "sdf": torch.zeros(16)}
    deepsdf_train.train_step(state, batch)
    # 5 layers: the forward's products, then the generic path's and the
    # train step's forward and backward ones
    assert len(seen) == 5 * 5 and set(seen) == {want}
    assert torch.backends.cuda.matmul.allow_tf32 is start

    def failing(*a, **k):
        raise RuntimeError("inside a product")

    monkeypatch.setattr(deepsdf, "linear", failing)
    for call in (dec, dec.sdf_and_input_grad, lambda _: deepsdf_train.train_step(state, batch)):
        with pytest.raises(RuntimeError, match="inside a product"):
            call(x)
        assert torch.backends.cuda.matmul.allow_tf32 is start


def test_load_torch_checkpoint_takes_compute_dtype(tmp_path):
    cfg = deepsdf.DecoderConfig(**WIDE)
    params_np = numpy_params(cfg.layer_dims(), seed=14)
    state = deepsdf_train.state_from(deepsdf.params_from_jax(params_np, cfg), np.zeros((1, 8), np.float32))
    deepsdf_train.export_reference_format(state, str(tmp_path))
    cfg_j, params_j = jdeepsdf.load_torch_checkpoint(str(tmp_path), compute_dtype=jnp.bfloat16)
    cfg_t, dec = deepsdf.load_torch_checkpoint(str(tmp_path), compute_dtype=torch.bfloat16)
    assert cfg_t == deepsdf.DecoderConfig(**WIDE, compute_dtype=torch.bfloat16)
    assert cfg_j.compute_dtype == jnp.bfloat16
    x = inputs(128, cfg.in_dim, seed=15)
    ref = np.asarray(jdeepsdf.apply(params_j, jnp.asarray(x), cfg_j))
    assert np.abs(dec(torch.from_numpy(x)).numpy() - ref).max() <= BF16_SDF_TOL


def test_train_deepsdf_checkpoint_reloads_its_config(tmp_path):
    """A 4 x 64 decoder trained by the app reloads with its layout, and its
    export reloads at bf16 onto the generic path."""
    out = tmp_path / "exp"
    train_deepsdf.main(["--synthetic", "--out", str(out), "--steps", "2", "--batch", "64", "--code_len", "8",
                        "--hidden", "64", "--layers", "4", "--device", "cpu"])
    back = deepsdf_train.load_checkpoint(str(out / "checkpoint.pt"), device="cpu")
    assert back.decoder.config == deepsdf.DecoderConfig(code_len=8, hidden=(64,) * 4, latent_in=(2,))
    cfg, dec = deepsdf.load_torch_checkpoint(str(out), compute_dtype=torch.bfloat16)
    assert cfg == dataclasses.replace(back.decoder.config, compute_dtype=torch.bfloat16)
    assert not deepsdf.supports(cfg)
    x = torch.from_numpy(inputs(32, cfg.in_dim, seed=16))
    sdf, grad = dec.sdf_and_input_grad(x)
    assert sdf.shape == (32,) and grad.shape == (32, cfg.in_dim)
    assert bool(torch.isfinite(grad).all())
    with torch.no_grad():
        assert np.abs(sdf.numpy() - back.decoder(x).numpy()).max() <= BF16_SDF_TOL
