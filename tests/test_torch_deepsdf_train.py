"""The port's DeepSDF trainer (dspslam_tpu_torch/models/deepsdf_train.py and
apps/train_deepsdf.py) against dspslam_tpu/models/deepsdf_train.py on the
CPU, at a narrow decoder (code 8, 4 x 32, latent_in 2). Both packages start
from one JAX TrainState's params and codes (`state_from_jax`) and take the
same numpy-seeded batches.

Tolerances: the loss within 1e-6 relative, every gradient within 1e-5 of
its largest entry, parameters after 1 and 3 Adam steps within 1e-6
(lr 5e-4: an update is about lr * sign(g), so the two Adams' roundings
move a parameter by far less); a checkpoint round trip and the exported
experiment dir through both packages' `load_torch_checkpoint` within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu.models import deepsdf_train as jdt
from dspslam_tpu_torch.apps import train_deepsdf
from dspslam_tpu_torch.models import deepsdf, deepsdf_train as tdt
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(code_len=8, hidden=(32,) * 4, latent_in=(2,))
JCFG = jdeepsdf.DecoderConfig(**SMALL)
TCFG = deepsdf.DecoderConfig(**SMALL)
N_SHAPES = 3


def batch_np(seed, n=256):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    idx = rng.integers(0, N_SHAPES, n).astype(np.int32)
    sdf = (np.linalg.norm(xyz, axis=-1) - (0.3 + 0.1 * idx)).astype(np.float32)
    return {"shape_idx": idx, "xyz": xyz, "sdf": sdf}


def t_batch(b):
    return {"shape_idx": torch.from_numpy(b["shape_idx"].astype(np.int64)), "xyz": torch.from_numpy(b["xyz"]),
            "sdf": torch.from_numpy(b["sdf"])}


@pytest.fixture
def states():
    """A JAX TrainState and the port's state from its params and codes."""
    opt = jdt.make_optimizer()
    js = jdt.init_state(JCFG, N_SHAPES, jax.random.PRNGKey(3), opt)
    params_np = jax.tree_util.tree_map(np.asarray, js.params)
    ts = tdt.state_from_jax(params_np, np.asarray(js.codes), TCFG, device="cpu")
    return js, opt, ts


def _close_rel(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-30), np.abs(a - b).max()


def _assert_params(js, ts, atol):
    for jw, jb, tw, tb in zip(js.params["w"], js.params["b"], ts.decoder.weights, ts.decoder.biases):
        np.testing.assert_allclose(tw.detach().numpy().T, np.asarray(jw), rtol=0, atol=atol)
        np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb), rtol=0, atol=atol)
    np.testing.assert_allclose(ts.codes.detach().numpy(), np.asarray(js.codes), rtol=0, atol=atol)


@pytest.mark.parametrize("clamp", [0.1, 0.5])
def test_sdf_loss_and_gradients_match_jax(states, clamp):
    js, _, ts = states
    b = batch_np(0)

    def jloss(pc):
        return jdt.sdf_loss(pc[0], pc[1], jnp.asarray(b["shape_idx"]), jnp.asarray(b["xyz"]),
                            jnp.asarray(b["sdf"]), JCFG, clamp=clamp)

    jl, (jg_params, jg_codes) = jax.value_and_grad(jloss)((js.params, js.codes))
    tb = t_batch(b)
    tl = tdt.sdf_loss(ts.decoder, ts.codes, tb["shape_idx"], tb["xyz"], tb["sdf"], clamp=clamp)
    tl.backward()
    _close_rel(jl, tl.item(), 1e-6)
    for jw, jbias, tw, tbias in zip(jg_params["w"], jg_params["b"], ts.decoder.weights, ts.decoder.biases):
        _close_rel(jw, tw.grad.numpy().T, 1e-5)
        _close_rel(jbias, tbias.grad.numpy(), 1e-5)
    _close_rel(jg_codes, ts.codes.grad.numpy(), 1e-5)


def test_train_steps_match_jax(states):
    """Loss per step, then the parameters after 1 and after 3 Adam steps."""
    js, opt, ts = states
    for step in range(3):
        b = batch_np(10 + step)
        js, jl = jdt.train_step(js, {k: jnp.asarray(v) for k, v in b.items()}, JCFG, opt)
        tl = tdt.train_step(ts, t_batch(b))
        _close_rel(jl, tl.item(), 1e-6)
        if step in (0, 2):
            _assert_params(js, ts, 1e-6)
    assert ts.step == int(js.step) == 3


def test_checkpoint_round_trip(states, tmp_path):
    _, _, ts = states
    tdt.train_step(ts, t_batch(batch_np(1)))
    path = str(tmp_path / "ckpt.pt")
    tdt.save_checkpoint(ts, path)
    back = tdt.load_checkpoint(path, device="cpu")
    assert back.step == 1 and back.decoder.config == TCFG
    for a, b in zip(list(ts.decoder.parameters()) + [ts.codes], list(back.decoder.parameters()) + [back.codes]):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=1e-6)
    assert all(p.requires_grad for p in back.decoder.parameters())
    assert not back.optimizer.state, "loading gives a fresh optimizer"


def test_export_loads_in_both_packages(states, tmp_path):
    _, _, ts = states
    tdt.train_step(ts, t_batch(batch_np(2)))
    tdt.export_reference_format(ts, str(tmp_path))
    jcfg, jparams = jdeepsdf.load_torch_checkpoint(str(tmp_path))
    tcfg, tdec = deepsdf.load_torch_checkpoint(str(tmp_path))
    assert (tcfg.code_len, tcfg.hidden, tcfg.latent_in) == (jcfg.code_len, jcfg.hidden, jcfg.latent_in) == (
        8, (32,) * 4, (2,))
    x = np.random.default_rng(5).normal(size=(64, 11)).astype(np.float32) * 0.4
    ref = ts.decoder(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(tdec(torch.from_numpy(x)).numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jdeepsdf.apply(jparams, jnp.asarray(x), jcfg)), ref, rtol=0, atol=1e-6)


def test_sphere_dataset_sdf_identity():
    gen = torch.Generator().manual_seed(4)
    d = tdt.make_sphere_dataset(gen, num_shapes=4, n=2000)
    xyz, sdf, idx = d["xyz"].numpy(), d["sdf"].numpy(), d["shape_idx"].numpy()
    np.testing.assert_allclose(sdf, np.linalg.norm(xyz, axis=-1) - (0.3 + 0.1 * idx), rtol=0, atol=1e-6)
    assert set(np.unique(idx)) == {0, 1, 2, 3}
    # odd rows uniform in the cube, even rows near a surface
    assert np.abs(xyz[1::2]).max() <= 1.0 and np.abs(sdf[0::2]).mean() < 0.1 < np.abs(sdf[1::2]).mean()


def test_fit_spheres_learns_the_radii():
    """A short fit: the loss falls and each shape's code decodes a surface
    near its radius along +x."""
    dec, codes, loss = tdt.fit_spheres(TCFG, num_shapes=3, steps=150, batch=1024, device="cpu")
    assert loss < 0.05 and not any(p.requires_grad for p in dec.parameters())
    r = torch.linspace(0.05, 0.95, 181)
    for k in range(3):
        x = torch.cat([codes[k].expand(len(r), 8), r[:, None], torch.zeros(len(r), 2)], dim=-1)
        sdf = dec(x)
        crossing = r[int(torch.nonzero(sdf > 0)[0])]
        assert abs(float(crossing) - (0.3 + 0.1 * k)) < 0.1


def test_train_deepsdf_cli(tmp_path):
    out = str(tmp_path / "exp")
    state = train_deepsdf.main(["--synthetic", "--out", out, "--steps", "3", "--batch", "64", "--code_len", "8",
                                "--hidden", "16", "--layers", "4", "--device", "cpu"])
    assert state.step == 3
    cfg, dec = deepsdf.load_torch_checkpoint(out)
    assert cfg.hidden == (16,) * 4 and np.load(f"{out}/latent_codes.npy").shape == (8, 8)
    assert tdt.load_checkpoint(f"{out}/checkpoint.pt", device="cpu").step == 3


def test_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        train_deepsdf.main(["--synthetic", "--out", str(tmp_path), "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        tdt.init_state(TCFG, 2)
