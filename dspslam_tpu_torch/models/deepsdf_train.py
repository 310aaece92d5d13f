"""DeepSDF prior training: auto-decoder SDF regression.

Port of dspslam_tpu/models/deepsdf_train.py. The reference consumes
pretrained DeepSDF priors (cars_64 / chairs_64, workspace.py:202-223) but
ships no trainer. This is the standard auto-decoder objective: clamped-L1
SDF regression over a trainable decoder and a table of per-shape latent
codes with an L2 prior, one Adam step over both.

The JAX `TrainState(params, codes, opt_state, step)` becomes a `TrainState`
holding a trainable `DeepSDFDecoder`, an `nn.Parameter` code table and a
`torch.optim.Adam` (optax's defaults: betas 0.9 / 0.999, eps 1e-8 added
outside the square root). The decoder's products, forward and backward,
run at its config's compute dtype and matmul precision, as JAX's trainer
runs `apply`; everything else is float32. Nothing here reaches kernel K1,
whose wrapper computes values and input gradients for the GN, not weight
gradients. `fit_spheres`' `lax.scan` chunks (a relay workaround) are not
ported: the loop is eager.

Training on the JAX package's `(dp, tp)` mesh (parallel/mesh_utils.py):
`shard_state` puts a state on a `make_mesh()` mesh, with the decoder
tensor-parallel on `tp` (parallel/tp_decoder.py) and the code table
replicated; `train_step` on it takes this dp rank's rows of the global
batch and averages the gradients and the loss over `dp` with one
all-reduce; `gather_state` puts the full state back together for
`save_checkpoint` and `export_reference_format`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel import mesh_utils, tp_decoder
from ..slam.map import entry_device
from . import deepsdf


@dataclasses.dataclass
class TrainState:
    decoder: deepsdf.DeepSDFDecoder | tp_decoder.TensorParallelDecoder    # weights require grad
    codes: nn.Parameter                  # (num_shapes, code_len) latent table
    optimizer: torch.optim.Optimizer
    step: int = 0
    mesh: object = None                  # the (dp, tp) DeviceMesh of a sharded state


def make_optimizer(params, lr: float = 5e-4) -> torch.optim.Adam:
    """Adam with optax.adam's defaults."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def state_from(decoder: deepsdf.DeepSDFDecoder, codes, lr: float = 5e-4, step: int = 0) -> TrainState:
    """A TrainState over a trainable copy of `decoder` and `codes` (a
    tensor or array), with a fresh optimizer."""
    trainable = deepsdf.DeepSDFDecoder(decoder.config, [w.detach().clone() for w in decoder.weights],
                                       [b.detach().clone() for b in decoder.biases]).requires_grad_(True)
    device = decoder.weights[0].device
    codes = nn.Parameter(torch.as_tensor(codes, dtype=torch.float32).detach().clone().to(device))
    return TrainState(trainable, codes, make_optimizer(list(trainable.parameters()) + [codes], lr), step)


def init_state(config: deepsdf.DecoderConfig, num_shapes: int, seed: int = 0, device=None,
               lr: float = 5e-4) -> TrainState:
    """He-normal decoder weights and 0.01 * N(0, 1) codes, drawn on the CPU
    from one seeded generator (so every device starts from the same
    values). `device` None means cuda."""
    device = entry_device(device, "deepsdf_train")
    gen = torch.Generator().manual_seed(seed)
    decoder = deepsdf.init_params(config, gen)
    codes = 0.01 * torch.randn((num_shapes, config.code_len), generator=gen)
    return state_from(decoder.to(device), codes.to(device), lr)


def state_from_jax(params_np: dict, codes_np, config: deepsdf.DecoderConfig, device=None,
                   lr: float = 5e-4, step: int = 0) -> TrainState:
    """A JAX TrainState's params ({'w': [(in, out)], 'b': [...]}) and codes,
    as numpy arrays, as a port TrainState with a fresh optimizer."""
    device = entry_device(device, "deepsdf_train")
    return state_from(deepsdf.params_from_jax(params_np, config, device),
                      torch.from_numpy(np.array(codes_np, np.float32)), lr, step)


def _move_adam(old: torch.optim.Optimizer, new: torch.optim.Optimizer, convert):
    """Adam's moments from `old`'s parameters onto `new`'s. `convert` maps a
    list of tensors laid out as old's parameters to new's layout."""
    if not old.state:
        return
    old_params, new_params = old.param_groups[0]["params"], new.param_groups[0]["params"]
    for key in ("exp_avg", "exp_avg_sq"):
        for p, t in zip(new_params, convert([old.state[q][key] for q in old_params])):
            new.state[p][key] = t
    for p in new_params:
        new.state[p]["step"] = old.state[old_params[0]]["step"].clone()


def _decoder_layout(tp_dec: tp_decoder.TensorParallelDecoder, fn):
    """A `convert` for `_move_adam`: `fn` (tp_dec.shard or tp_dec.gather)
    over the decoder's weights and biases, the code table unchanged."""
    n = len(tp_dec.weights)

    def convert(ts):
        ws, bs = fn(ts[:n], ts[n:2 * n])
        return [*ws, *bs, ts[2 * n]]

    return convert


def shard_state(state: TrainState, mesh) -> TrainState:
    """`state` on a (dp, tp) mesh: the decoder tensor-parallel on tp, the
    code table replicated, both from the mesh's first rank. Adam's moments
    are elementwise, so they are cut with the weights."""
    mesh_utils.replicate_(list(state.decoder.parameters()) + [state.codes], mesh)
    decoder = mesh_utils.decoder_param_sharding(mesh, state.decoder)
    codes = nn.Parameter(state.codes.detach().clone())
    optimizer = make_optimizer(list(decoder.parameters()) + [codes], state.optimizer.param_groups[0]["lr"])
    _move_adam(state.optimizer, optimizer, _decoder_layout(decoder, decoder.shard))
    return TrainState(decoder, codes, optimizer, state.step, mesh)


def gather_state(state: TrainState) -> TrainState:
    """The unsharded state of a sharded one, on every rank (a collective:
    every rank calls it; rank 0 writes what it returns)."""
    decoder = tp_decoder.gather_decoder(state.decoder)
    out = state_from(decoder, state.codes, state.optimizer.param_groups[0]["lr"], state.step)
    _move_adam(state.optimizer, out.optimizer, _decoder_layout(state.decoder, state.decoder.gather))
    return out


def _average_over_dp(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """Gradients and the loss averaged over the mesh's dp ranks in one
    all-reduce; returns the global loss."""
    params = list(state.decoder.parameters()) + [state.codes]
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.detach().reshape(1)])
    dist.all_reduce(flat, group=state.mesh.get_group("dp"))
    flat /= state.mesh.size(0)
    for p, g in zip(params, flat[:-1].split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))
    return flat[-1]


def frozen_decoder(decoder: deepsdf.DeepSDFDecoder) -> deepsdf.DeepSDFDecoder:
    """A copy with weights that do not require grad: what the GN stack
    (and kernel K1 on the card) takes."""
    return deepsdf.DeepSDFDecoder(decoder.config, [w.detach().clone() for w in decoder.weights],
                                  [b.detach().clone() for b in decoder.biases])


def sdf_loss(decoder, codes, shape_idx, xyz, sdf_target, clamp: float = 0.1,
             code_reg: float = 1e-4) -> torch.Tensor:
    """Mean clamped-L1 SDF error plus code_reg * mean squared code norm."""
    code = codes[shape_idx]                                       # (B, L)
    pred = decoder(torch.cat([code, xyz], dim=-1))
    data = torch.mean(torch.abs(torch.clamp(pred, -clamp, clamp) - torch.clamp(sdf_target, -clamp, clamp)))
    return data + code_reg * torch.mean(torch.sum(code * code, dim=-1))


def train_step(state: TrainState, batch: dict, clamp: float = 0.1) -> torch.Tensor:
    """One Adam step over decoder and codes. batch = {shape_idx (B,) int,
    xyz (B, 3), sdf (B,)} on the state's device. Returns the loss before
    the step as a device scalar (no host sync). `clamp` is the reference's
    ClampingDistance (0.1); cold starts need a wider band: a fresh network
    that predicts outside +-clamp everywhere gets no gradient from clamped
    targets. On a sharded state every rank passes the same global batch:
    each dp rank takes its B / dp rows, and the loss returned is the mean
    over all B (every shard has the same size)."""
    if state.mesh is not None:
        batch = mesh_utils.batch_sharding(state.mesh)(batch)
    state.optimizer.zero_grad(set_to_none=False)
    # the decoder's products run at its precision backward too, as JAX's
    # value_and_grad of `apply` does; the loss adds no product of its own
    with deepsdf.matmul_precision_scope(state.decoder.config.matmul_precision):
        loss = sdf_loss(state.decoder, state.codes, batch["shape_idx"], batch["xyz"], batch["sdf"], clamp=clamp)
        loss.backward()
    if state.mesh is not None:
        loss = _average_over_dp(state, loss)
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def save_checkpoint(state: TrainState, path: str):
    """Decoder weights, latent table, step and config (torch.save)."""
    torch.save({
        "config": dataclasses.asdict(state.decoder.config),
        "weights": [w.detach().cpu() for w in state.decoder.weights],
        "biases": [b.detach().cpu() for b in state.decoder.biases],
        "codes": state.codes.detach().cpu(),
        "step": state.step,
    }, path)


def load_checkpoint(path: str, device=None, lr: float = 5e-4) -> TrainState:
    """A saved TrainState with a fresh optimizer at the saved weights."""
    device = entry_device(device, "deepsdf_train")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    config = deepsdf.DecoderConfig(**{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in saved["config"].items()})
    decoder = deepsdf.DeepSDFDecoder(config, saved["weights"], saved["biases"]).to(device)
    return state_from(decoder, saved["codes"].to(device), lr, int(saved["step"]))


def export_reference_format(state: TrainState, out_dir: str):
    """Write the decoder as a reference-style DeepSDF experiment dir
    (specs.json + ModelParameters/latest.pth) that either package's
    `load_torch_checkpoint`, and the reference itself, can load."""
    config = state.decoder.config
    os.makedirs(os.path.join(out_dir, "ModelParameters"), exist_ok=True)
    specs = {
        "CodeLength": config.code_len,
        "NetworkArch": "deep_sdf_decoder",
        "NetworkSpecs": {
            "dims": list(config.hidden),
            "latent_in": list(config.latent_in),
            "weight_norm": False,
            "use_tanh": bool(config.use_tanh),
        },
    }
    with open(os.path.join(out_dir, "specs.json"), "w") as f:
        json.dump(specs, f, indent=2)
    sd = {}
    for i, (w, b) in enumerate(zip(state.decoder.weights, state.decoder.biases)):
        sd[f"lin{i}.weight"] = w.detach().cpu().clone()          # nn.Linear's (out, in)
        sd[f"lin{i}.bias"] = b.detach().cpu().clone()
    torch.save({"model_state_dict": sd}, os.path.join(out_dir, "ModelParameters", "latest.pth"))


def make_sphere_dataset(gen: torch.Generator, num_shapes: int = 4, n: int = 4096) -> dict:
    """Synthetic SDF samples of spheres of radii 0.3 + 0.1 k, drawn on the
    generator's device. Even rows lie near a surface (surface point +
    N(0, 0.08) jitter), odd rows uniformly in [-1, 1]^3, as the
    reference's near-surface-biased preprocessing (deep_sdf/data.py):
    uniform-only samples are ~93% positive, which drives a fresh final-tanh
    decoder into saturation at +1 within ~100 Adam steps."""
    dev = gen.device
    d = torch.randn((n, 3), generator=gen, device=dev)
    shape_idx = torch.randint(0, num_shapes, (n,), generator=gen, device=dev)
    jitter = torch.randn((n, 3), generator=gen, device=dev)
    unif = torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0
    radii = 0.3 + 0.1 * torch.arange(num_shapes, device=dev, dtype=torch.float32)
    r = radii[shape_idx]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
    near = d * r[:, None] + 0.08 * jitter
    even = (torch.arange(n, device=dev) % 2 == 0)[:, None]
    xyz = torch.where(even, near, unif)
    return {"shape_idx": shape_idx, "xyz": xyz, "sdf": torch.linalg.vector_norm(xyz, dim=-1) - r}


def fit_spheres(config: deepsdf.DecoderConfig, num_shapes: int = 5, steps: int = 400, batch: int = 8192,
                seed: int = 0, lr: float = 5e-4, device=None):
    """Train the decoder to represent spheres of radii 0.3 .. 0.3 + 0.1 K.

    Benchmarks and closed-loop runs train the reference's architecture on
    an analytic shape family at startup, so the GN pays the reference's
    per-iteration decoder cost and still converges to verifiable geometry.
    The code prior keeps latents near 0, so the zero code (the GN's start)
    decodes to about the mean-radius sphere. Trains with clamp 0.5, which
    covers the whole sphere interior and keeps gradients alive from a cold
    start. One host sync, at the end.

    Returns (frozen decoder, codes (K, L), final loss)."""
    device = entry_device(device, "fit_spheres")
    state = init_state(config, num_shapes, seed, device, lr)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    loss = None
    for _ in range(steps):
        loss = train_step(state, make_sphere_dataset(gen, num_shapes, batch), clamp=0.5)
    return frozen_decoder(state.decoder), state.codes.detach(), float("nan") if loss is None else float(loss)
