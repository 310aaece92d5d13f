"""DeepSDF shape-prior decoder as a PyTorch module.

Port of dspslam_tpu/models/deepsdf.py: the auto-decoder MLP of DSP-SLAM
(code ++ xyz -> 8 ReLU layers with the input re-injected at `latent_in`
-> linear -> tanh), loadable from reference DeepSDF experiment directories
(`specs.json` + `ModelParameters/<ckpt>.pth`, weight-norm folded).

Weights keep the `nn.Linear` layout (out, in) and never require grad: the
Gauss-Newton stack takes input Jacobians from `sdf_and_input_grad`, which
dispatches on the tensor it is given:

* CPU tensor: the plain PyTorch version (explicit forward + backward);
* CUDA tensor, canonical decoder: the fused CUDA kernel K1
  (kernels/decoder_fused.py), at every size;
* CUDA tensor, any other decoder: an error naming the config. There is
  no quiet fallback.

The decoder runs in float32 throughout.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..kernels import decoder_fused


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    code_len: int = 64
    hidden: tuple[int, ...] = (512,) * 8
    latent_in: tuple[int, ...] = (4,)
    use_tanh: bool = False          # tanh on the last linear's output
    final_tanh: bool = True         # the reference's always-present `th`

    @property
    def in_dim(self) -> int:
        return self.code_len + 3

    def layer_dims(self) -> list[tuple[int, int]]:
        """(fan_in, fan_out) per linear layer; a layer feeding a latent
        re-injection point is narrowed by in_dim so the concatenated width
        matches (the reference's bookkeeping)."""
        dims = [self.in_dim] + list(self.hidden) + [1]
        out = []
        for layer in range(len(dims) - 1):
            fan_out = dims[layer + 1]
            if (layer + 1) in self.latent_in:
                fan_out -= dims[0]
            out.append((dims[layer], fan_out))
        return out


def supports(config: DecoderConfig) -> bool:
    """Whether the fused CUDA kernel K1 computes this decoder."""
    return (
        config.code_len == 64
        and tuple(config.hidden) == (512,) * 8
        and tuple(config.latent_in) == (4,)
        and not config.use_tanh
        and config.final_tanh
    )


class DeepSDFDecoder(nn.Module):
    """DeepSDF MLP. `forward(inputs)` maps (..., code_len + 3) -> (...,)."""

    def __init__(self, config: DecoderConfig, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor]):
        super().__init__()
        dims = config.layer_dims()
        got = [tuple(w.shape) for w in weights]
        if got != [(o, i) for i, o in dims] or len(biases) != len(dims):
            raise ValueError(f"weights {got} do not match {config}")
        self.config = config
        self.weights = nn.ParameterList(
            nn.Parameter(w.float().contiguous(), requires_grad=False) for w in weights
        )
        self.biases = nn.ParameterList(
            nn.Parameter(b.float().contiguous(), requires_grad=False) for b in biases
        )

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = inputs
        last = len(self.weights) - 1
        for layer, (w, b) in enumerate(zip(self.weights, self.biases)):
            if layer in cfg.latent_in:
                x = torch.cat([x, inputs], dim=-1)
            x = nn.functional.linear(x, w, b)
            if layer == last and cfg.use_tanh:
                x = torch.tanh(x)
            if layer < last:
                x = torch.relu(x)
        x = x[..., 0]
        return torch.tanh(x) if cfg.final_tanh else x

    def sdf_and_input_grad(self, inputs: torch.Tensor):
        """(N, code_len + 3) -> (sdf (N,), d sdf / d input (N, code_len + 3))."""
        cfg = self.config
        if inputs.is_cuda:
            if not supports(cfg):
                raise ValueError(
                    f"no CUDA kernel computes sdf_and_input_grad for {cfg}; "
                    "the fused kernel takes the canonical decoder only"
                )
            return decoder_fused.sdf_and_input_grad(
                list(self.weights), list(self.biases), inputs
            )
        return decoder_fused.sdf_and_input_grad_plain(
            list(self.weights), list(self.biases), inputs,
            latent_in=cfg.latent_in, use_tanh=cfg.use_tanh,
            final_tanh=cfg.final_tanh,
        )


def init_params(config: DecoderConfig, generator: torch.Generator,
                device=None) -> DeepSDFDecoder:
    """He-style normal weights and zero biases drawn from `generator`."""
    ws, bs = [], []
    for fan_in, fan_out in config.layer_dims():
        w = torch.randn((fan_out, fan_in), generator=generator) * np.sqrt(2.0 / fan_in)
        ws.append(w)
        bs.append(torch.zeros((fan_out,)))
    return DeepSDFDecoder(config, ws, bs).to(device)


def params_from_jax(params_np: dict, config: DecoderConfig | None = None,
                    device=None) -> DeepSDFDecoder:
    """Module from the JAX pytree {'w': [(in, out)...], 'b': [...]} held as
    numpy arrays (weights are transposed into the nn.Linear layout)."""
    config = config or DecoderConfig()
    ws = [torch.from_numpy(np.asarray(w, np.float32).T.copy()) for w in params_np["w"]]
    bs = [torch.from_numpy(np.asarray(b, np.float32).copy()) for b in params_np["b"]]
    return DeepSDFDecoder(config, ws, bs).to(device)


# ---------------------------------------------------------------------------
# Analytic decoder for tests and synthetic-data pipelines


def sphere_decoder_fn(params: dict, inputs: torch.Tensor) -> torch.Tensor:
    """SDF of a sphere whose radius is modulated by the code:
    sdf = ||x|| - (r0 + w . code), params = {'r0': (), 'w': (L,)}."""
    code, xyz = inputs[..., :-3], inputs[..., -3:]
    r = params["r0"] + torch.sum(code * params["w"], dim=-1)
    return torch.linalg.vector_norm(xyz + 1e-12, dim=-1) - r


def make_sphere_params(code_len: int = 64, r0: float = 0.5, device=None) -> dict:
    w = torch.zeros((code_len,), device=device)
    w[0] = 0.3
    return {"r0": torch.tensor(r0, dtype=torch.float32, device=device), "w": w}


class SphereDecoder(nn.Module):
    """`sphere_decoder_fn` with the decoder interface the GN stack uses."""

    def __init__(self, params: dict):
        super().__init__()
        self.register_buffer("r0", params["r0"])
        self.register_buffer("w", params["w"])

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return sphere_decoder_fn({"r0": self.r0, "w": self.w}, inputs)

    def sdf_and_input_grad(self, inputs: torch.Tensor):
        xyz = inputs[..., -3:] + 1e-12
        norm = torch.linalg.vector_norm(xyz, dim=-1)
        sdf = norm - (self.r0 + torch.sum(inputs[..., :-3] * self.w, dim=-1))
        grad = torch.cat(
            [(-self.w).expand(inputs.shape[:-1] + self.w.shape), xyz / norm[..., None]],
            dim=-1,
        )
        return sdf, grad


# ---------------------------------------------------------------------------
# Reference checkpoint ingestion (DeepSDF workspace.py layout)


def _fold_weight_norm(state: dict, prefix: str):
    """(W, b) with weight-norm folded: W = g * v / ||v||_row."""
    g = state[prefix + ".weight_g"].float()
    v = state[prefix + ".weight_v"].float()
    norm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1).reshape(
        (-1,) + (1,) * (v.ndim - 1)
    )
    return g * v / norm, state[prefix + ".bias"].float()


def load_torch_checkpoint(experiment_dir: str, checkpoint: str = "latest",
                          device=None):
    """Load a DeepSDF experiment dir -> (config, DeepSDFDecoder).

    Weight-norm parametrization is folded into plain weights and
    DataParallel 'module.' prefixes are stripped.
    """
    with open(os.path.join(experiment_dir, "specs.json")) as f:
        specs = json.load(f)
    net = specs["NetworkSpecs"]
    config = DecoderConfig(
        code_len=int(specs["CodeLength"]),
        hidden=tuple(net["dims"]),
        latent_in=tuple(net.get("latent_in", ())),
        use_tanh=bool(net.get("use_tanh", False)),
    )
    path = os.path.join(experiment_dir, "ModelParameters", checkpoint + ".pth")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state = {k.removeprefix("module."): v for k, v in saved["model_state_dict"].items()}
    ws, bs = [], []
    for layer in range(len(config.layer_dims())):
        prefix = f"lin{layer}"
        if prefix + ".weight_g" in state:
            w, b = _fold_weight_norm(state, prefix)
        else:
            w, b = state[prefix + ".weight"].float(), state[prefix + ".bias"].float()
        ws.append(w)
        bs.append(b)
    return config, DeepSDFDecoder(config, ws, bs).to(device)
