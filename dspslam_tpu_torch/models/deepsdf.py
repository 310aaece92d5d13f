"""DeepSDF shape-prior decoder as a PyTorch module.

Port of dspslam_tpu/models/deepsdf.py: the auto-decoder MLP of DSP-SLAM
(code ++ xyz -> 8 ReLU layers with the input re-injected at `latent_in`
-> linear -> tanh), loadable from reference DeepSDF experiment directories
(`specs.json` + `ModelParameters/<ckpt>.pth`, weight-norm folded).

Weights keep the `nn.Linear` layout (out, in) in float32 and never require
grad: the Gauss-Newton stack takes input Jacobians from
`sdf_and_input_grad`, which dispatches on the config, as the JAX package's
`fused_kernel_ok` does, and then on the tensor:

* a decoder that kernel K1 computes (`supports`: the canonical layout in
  float32): K1 (kernels/decoder_fused.py) on a CUDA tensor, at every size
  and every matmul precision (its 3xTF32 products keep float32 accuracy),
  and K1's plain version on a CPU tensor;
* any other decoder: `sdf_and_input_grad_generic`, one batched autograd
  pass (JAX's `vmap(value_and_grad)`), on either device.

The config's arithmetic is JAX's (`apply`):

* `compute_dtype`: inputs, activations and weights are cast to it, each
  product accumulates in float32 and the bias is added in float32; the
  output is float32. At float32 the module computes in its own dtype (a
  float64 copy is a reference). At bfloat16 a product on the card runs as
  `torch.mm(..., out_dtype=torch.float32)`; where autograd records it (the
  generic path, training) and on the CPU, which have no kernel or formula
  for that op, it runs as a float32 product of the bf16-rounded operands.
  Each product of two bf16 values is exact in float32, so both forms do
  the arithmetic of a bf16 product with f32 accumulation, up to summation
  order.
* `matmul_precision`, per call on a CUDA tensor: "highest" is float32,
  "default" and "high" are TF32, as XLA maps them on an H100. On the CPU
  all three are float32, as XLA:CPU's are. The port's default is
  "highest", where JAX's is "default" (see the field).
  `matmul_precision_scope` sets cuBLAS's TF32 switch around the decoder's
  own products (forward and, in the generic path and the trainer,
  backward) and restores it after them, raising or not: the rest of the
  system runs its geometry in float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..kernels import decoder_fused

# matmul_precision -> whether cuBLAS may run float32 products as TF32
TF32_BY_PRECISION = {"highest": False, "high": True, "default": True}


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    code_len: int = 64
    hidden: tuple[int, ...] = (512,) * 8
    latent_in: tuple[int, ...] = (4,)
    use_tanh: bool = False          # tanh on the last linear's output
    final_tanh: bool = True         # the reference's always-present `th`
    compute_dtype: torch.dtype = torch.float32
    # JAX's default is "default" (TF32 on an H100). The port ships
    # "highest": on the card TF32 moves one GN iteration of a fitted
    # decoder 100x further from float64 (chip_smoke.py phase 14a; ROADMAP
    # R10). "default" and "high" stay available per decoder.
    matmul_precision: str = "highest"

    def __post_init__(self):
        tf32_for(self.matmul_precision)

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
        and config.compute_dtype == torch.float32
    )


def tf32_for(precision: str) -> bool:
    """Whether cuBLAS may run the decoder's float32 products as TF32 at
    `precision`; an unknown precision raises."""
    if precision not in TF32_BY_PRECISION:
        raise ValueError(f"unknown matmul_precision {precision!r}; expected one of {sorted(TF32_BY_PRECISION)}")
    return TF32_BY_PRECISION[precision]


@contextlib.contextmanager
def matmul_precision_scope(precision: str):
    """cuBLAS's TF32 switch set for `precision` inside the block and
    restored after it, also when the block raises. The switch acts on CUDA
    products only, so on the CPU every precision is float32. It is
    process-wide: the port calls the decoder and its geometry from one
    thread."""
    tf32 = tf32_for(precision)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           compute_dtype: torch.dtype) -> torch.Tensor:
    """x (..., in) @ w (out, in)^T (+ b): at float32 in the operands' own
    dtype; otherwise x (already in compute_dtype) times w rounded to
    compute_dtype, accumulated in float32, plus the float32 bias. On the
    card a product that autograd need not record is one
    `torch.mm(..., out_dtype=torch.float32)` (bf16 tensor cores, f32
    accumulation); the others, and every one on the CPU (which has no
    kernel for it), are float32 products of the rounded operands."""
    if compute_dtype == torch.float32:
        return nn.functional.linear(x, w, b)
    wc = w.to(compute_dtype)
    if x.is_cuda and not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        y = torch.mm(x.reshape(-1, x.shape[-1]), wc.t(), out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        y = nn.functional.linear(x.float(), wc.float())
    return y if b is None else y + b.float()


def mlp(config: DecoderConfig, weights, biases, inputs: torch.Tensor, layer_fn=None) -> torch.Tensor:
    """The decoder's function of (..., code_len + 3) inputs -> (...,), with
    JAX's `apply` arithmetic. `layer_fn(layer, x, w, b)` computes one
    linear layer (by default `linear` in the config's compute dtype)."""
    cdt = config.compute_dtype
    reduced = cdt != torch.float32
    if layer_fn is None:
        def layer_fn(_, x, w, b):
            return linear(x, w, b, cdt)
    x = inputs.to(cdt) if reduced else inputs
    orig = x
    last = len(weights) - 1
    for layer, (w, b) in enumerate(zip(weights, biases)):
        if layer in config.latent_in:
            x = torch.cat([x, orig], dim=-1)
        x = layer_fn(layer, x, w, b)
        if layer == last and config.use_tanh:
            x = torch.tanh(x)
        if layer < last:
            x = torch.relu(x)
            if reduced:
                x = x.to(cdt)
    x = x[..., 0]
    return torch.tanh(x) if config.final_tanh else x


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
        with matmul_precision_scope(self.config.matmul_precision):
            return mlp(self.config, self.weights, self.biases, inputs)

    def sdf_and_input_grad(self, inputs: torch.Tensor):
        """(N, code_len + 3) -> (sdf (N,), d sdf / d input (N, code_len + 3))."""
        if not supports(self.config):
            return sdf_and_input_grad_generic(self, inputs)
        return decoder_fused.sdf_and_input_grad(list(self.weights), list(self.biases), inputs)


def sdf_and_input_grad_generic(decoder: nn.Module, inputs: torch.Tensor):
    """Any decoder's sdf (N,) and input gradient (N, D) from one batched
    autograd pass: rows are independent, so the gradient of the sum is
    every row's gradient (JAX's `vmap(value_and_grad)`). Forward and
    backward run at the decoder's matmul precision; no host sync."""
    with matmul_precision_scope(decoder.config.matmul_precision), torch.enable_grad():
        x = inputs.detach().requires_grad_(True)
        sdf = decoder(x)
        (grad,) = torch.autograd.grad(sdf.sum(), x)
    return sdf.detach(), grad


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
                          device=None, compute_dtype: torch.dtype = torch.float32):
    """Load a DeepSDF experiment dir -> (config, DeepSDFDecoder), the config
    at `compute_dtype`.

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
        compute_dtype=compute_dtype,
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
