"""Tensor helpers shared by the two detectors, with the JAX package's
semantics (dspslam_tpu/detect/{maskrcnn,pointpillars}.py):

- `conv2d_same`: XLA's "SAME" padding, which is asymmetric (the extra row
  or column goes below and right) where torch's `padding=k//2` is not, and
  the bias added after the product is rounded to the activation dtype (two
  roundings in bf16, as `lax.conv_general_dilated(...) + b` has);
- `max_pool_same`: the 3x3/2 max pool as a -inf-padded window;
- `conv_transpose2d`: a transposed convolution whose kernel equals its
  stride (mmdet's ConvTranspose2d upsample layers), IOHW weights as mmdet
  stores them, the bias added after the product in the activation dtype;
- `resize_nearest`: `jax.image.resize(..., "nearest")`, half-pixel centres
  (`F.interpolate(mode="nearest")` floors i * in / out instead);
- `true_div`: division by a Python number as IEEE division on the card too
  (PyTorch's CUDA kernel multiplies by the reciprocal of a CPU scalar);
- `top_k`: `lax.top_k`'s order, the lower index first among equal values
  (`torch.topk` promises no order for ties).

The trainers share `leaves`, `trainable`, `Trainer` (Adam with optax's
defaults and an optional per-step rate) and `deterministic`.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int, value: float = 0.0) -> torch.Tensor:
    h_lo, h_hi = same_pads(x.shape[-2], kh, stride)
    w_lo, w_hi = same_pads(x.shape[-1], kw, stride)
    if h_lo or h_hi or w_lo or w_hi:
        x = F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=value)
    return x


def conv2d_same(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """NCHW convolution with OIHW weights p["w"] and bias p["b"], both cast
    to the activation dtype; the product is rounded to that dtype, then the
    bias is added in it."""
    w = p["w"].to(x.dtype)
    x = _pad_same(x, w.shape[-2], w.shape[-1], stride)
    return F.conv2d(x, w, stride=stride) + p["b"].to(x.dtype)[None, :, None, None]


def conv_transpose2d(x: torch.Tensor, p: dict) -> torch.Tensor:
    """NCHW transposed convolution with IOHW weights p["w"] (in, out, k, k)
    at stride k, and bias p["b"]; both cast to the activation dtype, the
    bias added in it. With the kernel equal to the stride each input pixel
    writes its own k x k block, so the layer is one product, (pixels, in)
    by (in, out k k), and a reshuffle of its columns into the blocks (its
    gradients are products too, which accumulate in f32 for bf16 on every
    device, where the CPU's bf16 transposed convolution loses its input
    gradient)."""
    w = p["w"].to(x.dtype)
    cin, cout, k, _ = w.shape
    n, _, h, wd = x.shape
    y = x.permute(0, 2, 3, 1).reshape(-1, cin) @ w.reshape(cin, cout * k * k)
    y = y.view(n, h, wd, cout, k, k).permute(0, 3, 1, 4, 2, 5).reshape(n, cout, h * k, wd * k)
    return y + p["b"].to(x.dtype)[None, :, None, None]


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    return F.max_pool2d(_pad_same(x, k, k, stride, value=float("-inf")), k, stride)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    # floor((i + 0.5) * n_in / n_out), exact in integers (JAX computes it in
    # f32, which equals the exact floor at image sizes)
    i = torch.arange(n_out, dtype=torch.int64, device=device)
    return (2 * i + 1) * n_in // (2 * n_out)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of the last two axes to out_hw, half-pixel centres."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    x = x.index_select(-2, _nearest_index(h, oh, x.device))
    return x.index_select(-1, _nearest_index(w, ow, x.device))


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with IEEE division on every device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest of a 1-D tensor, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def tree_map(fn, tree):
    """fn over every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(np_params, device=None):
    """A parameter tree of numpy arrays (the JAX pytree, passed through
    numpy) as float32 tensors on `device`, same structure."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(device), np_params)


def he_normal(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * np.sqrt(2.0 / fan_in)


def leaves(tree) -> list:
    """The tensors of a parameter tree, in tree order."""
    out = []
    tree_map(out.append, tree)
    return out


def trainable(tree, device) -> dict:
    """A float32 copy of a parameter tree on `device` whose leaves require grad."""
    return tree_map(lambda t: t.detach().to(device, torch.float32).clone().requires_grad_(True), tree)


class Trainer:
    """torch.optim.Adam over trainable tensors with optax.adam's defaults
    (betas 0.9 / 0.999, eps 1e-8 outside the square root) and an optional
    per-step rate: step k takes schedule(k), as optax applies a schedule."""

    def __init__(self, tensors: list, lr: float, schedule=None):
        self.optimizer = torch.optim.Adam(tensors, lr=lr if schedule is None else schedule(0),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.schedule = schedule
        self.steps = 0

    def step(self, loss: torch.Tensor):
        """Backpropagate `loss` and take one step."""
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        if self.schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.steps)
        self.optimizer.step()
        self.steps += 1


@contextlib.contextmanager
def deterministic():
    """Run what is inside with deterministic algorithms on the card
    (sort-based scatter-adds in place of atomic adds, deterministic cuDNN
    convolutions), so that a seeded training run gives the same result in
    every run. cuBLAS needs CUBLAS_WORKSPACE_CONFIG for that, read when the
    process makes its first handle: a program that enters this sets it
    before its first product; here it is only defaulted."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
