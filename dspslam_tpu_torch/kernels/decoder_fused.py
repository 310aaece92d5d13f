"""Fused DeepSDF value + input gradient: CUDA kernel K1 and its plain version.

`sdf_and_input_grad(weights, biases, inputs)` returns, for (N, 67) inputs
(64-d code + xyz) of the canonical DSP-SLAM decoder, the SDF (N,) and its
gradient with respect to the whole input (N, 67). On a CUDA tensor it
launches the hand-written Hopper kernel in `csrc/decoder_fused.cu` (the
port of the Pallas TPU kernel `dspslam_tpu/ops/pallas/decoder_kernel.py`,
`_kernel` / `fused_sdf_and_input_grad`), at every N: there is no size
threshold and no fallback. On a CPU tensor it runs
`sdf_and_input_grad_plain`, the same computation as explicit PyTorch ops
(forward, then backward by transposed matmuls and ReLU masks), which the
tests and `chip_smoke.py` hold the kernel against.

The kernel source is compiled with `nvcc` for `sm_90a` on first use by
`kernels/_nvcc.py` and bound with ctypes. Weights are given in the
`torch.nn.Linear` layout (out, in); the wrapper packs the forward and
transposed copies into one device buffer once per parameter version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _nvcc

IN_DIM = 67            # 64 code + 3 xyz
HID = 512
NARROW = HID - IN_DIM  # 445: layer-3 output width
CANONICAL_SHAPES = (
    [(HID, IN_DIM), (HID, HID), (HID, HID), (NARROW, HID)]
    + [(HID, HID)] * 4
    + [(1, HID)]
)

_lib = None


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    return _nvcc.build("decoder_fused")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _nvcc.load("decoder_fused")
        lib.dsp_decoder_fused.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.dsp_decoder_fused.restype = ctypes.c_int
        lib.dsp_decoder_fused_param_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _pad_to(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the last dimension to a multiple of `multiple`."""
    return torch.nn.functional.pad(t, (0, (-t.shape[-1]) % multiple))


def pack_params(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]):
    """One contiguous f32 buffer in the kernel's operand order: forward
    weights (in, out) with layer 4 split into w4h / w4x, then the transposed
    copies (out, in) the backward streams (see csrc/decoder_fused.cu).
    Matrix rows are zero-padded to a multiple of 32 floats and vectors to a
    multiple of 4, so every operand starts 16-byte aligned."""
    w = [t.detach().float() for t in weights]
    b = [t.detach().float().reshape(-1) for t in biases]
    fwd = [x.t() for x in w]
    mats = [
        fwd[0], b[0], fwd[1], b[1], fwd[2], b[2], fwd[3], b[3],
        fwd[4][:NARROW], fwd[4][NARROW:], b[4],
        fwd[5], b[5], fwd[6], b[6], fwd[7], b[7], w[8].reshape(-1), b[8],
        w[0], w[1], w[2], w[3], w[4][:, :NARROW], w[4][:, NARROW:],
        w[5], w[6], w[7],
    ]
    return torch.cat(
        [_pad_to(m, 32 if m.dim() == 2 else 4).reshape(-1) for m in mats]
    )


def _check_canonical(weights, biases):
    shapes = [tuple(t.shape) for t in weights]
    if shapes != CANONICAL_SHAPES or [tuple(t.shape) for t in biases] != [
        (s[0],) for s in CANONICAL_SHAPES
    ]:
        raise ValueError(
            "decoder_fused supports only the canonical decoder "
            f"(67 -> 8 x 512, latent at layer 4); got weight shapes {shapes}"
        )


def _packed(weights, biases) -> torch.Tensor:
    """Packed operands, cached on the first weight tensor (so the cache dies
    with the parameters) and rebuilt when any tensor's version changes."""
    key = tuple((id(t), t._version) for t in (*weights, *biases))
    hit = getattr(weights[0], "_decoder_fused_packed", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    packed = pack_params(weights, biases)
    expected = _library().dsp_decoder_fused_param_floats()
    if packed.numel() != expected:
        raise RuntimeError(
            f"decoder_fused: packed {packed.numel()} floats, kernel expects {expected}"
        )
    weights[0]._decoder_fused_packed = (key, packed)
    return packed


def sdf_and_input_grad(weights, biases, inputs: torch.Tensor):
    """(N, 67) -> (sdf (N,), d sdf / d input (N, 67)) for the canonical
    decoder. CPU tensors take the plain version; CUDA tensors launch K1."""
    if inputs.device.type == "cpu":
        return sdf_and_input_grad_plain(weights, biases, inputs)
    if inputs.device.type != "cuda":
        raise ValueError(f"decoder_fused: unsupported device {inputs.device}")
    _check_canonical(weights, biases)
    if inputs.dtype != torch.float32 or inputs.dim() != 2 or inputs.shape[1] != IN_DIM:
        raise ValueError(
            "decoder_fused: inputs must be float32 (N, 67), got "
            f"{inputs.dtype} {tuple(inputs.shape)}"
        )
    if not inputs.is_contiguous():
        raise ValueError("decoder_fused: inputs must be contiguous")
    for t in (*weights, *biases):
        if t.device != inputs.device or t.dtype != torch.float32:
            raise ValueError(
                "decoder_fused: weights must be float32 on the inputs' device"
            )
    n = inputs.shape[0]
    sdf = torch.empty((n,), device=inputs.device, dtype=torch.float32)
    grad = torch.empty((n, IN_DIM), device=inputs.device, dtype=torch.float32)
    if n == 0:
        return sdf, grad
    with torch.cuda.device(inputs.device):
        packed = _packed(weights, biases)
        if packed.data_ptr() % 16:
            raise RuntimeError("decoder_fused: packed weights are not 16-byte aligned")
        err = _library().dsp_decoder_fused(
            inputs.data_ptr(), packed.data_ptr(), sdf.data_ptr(),
            grad.data_ptr(), n, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decoder_fused: kernel launch failed, CUDA error {err}")
    sdf_and_input_grad.launches += 1
    return sdf, grad


sdf_and_input_grad.launches = 0


def sdf_and_input_grad_plain(
    weights, biases, inputs: torch.Tensor, latent_in: Sequence[int] = (4,),
    use_tanh: bool = False, final_tanh: bool = True,
):
    """Plain PyTorch version: explicit forward keeping the pre-activations,
    then the backward to the input by transposed matmuls and ReLU masks.
    Works for any DeepSDF layout (the defaults are the canonical one)."""
    orig = inputs
    x = inputs
    last = len(weights) - 1
    zs = []
    for layer, (w, b) in enumerate(zip(weights, biases)):
        if layer in latent_in:
            x = torch.cat([x, orig], dim=-1)
        z = torch.nn.functional.linear(x, w, b)
        if layer < last:
            zs.append(z)
            x = torch.relu(z)
    y = z[..., 0]
    g = torch.ones_like(y)
    if use_tanh:
        y = torch.tanh(y)
        g = 1.0 - y * y
    if final_tanh:
        y = torch.tanh(y)
        g = g * (1.0 - y * y)

    d = orig.shape[-1]
    g = g[..., None] * weights[last][0]           # d sdf / d h_{last-1}
    g_orig = torch.zeros_like(orig)
    for layer in range(last - 1, -1, -1):
        g = (g * (zs[layer] > 0)) @ weights[layer]  # d sdf / d (layer input)
        if layer in latent_in:
            g_orig = g_orig + g[..., -d:]
            g = g[..., :-d]
    return y, g + g_orig
