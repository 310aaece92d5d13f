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
tests and `chip_smoke.py` hold the kernel against. Each launch adds 1 to
the process-wide counter `k1_launches` and N to `k1_rows`
(`utils.timing.count`).

The kernel source is compiled with `nvcc` for `sm_90a` on first use by
`kernels/_nvcc.py` and bound with ctypes. Weights are given in the
`torch.nn.Linear` layout (out, in); the wrapper packs them once per
parameter version (`pack_params`): the forward (out, in) and backward
(in, out) copies, each split into TF32 hi and lo parts for the kernel's
3xTF32 tensor-core products, in the order the kernel's shared-memory
stages take them.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..utils import timing
from . import _nvcc

IN_DIM = 67            # 64 code + 3 xyz
HID = 512
NARROW = HID - IN_DIM  # 445: layer-3 output width
LATENT_IN = 4          # the layer whose input re-joins the decoder's input
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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.dsp_decoder_fused.restype = ctypes.c_int
        lib.dsp_decoder_fused_param_floats.restype = ctypes.c_longlong
        lib.dsp_decoder_fused_clusters.argtypes = [ctypes.c_int]
        lib.dsp_decoder_fused_clusters.restype = ctypes.c_int
        lib.dsp_decoder_fused_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dsp_decoder_fused_scratch_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


IN_PAD = 72  # the input width padded to a multiple of 8
HALF = 256   # columns per block of a 512-wide product in the packed buffer
ROWS = 64    # rows per tile: one wgmma M


def passes() -> list[tuple[int, bool, int, int]]:
    """The kernel's 16 products in launch order: (layer, forward, N, K),
    each B operand an (N, K) matrix read K-major. The forward takes w_l
    (out, in); the backward w_l^T (in, out). Layer 3's 445 outputs are
    padded to 512, the 67 inputs to 72 (csrc/decoder_fused.cu,
    pass_k8 / pass_n). A 512-column product streams as two halves of 256
    columns."""
    fwd = [(l, True, HID, IN_PAD if l == 0 else HID) for l in range(8)]
    bwd = [(l, False, IN_PAD if l == 0 else HID, 448 if l == 3 else HID)
           for l in reversed(range(8))]
    return fwd + bwd


def packed_floats() -> int:
    """Floats in the packed buffer: every product's hi and lo (2 N K), the
    eight padded biases, w8 and b8 padded to 4."""
    return sum(2 * n * k for _, _, n, k in passes()) + 8 * HID + HID + 4


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (PTX
    cvt.rna.tf32.f32): the low 13 mantissa bits come out zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _stage_order(m: torch.Tensor) -> torch.Tensor:
    """(N, K) -> for each block of 8 k, the hi part then the lo part, each as
    N / 8 groups of [2 k-halves][8 rows][4 k], the no-swizzle K-major layout
    the kernel's wgmma descriptors read."""
    n, k = m.shape
    hi = tf32_round(m)
    lo = tf32_round(m - hi)

    def tiles(a):
        return a.reshape(n // 8, 8, k // 8, 2, 4).permute(2, 0, 3, 1, 4).reshape(k // 8, 8 * n)

    return torch.stack([tiles(hi), tiles(lo)], dim=1).reshape(-1)


def _pad2(m: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(m, (0, cols - m.shape[1], 0, rows - m.shape[0]))


def pack_params(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]):
    """One contiguous f32 buffer in the kernel's operand order: the 16
    products of `passes()`, each in halves of 256 columns in stage order,
    then b0..b7 (zero-padded to 512), w8 and b8 (padded to 4)."""
    w = [t.detach().float() for t in weights]
    b = [t.detach().float().reshape(-1) for t in biases]
    parts = []
    for l, forward, n, k in passes():
        m = _pad2(w[l] if forward else w[l].t(), n, k)
        parts += [_stage_order(half) for half in m.split(HALF)]
    parts += [torch.nn.functional.pad(b[l], (0, HID - b[l].numel())) for l in range(8)]
    parts += [w[8].reshape(-1), torch.nn.functional.pad(b[8], (0, 3))]
    return torch.cat(parts)


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


WIDTHS = (1, 2)  # CTAs per 64-row tile (a cluster) that the kernel supports
_clusters: dict = {}


def clusters(device: torch.device, cw: int) -> int:
    """How many clusters of `cw` CTAs, i.e. 64-row tiles, the card runs at
    once (the CUDA occupancy query)."""
    key = (device.index, cw)
    if key not in _clusters:
        with torch.cuda.device(device):
            _clusters[key] = _library().dsp_decoder_fused_clusters(cw)
        if _clusters[key] < 1:
            raise RuntimeError(f"decoder_fused: no cluster of {cw} CTAs fits on {device}")
    return _clusters[key]


def width(device: torch.device, n: int) -> int:
    """The CTAs per 64-row tile that n rows take by default: the widest
    cluster whose tiles the card runs in one wave, else 1."""
    tiles = -(-n // ROWS)
    return next((cw for cw in sorted(WIDTHS, reverse=True)
                 if cw == 1 or tiles <= clusters(device, cw)), 1)


def sdf_and_input_grad(weights, biases, inputs: torch.Tensor, cluster: int | None = None):
    """(N, 67) -> (sdf (N,), d sdf / d input (N, 67)) for the canonical
    decoder. CPU tensors take the plain version; CUDA tensors launch K1,
    with `cluster` CTAs per 64-row tile (one of WIDTHS; by default the
    kernel's choice, `width`)."""
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
    if cluster is not None and cluster not in WIDTHS:
        raise ValueError(f"decoder_fused: cluster must be one of {WIDTHS}, got {cluster}")
    n = inputs.shape[0]
    sdf = torch.empty((n,), device=inputs.device, dtype=torch.float32)
    grad = torch.empty((n, IN_DIM), device=inputs.device, dtype=torch.float32)
    if n == 0:
        return sdf, grad
    with torch.cuda.device(inputs.device):
        packed = _packed(weights, biases)
        if packed.data_ptr() % 16:
            raise RuntimeError("decoder_fused: packed weights are not 16-byte aligned")
        lib = _library()
        cw = cluster or width(inputs.device, n)
        scratch = torch.empty((lib.dsp_decoder_fused_scratch_floats(n, cw),),
                              device=inputs.device, dtype=torch.float32)
        err = lib.dsp_decoder_fused(
            inputs.data_ptr(), packed.data_ptr(), sdf.data_ptr(), grad.data_ptr(),
            scratch.data_ptr(), n, cw, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decoder_fused: kernel launch failed, CUDA error {err}")
    timing.count("k1_launches")
    timing.count("k1_rows", n)
    return sdf, grad


def sdf_and_input_grad_plain(weights, biases, inputs: torch.Tensor):
    """Plain PyTorch version: explicit forward keeping the pre-activations,
    then the backward to the input by transposed matmuls and ReLU masks, for
    the canonical layout (the input re-injected at layer 4, a final tanh).
    Any other layout takes `models.deepsdf.sdf_and_input_grad_generic`."""
    orig = inputs
    x = inputs
    last = len(weights) - 1
    zs = []
    for layer, (w, b) in enumerate(zip(weights, biases)):
        if layer == LATENT_IN:
            x = torch.cat([x, orig], dim=-1)
        z = torch.nn.functional.linear(x, w, b)
        if layer < last:
            zs.append(z)
            x = torch.relu(z)
    y = torch.tanh(z[..., 0])

    d = orig.shape[-1]
    g = (1.0 - y * y)[..., None] * weights[last][0]   # d sdf / d h_{last-1}
    g_orig = torch.zeros_like(orig)
    for layer in range(last - 1, -1, -1):
        g = (g * (zs[layer] > 0)) @ weights[layer]  # d sdf / d (layer input)
        if layer == LATENT_IN:
            g_orig = g_orig + g[..., -d:]
            g = g[..., :-d]
    return y, g + g_orig
