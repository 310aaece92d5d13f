"""Two-tier FAST-9/16 score map: CUDA kernel K2 and its plain version.

`fast_score_map(img, t_lo, t_hi, boost)` maps a (B, H, W) float32 batch of
images to (B, H, W) scores: at each pixel, the 16 Bresenham-circle
neighbours give d = neighbour - center (zero padding outside the image);
a circular run of >= 9 neighbours with d > t (bright) or d < -t (dark) is
a corner at threshold t. The score is sum |d| over all 16 neighbours at
t_lo corners, plus `boost` at t_hi corners, 0 elsewhere. This is
`dspslam_tpu/ops/pallas/fast_kernel.py::fast_score_map_pallas`, per image.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
`csrc/fast_score.cu` (built by `kernels/_nvcc.py` on first use); there is
no fallback. On a CPU tensor it runs `fast_score_map_plain`, the same
bit logic as PyTorch ops, which the tests and `chip_smoke.py` hold the
kernel against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _nvcc

# Bresenham circle of radius 3, (dx, dy), clockwise from the top: the
# _CIRCLE of frontend/orb.py
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

_lib = None


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    return _nvcc.build("fast_score")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _nvcc.load("fast_score")
        lib.dsp_fast_score.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.dsp_fast_score.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(img: torch.Tensor):
    if img.dtype != torch.float32 or img.dim() != 3:
        raise ValueError(
            f"fast_score: img must be float32 (B, H, W), got {img.dtype} {tuple(img.shape)}"
        )
    if not img.is_contiguous():
        raise ValueError("fast_score: img must be contiguous")


def fast_score_map(img: torch.Tensor, t_lo: float = 7.0, t_hi: float = 20.0,
                   boost: float = 1e4) -> torch.Tensor:
    """(B, H, W) -> (B, H, W) two-tier scores. CPU tensors take the plain
    version; CUDA tensors launch K2."""
    _check(img)
    if img.device.type == "cpu":
        return fast_score_map_plain(img, t_lo, t_hi, boost)
    if img.device.type != "cuda":
        raise ValueError(f"fast_score: unsupported device {img.device}")
    B, H, W = img.shape
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        err = _library().dsp_fast_score(
            img.data_ptr(), out.data_ptr(), B, H, W, float(t_lo), float(t_hi),
            float(boost), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fast_score: kernel launch failed, CUDA error {err}")
    fast_score_map.launches += 1
    return out


fast_score_map.launches = 0


def _has_run9(word16: torch.Tensor) -> torch.Tensor:
    # int32 words: the arithmetic >> only pollutes bits >= 24, never read
    x = word16 | (word16 << 16)
    y = x
    for s in range(1, 9):
        y = y & (x >> s)
    return (y & 0xFFFF) != 0


def fast_score_map_plain(img: torch.Tensor, t_lo: float = 7.0, t_hi: float = 20.0,
                         boost: float = 1e4) -> torch.Tensor:
    """Plain PyTorch version of K2: 16 slices of the zero-padded image and
    the int32 bit logic of fast_kernel.py:52-90, |d| summed in neighbour
    order."""
    _check(img)
    B, H, W = img.shape
    padded = F.pad(img, (3, 3, 3, 3))
    center = img
    bright = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    dark = torch.zeros_like(bright)
    abs_sum = torch.zeros_like(img)
    for k, (dx, dy) in enumerate(CIRCLE):
        d = padded[:, 3 + dy: 3 + dy + H, 3 + dx: 3 + dx + W] - center
        abs_sum = abs_sum + d.abs()
        # bit 16 + k of an int32 word (bit 31 is the sign bit)
        bright = bright | ((d > t_lo).to(torch.int32) << k)
        bright = bright | ((d > t_hi).to(torch.int32) << (16 + k))
        dark = dark | ((d < -t_lo).to(torch.int32) << k)
        dark = dark | ((d < -t_hi).to(torch.int32) << (16 + k))
    corner_lo = _has_run9(bright & 0xFFFF) | _has_run9(dark & 0xFFFF)
    corner_hi = _has_run9((bright >> 16) & 0xFFFF) | _has_run9((dark >> 16) & 0xFFFF)
    score = torch.where(corner_lo, abs_sum, 0.0)
    return torch.where(corner_hi, score + boost, score)
