"""Two-tier FAST-9/16 score maps: CUDA kernel K2 and its plain version.

`fast_score_maps(images, t_lo, t_hi, boost)` maps a list of float32 (h, w)
images of any shapes to their (h, w) scores: at each pixel, the 16
Bresenham-circle neighbours give d = neighbour - center (zero padding
outside the image); a circular run of >= 9 neighbours with d > t (bright)
or d < -t (dark) is a corner at threshold t. The score is sum |d| over all
16 neighbours at t_lo corners, plus `boost` at t_hi corners, 0 elsewhere.
This is `dspslam_tpu/ops/pallas/fast_kernel.py::fast_score_map_pallas`,
per image.

On CUDA tensors the wrapper launches the hand-written Hopper kernel in
`csrc/fast_score.cu` (built by `kernels/_nvcc.py` on first use) once for up
to 16 maps, the two 8-level pyramids of a stereo frame; the scores come
back as views of one packed buffer, in the images' order. There is no
fallback. On CPU tensors it runs `fast_score_maps_plain`, which is
`fast_score_map_plain` per map, the same bit logic as PyTorch ops; the
tests and `chip_smoke.py` hold the kernel against it. Each launch adds 1
to the process-wide counter `k2_launches` (`utils.timing.count`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from ..utils import timing
from . import _nvcc

# Bresenham circle of radius 3, (dx, dy), clockwise from the top: the
# _CIRCLE of frontend/orb.py
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

# the kernel's tiling (csrc/fast_score.cu, checked against the library)
TILE_W, TILE_H, MAX_MAPS = 32, 16, 16


class _MapDesc(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("out", ctypes.c_longlong),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("tiles_x", ctypes.c_int), ("first_tile", ctypes.c_int)]


class _MapTable(ctypes.Structure):
    _fields_ = [("map", _MapDesc * MAX_MAPS), ("count", ctypes.c_int)]


_lib = None


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    return _nvcc.build("fast_score")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _nvcc.load("fast_score")
        lib.dsp_fast_score_maps.argtypes = [
            ctypes.POINTER(_MapTable), ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.dsp_fast_score_maps.restype = ctypes.c_int
        geometry = [ctypes.c_int() for _ in range(3)]
        lib.dsp_fast_score_geometry(*[ctypes.byref(g) for g in geometry])
        if tuple(g.value for g in geometry) != (TILE_W, TILE_H, MAX_MAPS):
            raise RuntimeError(
                f"fast_score: kernel tiling {[g.value for g in geometry]} != "
                f"{(TILE_W, TILE_H, MAX_MAPS)}")
        _lib = lib
    return _lib


def tile_table(shapes: Sequence[tuple[int, int]]) -> list[tuple[int, int, int, int, int]]:
    """Per map (h, w): (out offset, h, w, tiles across, first tile) of the
    flat tile grid one launch covers; the maps' outputs are packed in
    order."""
    table, out, first = [], 0, 0
    for h, w in shapes:
        tiles_x = -(-w // TILE_W)
        table.append((out, h, w, tiles_x, first))
        out += h * w
        first += tiles_x * -(-h // TILE_H)
    return table


_tables: dict = {}


def _map_table(shapes: tuple) -> tuple[_MapTable, int]:
    """A launch's map table for these shapes, with no sources filled in,
    and its tile count; built once per tuple of shapes, then copied."""
    hit = _tables.get(shapes)
    if hit is None:
        rows = tile_table(shapes)
        table = _MapTable(count=len(rows))
        for i, (off, h, w, tiles_x, first) in enumerate(rows):
            table.map[i] = _MapDesc(None, off, h, w, tiles_x, first)
        _, h, _, tiles_x, first = rows[-1]
        hit = _tables[shapes] = (table, first + tiles_x * -(-h // TILE_H))
    return _MapTable.from_buffer_copy(hit[0]), hit[1]


def _check(img: torch.Tensor, dims: int):
    if img.dtype != torch.float32 or img.dim() != dims:
        shape = "(B, H, W)" if dims == 3 else "(h, w)"
        raise ValueError(
            f"fast_score: images must be float32 {shape}, got {img.dtype} {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("fast_score: images must be contiguous")


def fast_score_maps(images: Sequence[torch.Tensor], t_lo: float = 7.0, t_hi: float = 20.0,
                    boost: float = 1e4) -> list[torch.Tensor]:
    """[(h, w)] -> [(h, w)] two-tier scores of each image. CPU tensors take
    the plain version; CUDA tensors launch K2 once for every 16 maps and get
    views of one packed buffer."""
    for im in images:
        _check(im, 2)
    if not images or images[0].device.type == "cpu":
        return fast_score_maps_plain(images, t_lo, t_hi, boost)
    device = images[0].device
    if device.type != "cuda" or any(im.device != device for im in images):
        raise ValueError(f"fast_score: images must be on one CUDA device, got {device}")
    out = torch.empty((sum(im.numel() for im in images),), device=device, dtype=torch.float32)
    base = 0
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for start in range(0, len(images), MAX_MAPS):
            chunk = [im for im in images[start: start + MAX_MAPS] if im.numel()]
            if not chunk:
                continue
            table, n_tiles = _map_table(tuple(tuple(im.shape) for im in chunk))
            for i, im in enumerate(chunk):
                table.map[i].src = im.data_ptr()
            err = _library().dsp_fast_score_maps(
                ctypes.byref(table), n_tiles, out.data_ptr() + 4 * base,
                float(t_lo), float(t_hi), float(boost), stream)
            if err != 0:
                raise RuntimeError(f"fast_score: kernel launch failed, CUDA error {err}")
            timing.count("k2_launches")
            base += sum(im.numel() for im in chunk)
    return [t.view(im.shape) for t, im in zip(out.split([im.numel() for im in images]), images)]



def fast_score_maps_plain(images: Sequence[torch.Tensor], t_lo: float = 7.0,
                          t_hi: float = 20.0, boost: float = 1e4) -> list[torch.Tensor]:
    """Plain version of the multi-map entry: `fast_score_map_plain` per
    map."""
    return [fast_score_map_plain(im[None], t_lo, t_hi, boost)[0] for im in images]


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
    _check(img, 3)
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
