"""Fixed-K greedy NMS over a precomputed overlap matrix: a CUDA kernel and
its plain version.

`greedy_suppress(iou, scores, k, iou_thresh, dead, keep_thresh,
keep_inclusive)` runs k rounds of "take the best live candidate (the
first among equal scores), drop those that overlap it above iou_thresh":
each round masks the dead candidates to `dead`, picks the argmax, keeps
the pick if its score is above `keep_thresh` (at or above with
`keep_inclusive`), and only a kept pick suppresses; the pick's own slot
dies in every round. It returns (picked indices (k,) int64, their scores
(k,) f32, ok (k,) bool). Mask R-CNN's RPN and R-CNN (`detect/maskrcnn.py`)
and PointPillars (`detect/pointpillars.py`) call it; this is the loop of
dspslam_tpu/detect/maskrcnn.py `greedy_nms` and pointpillars.py
`select_detections`.

On CUDA tensors the wrapper launches the hand-written kernel in
`csrc/greedy_nms.cu` (built by `kernels/_nvcc.py` on first use) once per
call, on the current stream, with no host sync; it takes up to `MAX_N`
candidates and raises above. There is no fallback. On CPU tensors it runs
`greedy_suppress_plain`, the eager loop of ~9 PyTorch ops a round, which
the tests and the card tests hold the kernel to, round for round. Each
launch adds 1 to the process-wide counter `nms_launches`
(`utils.timing.count`).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import timing
from . import _nvcc

# the most candidates one launch takes (csrc/greedy_nms.cu's MAX_N, which refuses more)
MAX_N = 8192

_lib = None


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    return _nvcc.build("greedy_nms")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _nvcc.load("greedy_nms")
        lib.dsp_greedy_nms.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.dsp_greedy_nms.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(iou: torch.Tensor, scores: torch.Tensor, k: int):
    """Raise unless the kernel takes these inputs: `scores` f32 (n,) with
    1 <= n <= MAX_N, `iou` f32 (n, n), both contiguous on one device, k >= 1."""
    if scores.dtype != torch.float32 or scores.dim() != 1:
        raise ValueError(f"greedy_nms: scores must be float32 (n,), got {scores.dtype} {tuple(scores.shape)}")
    n = scores.shape[0]
    if iou.dtype != torch.float32 or tuple(iou.shape) != (n, n):
        raise ValueError(f"greedy_nms: iou must be float32 ({n}, {n}), got {iou.dtype} {tuple(iou.shape)}")
    if not (iou.is_contiguous() and scores.is_contiguous()):
        raise ValueError("greedy_nms: iou and scores must be contiguous")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"greedy_nms: {n} candidates, the kernel takes 1 to {MAX_N}")
    if k < 1:
        raise ValueError(f"greedy_nms: k must be at least 1, got {k}")
    if iou.device != scores.device:
        raise ValueError(f"greedy_nms: iou on {iou.device}, scores on {scores.device}")


def greedy_suppress(iou: torch.Tensor, scores: torch.Tensor, k: int, iou_thresh: float, dead: float,
                    keep_thresh: float, keep_inclusive: bool = False):
    """k greedy NMS rounds -> (picks (k,) int64, scores (k,), ok (k,) bool).
    CPU tensors take the plain loop; CUDA tensors one kernel launch."""
    if scores.device.type == "cpu":
        return greedy_suppress_plain(iou, scores, k, iou_thresh, dead, keep_thresh, keep_inclusive)
    check(iou, scores, k)
    if scores.device.type != "cuda":
        raise ValueError(f"greedy_nms: tensors must be on a CUDA device or the CPU, got {scores.device}")
    picks = torch.empty((k,), dtype=torch.int64, device=scores.device)
    vals = torch.empty((k,), dtype=torch.float32, device=scores.device)
    ok = torch.empty((k,), dtype=torch.bool, device=scores.device)
    with torch.cuda.device(scores.device):
        err = _library().dsp_greedy_nms(
            iou.data_ptr(), scores.data_ptr(), scores.shape[0], k, float(iou_thresh), float(dead),
            float(keep_thresh), int(bool(keep_inclusive)), picks.data_ptr(), vals.data_ptr(),
            ok.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"greedy_nms: kernel launch failed, CUDA error {err}")
    timing.count("nms_launches")
    return picks, vals, ok


def greedy_suppress_plain(iou: torch.Tensor, scores: torch.Tensor, k: int, iou_thresh: float,
                          dead: float, keep_thresh: float, keep_inclusive: bool = False):
    """The plain version: k eager rounds over device tensors, sync-free
    (every index stays on the device)."""
    alive = torch.ones_like(scores)
    picks, vals, oks = [], [], []
    for _ in range(k):
        masked = torch.where(alive > 0, scores, dead)
        j = torch.argmax(masked, dim=0, keepdim=True)
        s = masked.gather(0, j)
        ok = s >= keep_thresh if keep_inclusive else s > keep_thresh
        suppress = ok & (iou.index_select(0, j)[0] > iou_thresh)
        alive = torch.where(suppress, 0.0, alive).scatter(0, j, 0.0)
        picks.append(j)
        vals.append(s)
        oks.append(ok)
    return torch.cat(picks), torch.cat(vals), torch.cat(oks)
