"""The whole GN call's share of the card's peak, in %: the decoder
operations a call needs (forward over the render-grid samples inside the
unit ball, value and input gradient over the live surface and
render-Jacobian rows, as the reference counts them on the sampled calls)
times the calls, over the window's time, against 495 TFLOP/s (dense TF32,
the highest rate of f32-accurate arithmetic on the card). Calls and time
are those of the window's untraced part: the profiler slows the host."""

import numpy as np

from benchmark import flops


def read(run):
    cell = run.cell
    # a share of the card's peak exists only for a run on the card
    calls, seconds = len(run.untraced("gn_call")), run.untraced_s()
    if run.device.type != "cuda" or not getattr(cell, "grid_rows", None) or not calls or seconds <= 0:
        return None
    per_call = flops.gn_call_flops(run.config["decoder"], float(np.mean(cell.grid_rows)),
                                   float(np.mean(cell.grad_rows)))
    return 100.0 * per_call * calls / seconds / flops.PEAK_TF32_FLOPS
