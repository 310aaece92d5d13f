"""Kernel K1's share of its roofline, in %: the least time its work needs
(each launch's rows times the canonical decoder's value-and-input-gradient
operations, at the dense TF32 peak of 495 TFLOP/s) over its device time in
the trace. K1's launches are the kernels named `decoder_fused*`; a GN call
makes them in a fixed order (per iteration the B P surface rows, then the
B K render-Jacobian rows), from which each launch's rows are taken."""

from benchmark import flops


def read(run):
    trace, cell = run.trace, run.cell
    if trace is None or not hasattr(cell, "k1_rows_per_call"):
        return None
    k1 = [(a, b) for name, a, b in trace.events if "decoder_fused" in name and a >= trace.t0]
    if not k1:
        return None
    rows = cell.k1_rows_per_call()
    d = run.config["decoder"]
    per_row = flops.value_and_grad_flops_per_row(d["code_len"], d["hidden"], tuple(d["latent_in"]))
    work = sum(rows[i % len(rows)] for i in range(len(k1))) * per_row
    device_s = sum(b - a for a, b in k1)
    return 100.0 * (work / flops.PEAK_TF32_FLOPS) / device_s
