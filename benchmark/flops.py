"""Operation counts of the decoder's work, and the card's peak.

Counted from the algorithm's shapes, once, whatever implements it: a
product of an (n, i) by an (i, o) matrix is 2 n i o operations. The
decoder's input gradient runs the same products backward (the last layer's
scalar output and the ReLU masks add no products), so the value plus the
input gradient costs twice the forward. Biases, activations and the
re-joined input add no products and are not counted. Implementation
overheads (3xTF32's three products per product, padding rows) are not
counted either.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the full 700 W limit
PEAK_TF32_FLOPS = 495e12       # the highest rate of f32-accurate arithmetic on the card


def decoder_dims(code_len: int, hidden, latent_in) -> list[tuple[int, int]]:
    """(fan_in, fan_out) of each linear layer (DeepSDF's layout)."""
    in_dim = code_len + 3
    dims = [in_dim] + list(hidden) + [1]
    return [(dims[i], dims[i + 1] - (in_dim if (i + 1) in latent_in else 0)) for i in range(len(dims) - 1)]


def forward_flops_per_row(code_len: int, hidden, latent_in) -> float:
    """Operations of one row's forward pass."""
    return float(sum(2 * i * o for i, o in decoder_dims(code_len, hidden, latent_in)))


def value_and_grad_flops_per_row(code_len: int, hidden, latent_in) -> float:
    """Operations of one row's value and input gradient (kernel K1's work)."""
    return 2.0 * forward_flops_per_row(code_len, hidden, latent_in)


def gn_call_flops(decoder: dict, n_grid_rows: float, n_grad_rows: float) -> float:
    """A GN call's decoder operations: forward over the render-grid rows that
    the algorithm evaluates, value and input gradient over the surface and
    render-Jacobian rows (both summed over iterations)."""
    dec = (decoder["code_len"], decoder["hidden"], tuple(decoder["latent_in"]))
    return n_grid_rows * forward_flops_per_row(*dec) + n_grad_rows * value_and_grad_flops_per_row(*dec)
