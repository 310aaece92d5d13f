"""Rounding a float32 tensor to fewer mantissa bits (round to nearest, ties
to even), for the detectors' precision control: 7 stored bits are
bfloat16's, 10 TF32's; the control of the bf16 backbones keeps 4, one
precision below bfloat16."""

from __future__ import annotations

import torch


def mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """`t` as float32 with only `bits` of its 23 stored mantissa bits."""
    drop = 23 - bits
    i = t.detach().float().contiguous().view(torch.int32)
    i = (i + ((1 << (drop - 1)) - 1) + ((i >> drop) & 1)) & ~((1 << drop) - 1)
    return i.view(torch.float32)


class Precision:
    """How a reference computes its products: `operand` rounds each
    product's inputs (activations and weights), `result` each layer's
    output. The default is plain float32."""

    def __init__(self, operand_bits: int | None = None, result_bits: int | None = None):
        self.operand_bits, self.result_bits = operand_bits, result_bits

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.operand_bits is None else mantissa(t, self.operand_bits)

    def result(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.result_bits is None else mantissa(t, self.result_bits)


F32 = Precision()
TF32 = Precision(operand_bits=10)              # the tensor cores' f32 path
BELOW_BF16 = Precision(operand_bits=4, result_bits=4)   # bf16's layers with 4 mantissa bits
