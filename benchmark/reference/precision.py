"""TF32 rounding, for the controls: a float32 tensor with its mantissa cut
to TF32's 10 bits (round to nearest, ties to even), as the tensor cores
read a float32 operand."""

from __future__ import annotations

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.detach().float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)
