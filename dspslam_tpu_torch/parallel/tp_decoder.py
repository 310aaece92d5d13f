"""The DeepSDF decoder tensor-parallel over a process group (the mesh's
`tp` axis).

Counterpart of dspslam_tpu/parallel/mesh_utils.decoder_param_sharding.
There XLA picks the collectives from per-weight `PartitionSpec`s; here they
are explicit, Megatron-style. Linear layers go in pairs:

* a column-parallel layer: each rank holds a slice of the output rows of
  W and b, and computes its slice of the activations; a copy-to-tp
  (identity forward, all-reduce of the input gradient backward) stands in
  front of it;
* a row-parallel layer: each rank holds the matching slice of W's input
  columns, its partial products are summed by one all-reduce (identity
  backward), and the bias is added once after it.

Pairs are taken from the first layer on. A layer whose input is a latent
re-injection concat (`latent_in`) starts a new pair, so the layer before it
cannot start one; a layer left unpaired runs replicated, as the 1-wide
head always does. The module
computes the full decoder's function, and its weights train with Adam
shard by shard. `gather_decoder` puts the full `DeepSDFDecoder` back
together on every rank: checkpoints, export, the GN and mesh extraction
take that one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..models import deepsdf

REPLICATED, COLUMN, ROW = "replicated", "column", "row"


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the input gradient is all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def layer_kinds(config: deepsdf.DecoderConfig, tp: int) -> list[str]:
    """REPLICATED, COLUMN or ROW for each linear layer of `config` over tp
    ranks. At tp = 1 nothing is split: every layer runs replicated, in the
    full decoder's arithmetic."""
    n = len(config.layer_dims())
    kinds = [REPLICATED] * n
    layer = 0
    while tp > 1 and layer + 1 < n - 1:               # the head stays replicated
        if (layer + 1) in config.latent_in:           # the concat starts a new pair
            layer += 1
            continue
        kinds[layer], kinds[layer + 1] = COLUMN, ROW
        layer += 2
    return kinds


def _split(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


class TensorParallelDecoder(nn.Module):
    """`decoder`'s function with its hidden widths split over `group`.
    Raises when a column-split width does not divide by the group's size."""

    def __init__(self, decoder: deepsdf.DeepSDFDecoder, group):
        super().__init__()
        self.config = decoder.config
        self.group = group
        size = dist.get_world_size(group)
        self.kinds = layer_kinds(decoder.config, size)
        for layer, (w, kind) in enumerate(zip(decoder.weights, self.kinds)):
            if kind == COLUMN and w.shape[0] % size:
                raise ValueError(f"layer {layer}'s {w.shape[0]} outputs do not split over tp = {size}")
        ws, bs = self.shard(decoder.weights, decoder.biases)
        self.weights = nn.ParameterList(nn.Parameter(w) for w in ws)
        self.biases = nn.ParameterList(nn.Parameter(b) for b in bs)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """The full decoder's function at its config's compute dtype and
        matmul precision (`deepsdf.mlp`), each layer split by its kind."""
        cdt = self.config.compute_dtype

        def layer_fn(layer, x, w, b):
            kind = self.kinds[layer]
            if kind == COLUMN:
                return deepsdf.linear(_CopyToTP.apply(x, self.group), w, b, cdt)
            if kind == ROW:
                return _ReduceFromTP.apply(deepsdf.linear(x, w, None, cdt), self.group) + b
            return deepsdf.linear(x, w, b, cdt)

        with deepsdf.matmul_precision_scope(self.config.matmul_precision):
            return deepsdf.mlp(self.config, self.weights, self.biases, inputs, layer_fn)

    def shard(self, weights, biases) -> tuple[list, list]:
        """This rank's slices of full tensors laid out as the decoder's
        weights and biases (the weights themselves or Adam's moments)."""
        size, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        ws, bs = [], []
        for w, b, kind in zip(weights, biases, self.kinds):
            if kind == COLUMN:
                w, b = _split(w, 0, rank, size), _split(b, 0, rank, size)
            elif kind == ROW:
                w = _split(w, 1, rank, size)
            ws.append(w.detach().clone())
            bs.append(b.detach().clone())
        return ws, bs

    def gather(self, weights, biases) -> tuple[list, list]:
        """Full tensors from per-rank slices laid out as this module's
        weights and biases (the weights themselves, their gradients or
        Adam's moments)."""
        ws, bs = [], []
        for w, b, kind in zip(weights, biases, self.kinds):
            if kind == COLUMN:
                w, b = _all_gather_cat(w, 0, self.group), _all_gather_cat(b, 0, self.group)
            elif kind == ROW:
                w = _all_gather_cat(w, 1, self.group)
            ws.append(w.detach().clone())
            bs.append(b.detach().clone())
        return ws, bs


def _all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_decoder(tp_decoder: TensorParallelDecoder) -> deepsdf.DeepSDFDecoder:
    """The full decoder (weights that do not require grad) on every rank."""
    ws, bs = tp_decoder.gather(tp_decoder.weights, tp_decoder.biases)
    return deepsdf.DeepSDFDecoder(tp_decoder.config, ws, bs)
