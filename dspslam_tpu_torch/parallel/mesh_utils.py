"""Process groups and the (dp, tp) device mesh over `torch.distributed`.

Port of dspslam_tpu/parallel/mesh_utils.py. The JAX package lays work out
over a `jax.sharding.Mesh` and lets XLA insert the collectives; here the
mesh is a `torch.distributed.device_mesh.DeviceMesh` with one process per
device, and every collective is written out:

* ``dp``, data parallel: SDF sample batches (DeepSDF training), objects
  (the multi-object GN), voxel slabs (mesh extraction);
* ``tp``, tensor parallel: the decoder's hidden width
  (`parallel/tp_decoder.py`).

A group runs NCCL on the card and gloo on the CPU. `device=None` means the
card and raises without one; nothing falls back from one to the other.
"""

from __future__ import annotations

import contextlib
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..slam.map import entry_device
from .tp_decoder import TensorParallelDecoder


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(device=None, rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None, backend: str | None = None) -> torch.device:
    """Join (or open) the default process group; returns this rank's device.

    Under torchrun (`RANK` / `WORLD_SIZE` / `MASTER_ADDR` / `MASTER_PORT`
    set) the group comes from the environment; otherwise from `rank`,
    `world_size` and `init_method` (a one-rank group on a free loopback port
    when all three are None). `backend` None means NCCL on the card and gloo
    on the CPU. On the card the rank takes device `LOCAL_RANK` (else its
    rank modulo the device count). A group that is already open is kept."""
    device = entry_device(device, "init_group")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else os.environ.get("RANK", 0)))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ and init_method is None:
        dist.init_process_group(backend, init_method="env://")
        return device
    if init_method is None:
        if world_size not in (None, 1):
            raise ValueError("init_group: a group of several ranks needs init_method (or torchrun's environment)")
        init_method, rank, world_size = f"tcp://127.0.0.1:{_free_port()}", 0, 1
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return device


@contextlib.contextmanager
def process_group(device=None, **kwargs):
    """`init_group` for the length of a `with` block; a group this call
    opened is destroyed at its end, one that was open already is left."""
    opened = not dist.is_initialized()
    try:
        yield init_group(device, **kwargs)
    finally:
        if opened and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(n_devices: int | None = None, tp: int | None = None, device=None) -> DeviceMesh:
    """A (dp, tp) mesh over the group's ranks (opened with `init_group` if
    none is open). tp defaults to 2 when the rank count is even (and > 1),
    else 1, as in the JAX package."""
    device = init_group(device)
    n = dist.get_world_size()
    if n_devices not in (None, n):
        raise ValueError(f"make_mesh: the group has {n} ranks, not {n_devices}")
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if n % tp:
        raise ValueError(f"make_mesh: {n} ranks do not split into tp = {tp}")
    return init_device_mesh(device.type, (n // tp, tp), mesh_dim_names=("dp", "tp"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicate_(tensors, mesh: DeviceMesh):
    """Broadcast `tensors` in place from the mesh's first rank: every rank
    then holds the first rank's values."""
    src = int(mesh.mesh.flatten()[0])
    for t in tensors:
        dist.broadcast(t.data, src=src)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """All-gather each rank's rows of `t` along dim 0, in rank order (bool
    tensors travel as uint8)."""
    send = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out


def decoder_param_sharding(mesh: DeviceMesh, decoder):
    """The decoder tensor-parallel over the mesh's `tp` axis (JAX's
    per-weight `PartitionSpec` choice becomes Megatron column / row pairs,
    see `tp_decoder.TensorParallelDecoder`)."""
    return TensorParallelDecoder(decoder, mesh.get_group("tp"))


def batch_sharding(mesh: DeviceMesh):
    """fn(batch dict) -> this dp rank's rows of every tensor. Raises when a
    tensor's dim 0 does not divide by dp (JAX's `P("dp")` refuses an uneven
    split too)."""
    dp, r = mesh.size(0), mesh.get_local_rank("dp")

    def rows(name, v: torch.Tensor) -> torch.Tensor:
        if v.shape[0] % dp:
            raise ValueError(f"batch_sharding: {name} has {v.shape[0]} rows, not a multiple of dp = {dp}")
        n = v.shape[0] // dp
        return v[r * n:(r + 1) * n]

    return lambda batch: {k: rows(k, v) for k, v in batch.items()}


def sharded_object_gn(mesh: DeviceMesh, batched_recon, decoder, *batch_args):
    """The per-keyframe multi-object GN with the object batch split over dp.

    `batched_recon` is `shape.gn.batched_reconstruct(decoder, config)`;
    `decoder`'s weights are replicated from the mesh's first rank, each dp
    rank reconstructs its B / dp objects (kernel K1 on the card), and the
    results are all-gathered in object order. Objects are independent, so
    the GN loop itself runs no collective."""
    replicate_(list(decoder.parameters()) + list(decoder.buffers()), mesh)
    shard = batch_sharding(mesh)(dict(enumerate(batch_args)))
    out = batched_recon(*shard.values())
    group = mesh.get_group("dp")
    return {k: gather_rows(v, group) for k, v in out.items()}
