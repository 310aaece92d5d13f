"""Decode saved shape codes to meshes, the extract_map_objects.py equivalent.

Port of dspslam_tpu/apps/extract_map_objects.py. Reads a MapObjects.txt
(id / 3x4 Sim(3) T_wo row / code row triplets, System_util.cc:122-146
format), re-decodes each code on a voxel grid with the configured decoder
and writes per-object `<id>.ply` meshes plus `<id>_pose.npy` Sim(3) poses,
the reference tool's outputs (extract_map_objects.py:33-63).

    python -m dspslam_tpu_torch.apps.extract_map_objects \\
        --map_dir out/map --config configs/config_kitti.json \\
        [--voxels_dim 128] [--device cpu]

`--device` defaults to cuda; asking for cuda without a card is an error.
`--shard` splits each object's voxel decode over the dp ranks of a
`make_mesh(tp=1)` mesh (every process of a torchrun world, or one rank
without torchrun; NCCL on the card, gloo with `--device cpu`); rank 0 runs
marching tetrahedra and writes the files.

    torchrun --nproc_per_node 2 -m dspslam_tpu_torch.apps.extract_map_objects \\
        --map_dir out/map --config configs/config_kitti.json --shard
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch.distributed as dist

from .. import config as cfg_mod
from ..parallel import mesh_utils
from ..shape import mesh as mesh_mod
from ..utils import io as io_mod
from .reconstruct_frame import get_decoder, resolve_device


def load_map_objects(path: str):
    """Parse MapObjects.txt -> list of (id, Two (4, 4), code (L,))."""
    with open(path) as f:
        lines = [line.strip() for line in f if line.strip()]
    out = []
    for i in range(0, len(lines) - 2, 3):
        Two = np.eye(4, dtype=np.float32)
        Two[:3, :] = np.array(lines[i + 1].split(), np.float64).reshape(3, 4)
        code = np.array(lines[i + 2].split(), np.float64).astype(np.float32)
        out.append((int(lines[i]), Two, code))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--map_dir", required=True)
    p.add_argument("--config")
    p.add_argument("--voxels_dim", type=int, default=64)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--shard", action="store_true",
                   help="split the voxel-grid decode over the torchrun world's dp ranks")
    args = p.parse_args(argv)
    if args.shard:
        with mesh_utils.process_group(args.device) as device:
            return extract(args, device, mesh_utils.make_mesh(tp=1, device=device))
    return extract(args, resolve_device(args.device), None)


def extract(args, device, mesh):
    """Decode every object of the map on `device`, split over `mesh`'s dp
    ranks when one is given; rank 0 writes the meshes and poses. Returns
    (objects, meshes written by this rank)."""
    lead = mesh is None or dist.get_rank() == 0
    system_cfg = cfg_mod.SystemConfig.load(args.config) if args.config else cfg_mod.SystemConfig()
    decoder = get_decoder(system_cfg, device)
    out_dir = args.output_dir or os.path.join(args.map_dir, "meshes")
    if lead:
        os.makedirs(out_dir, exist_ok=True)

    objs = load_map_objects(os.path.join(args.map_dir, "MapObjects.txt"))
    extractor = mesh_mod.MeshExtractor(decoder, code_len=system_cfg.optimizer.code_len,
                                       voxels_dim=args.voxels_dim, device=device, mesh=mesh)
    meshes = {}
    for obj_id, Two, code in objs:
        handle = extractor.dispatch(code)
        if not lead:
            continue
        m = extractor.collect(handle)
        io_mod.write_mesh_ply(m["vertices"], m["faces"], os.path.join(out_dir, f"{obj_id}.ply"))
        np.save(os.path.join(out_dir, f"{obj_id}_pose.npy"), Two)
        meshes[obj_id] = m
        print(f"object {obj_id}: {len(m['vertices'])} verts -> {out_dir}")
    return objs, meshes


if __name__ == "__main__":
    main()
