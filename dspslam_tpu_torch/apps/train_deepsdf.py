"""Train a DeepSDF shape prior, the trainer the reference assumes (it
consumes pretrained cars_64 / chairs_64 experiment dirs).

Port of dspslam_tpu/apps/train_deepsdf.py. Input: a directory of per-shape
SDF sample files (`<name>.npz` with `xyz (N, 3)` and `sdf (N,)`, the
standard DeepSDF preprocessed sample format), or `--synthetic` spheres.
Trains the auto-decoder on one device and writes a checkpoint
(`checkpoint.pt`), a reference-format experiment directory that either
package's `models.deepsdf.load_torch_checkpoint` (and the reference) can
load, and `latent_codes.npy`. `--device` defaults to cuda and raises
without a card. The JAX app's `(dp, tp)` device mesh is not ported.

    python -m dspslam_tpu_torch.apps.train_deepsdf --samples_dir sdf/ \\
        --out experiments/cars_64 [--steps 20000] [--code_len 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models import deepsdf, deepsdf_train
from ..slam.map import entry_device


def load_samples(samples_dir: str):
    files = sorted(f for f in os.listdir(samples_dir) if f.endswith(".npz"))
    xyz, sdf, idx = [], [], []
    for i, f in enumerate(files):
        z = np.load(os.path.join(samples_dir, f))
        xyz.append(np.asarray(z["xyz"], np.float32))
        sdf.append(np.asarray(z["sdf"], np.float32))
        idx.append(np.full(len(xyz[-1]), i, np.int64))
    return np.concatenate(xyz), np.concatenate(sdf), np.concatenate(idx), len(files)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--samples_dir")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", default="experiments/deepsdf")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--code_len", type=int, default=64)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.synthetic and not args.samples_dir:
        p.error("--samples_dir or --synthetic required")
    device = entry_device(args.device, "train_deepsdf")

    cfg = deepsdf.DecoderConfig(code_len=args.code_len, hidden=(args.hidden,) * args.layers,
                                latent_in=(args.layers // 2,))
    if args.synthetic:
        n_shapes = 8
        data = deepsdf_train.make_sphere_dataset(torch.Generator(device=device).manual_seed(args.seed),
                                                 n_shapes, 200000)
        xyz, sdf, idx = data["xyz"], data["sdf"], data["shape_idx"]
    else:
        xyz, sdf, idx, n_shapes = load_samples(args.samples_dir)
        xyz, sdf, idx = (torch.from_numpy(a).to(device) for a in (xyz, sdf, idx))
    print(f"{len(xyz)} samples over {n_shapes} shapes on {device}")

    state = deepsdf_train.init_state(cfg, n_shapes, args.seed, device, args.lr)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for step in range(args.steps):
        sel = torch.randint(0, len(xyz), (args.batch,), generator=gen, device=device)
        loss = deepsdf_train.train_step(state, {"xyz": xyz[sel], "sdf": sdf[sel], "shape_idx": idx[sel]})
        if step % 200 == 0:
            print(f"step {step}: loss {float(loss):.5f}")
    os.makedirs(args.out, exist_ok=True)
    deepsdf_train.save_checkpoint(state, os.path.join(args.out, "checkpoint.pt"))
    deepsdf_train.export_reference_format(state, args.out)
    np.save(os.path.join(args.out, "latent_codes.npy"), state.codes.detach().cpu().numpy())
    print(f"exported {args.out}")
    return state


if __name__ == "__main__":
    main()
