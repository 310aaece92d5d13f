"""The benchmark's DeepSDF decoder: the canonical 8 x 512 latent-in MLP
fitted to spheres, in plain PyTorch.

A frozen copy of the sphere fit of dspslam_tpu_torch/models/deepsdf_train.py
(`fit_spheres`, `make_sphere_dataset`, `sdf_loss` at commit d92c068) and of
the reference's 600-step start-up fit in apps/benchmark_slam.py
(`train_bench_decoder`): He-normal weights, clamped-L1 SDF regression with
clamp 0.5 over spheres of radii 0.3 .. 0.7, Adam at 5e-4. The weights are
drawn on the device in one call, so the GN runs on trained weights and
converges to checkable geometry. The result is handed to the port as plain
tensors; the port's trainer is not used.

The fitted decoder stands for the configuration's trained DeepSDF prior (a
checkpoint in the source), so it is one decoder for every run seed: fitted
from `FIT_SEED` on a checkout's first run and kept in
benchmark/.cache/fits/, keyed by the decoder's sizes, the steps, the seed
and the device type (`cached_fit`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .common import cache_path
from .flops import decoder_dims

FIT_SEED = 600_613


def he_normal_layers(dims, gen: torch.Generator, device) -> tuple[list, list]:
    """He-normal (out, in) weights from one draw of the generator, zero biases."""
    flat = torch.randn(sum(i * o for i, o in dims), generator=gen, device=device)
    ws, at = [], 0
    for i, o in dims:
        ws.append((flat[at:at + i * o].reshape(o, i) * float(np.sqrt(2.0 / i))).contiguous())
        at += i * o
    return ws, [torch.zeros(o, device=device) for _, o in dims]


def mlp(weights, biases, x, latent_in) -> torch.Tensor:
    inp, h = x, x
    last = len(weights) - 1
    for i, (w, b) in enumerate(zip(weights, biases)):
        if i in latent_in:
            h = torch.cat([h, inp], dim=-1)
        h = torch.nn.functional.linear(h, w, b)
        if i < last:
            h = torch.relu(h)
    return torch.tanh(h[..., 0])


def sphere_batch(gen: torch.Generator, num_shapes: int, n: int) -> dict:
    """Near-surface (even rows) and uniform (odd rows) samples of spheres of
    radii 0.3 + 0.1 k."""
    dev = gen.device
    d = torch.randn((n, 3), generator=gen, device=dev)
    shape_idx = torch.randint(0, num_shapes, (n,), generator=gen, device=dev)
    jitter = torch.randn((n, 3), generator=gen, device=dev)
    unif = torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0
    r = (0.3 + 0.1 * torch.arange(num_shapes, device=dev, dtype=torch.float32))[shape_idx]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
    even = (torch.arange(n, device=dev) % 2 == 0)[:, None]
    xyz = torch.where(even, d * r[:, None] + 0.08 * jitter, unif)
    return {"shape_idx": shape_idx, "xyz": xyz, "sdf": torch.linalg.vector_norm(xyz, dim=-1) - r}


def fit_spheres(decoder_cfg: dict, seed: int, device, steps: int = 600, batch: int = 8192,
                num_shapes: int = 5, lr: float = 5e-4, clamp: float = 0.5, code_reg: float = 1e-4):
    """Fit the configuration's decoder ({code_len, hidden, latent_in}) for
    `steps` Adam steps in float32 with TF32 off. Returns (weights, biases,
    final loss) as detached tensors on `device`."""
    latent_in = tuple(decoder_cfg["latent_in"])
    dims = decoder_dims(decoder_cfg["code_len"], decoder_cfg["hidden"], latent_in)
    gen = torch.Generator(device=device).manual_seed(seed)
    ws, bs = he_normal_layers(dims, gen, device)
    codes = 0.01 * torch.randn((num_shapes, decoder_cfg["code_len"]), generator=gen, device=device)
    params = [t.requires_grad_(True) for t in ws + bs + [codes]]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=True)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss = None
        for _ in range(steps):
            data = sphere_batch(gen, num_shapes, batch)
            code = codes[data["shape_idx"]]
            pred = mlp(ws, bs, torch.cat([code, data["xyz"]], dim=-1), latent_in)
            loss = (torch.mean(torch.abs(torch.clamp(pred, -clamp, clamp) - torch.clamp(data["sdf"], -clamp, clamp)))
                    + code_reg * torch.mean(torch.sum(code * code, dim=-1)))
            opt.zero_grad(set_to_none=False)
            loss.backward()
            opt.step()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return ([w.detach() for w in ws], [b.detach() for b in bs],
            float("nan") if loss is None else float(loss.detach()))


def cached_fit(decoder_cfg: dict, device, steps: int = 600) -> tuple[list, list, float, bool]:
    """`fit_spheres(decoder_cfg, FIT_SEED, device, steps)` from the cache,
    or fitted and stored. Returns (weights, biases, final loss, cache hit)."""
    key = {"decoder": {k: decoder_cfg[k] for k in ("code_len", "hidden", "latent_in")}, "steps": steps,
           "seed": FIT_SEED, "device": torch.device(device).type, "version": 1}
    path = cache_path(key, "fits", ".pt")
    if os.path.exists(path):
        blob = torch.load(path, map_location=device)
        return blob["weights"], blob["biases"], blob["loss"], True
    ws, bs, loss = fit_spheres(decoder_cfg, FIT_SEED, device, steps=steps)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"weights": [w.cpu() for w in ws], "biases": [b.cpu() for b in bs], "loss": loss}, tmp)
    os.replace(tmp, path)
    return ws, bs, loss, False
