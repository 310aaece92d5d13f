"""Multi-rank runs of the sharded paths: `spawn`, the dry run and the
parity cases.

`dryrun_multichip` is the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`: in `n_ranks` processes it runs one
sharded DeepSDF training step at that dry run's tiny shapes, the sharded
voxel decode with the sphere decoder (vol 17, tp = 1) and the sharded
object GN with the sphere decoder (B = n_ranks), and raises on a failed
rank or a non-finite value.

`run_cases` is a rank's side of a parity run: it reads inputs that the
caller saved, runs the sharded paths on them and saves what they give, so
that the caller can hold them against the one-process paths.

    python -c "from dspslam_tpu_torch.parallel import dryrun; dryrun.dryrun_multichip(4, device='cpu')"

The functions here are what spawned processes import by name, so this
module imports nothing beyond torch and the port.
"""

from __future__ import annotations

import importlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..models import deepsdf, deepsdf_train
from ..shape import gn, mesh as mesh_mod
from ..slam.map import entry_device
from ..utils import timing
from . import mesh_utils


def _rank_main(rank: int, n_ranks: int, init_method: str, device: str, backend, fn, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n_ranks))
    if device == "cpu":
        torch.set_num_threads(1)            # n ranks share one host's cores
    with mesh_utils.process_group(device, rank=rank, world_size=n_ranks, init_method=init_method,
                                  backend=backend):
        fn(*args)


SPAWN_TIMEOUT_S = 300.0       # the dry run and the parity runs take well under a minute


def spawn(fn, n_ranks: int, *args, device=None, backend: str | None = None):
    """Run `fn(*args)` in `n_ranks` processes that form one process group
    (a file rendezvous in a temporary directory), with torchrun's RANK,
    LOCAL_RANK and WORLD_SIZE set (rank r on device `cuda:r % count`, or the
    CPU). `backend` None means NCCL on the card and gloo on the CPU. Raises
    when a rank fails, and kills the ranks when they have not finished
    within SPAWN_TIMEOUT_S seconds (a rank that waits in a collective for
    one that died would otherwise hold its caller)."""
    device = entry_device(device, "spawn")
    with tempfile.TemporaryDirectory() as rendezvous:
        init_method = f"file://{os.path.join(rendezvous, 'store')}"
        ctx = mp.spawn(_rank_main, args=(n_ranks, init_method, device.type, backend, fn, args),
                       nprocs=n_ranks, join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"spawn: {n_ranks} ranks of {fn.__name__} did not finish in {SPAWN_TIMEOUT_S} s")


# ---------------------------------------------------------------------------
# The dry run


def _check_finite(t: torch.Tensor, what: str):
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError(f"dryrun_multichip: {what} is not finite on rank {dist.get_rank()}")


def gn_inputs(B: int, P: int, R: int, code_len: int, seed: int = 0) -> list[np.ndarray]:
    """The JAX dry run's GN inputs: B objects at z = 8 m, scale 2, surface
    points on a unit sphere around them, rays around the optical axis."""
    rng = np.random.default_rng(seed)
    t = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    t[:, :3, :3] *= 2.0
    t[:, 2, 3] = 8.0
    dirs = rng.normal(size=(B, P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return [t, (dirs + np.array([0, 0, 8.0])).astype(np.float32), np.ones((B, P), np.float32),
            (rng.normal(0, 0.05, (B, R, 3)) + np.array([0, 0, 1.0])).astype(np.float32),
            np.ones((B, R), np.float32), np.full((B, R), 8.0, np.float32), np.ones((B, R), np.float32),
            np.zeros((B, code_len), np.float32)]


def _dryrun_rank(device: str):
    dev = mesh_utils.init_group(device)
    n = dist.get_world_size()
    cfg = deepsdf.DecoderConfig(code_len=8, hidden=(64, 64, 64, 64), latent_in=(2,))
    state = deepsdf_train.shard_state(deepsdf_train.init_state(cfg, 4, seed=0, device=dev),
                                      mesh_utils.make_mesh(device=dev))
    batch = deepsdf_train.make_sphere_dataset(torch.Generator(device=dev).manual_seed(1), 4, 16 * n)
    _check_finite(deepsdf_train.train_step(state, batch), "the sharded train step's loss")

    dp_mesh = mesh_utils.make_mesh(tp=1, device=dev)
    sphere = deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=8, device=dev))
    _check_finite(mesh_mod.decode_sdf_grid_sharded(sphere, torch.zeros(8, device=dev), 17, dp_mesh),
                  "the sharded grid decode")

    recon = gn.batched_reconstruct(sphere, gn.GNConfig(code_len=8, num_iterations=1, num_depth_samples=8,
                                                       max_grad_points=64))
    args = [torch.from_numpy(a).to(dev) for a in gn_inputs(n, 32, 32, 8)]
    _check_finite(mesh_utils.sharded_object_gn(dp_mesh, recon, sphere, *args)["loss"], "the sharded GN's loss")


def dryrun_multichip(n_ranks: int, device=None):
    """The three sharded paths in `n_ranks` processes; raises on a failed
    rank or a non-finite value. `device` None means the card (NCCL)."""
    device = entry_device(device, "dryrun_multichip")
    spawn(_dryrun_rank, n_ranks, device.type, device=device)


# ---------------------------------------------------------------------------
# Parity cases: inputs saved by the caller, results saved per rank


def _decoder(spec: dict, dev: torch.device):
    """{'sphere': code_len} or {'config': DecoderConfig fields, 'weights',
    'biases'} (nn.Linear layout) as a decoder on `dev`."""
    if "sphere" in spec:
        return deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=spec["sphere"], device=dev))
    config = deepsdf.DecoderConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in spec["config"].items()})
    return deepsdf.DeepSDFDecoder(config, spec["weights"], spec["biases"]).to(dev)


def _cpu(ts) -> list:
    """Host copies (a CPU tensor's .cpu() is the tensor itself, which later
    steps overwrite)."""
    return [t.detach().to("cpu", copy=True) for t in ts]


def _case_mesh(case, dev):
    return {"default": tuple(mesh_utils.make_mesh(device=dev).shape),
            "tp1": tuple(mesh_utils.make_mesh(tp=1, device=dev).shape)}


def _case_tp_decoder(case, dev):
    """Forward and input gradient of each decoder made tensor-parallel."""
    mesh = mesh_utils.make_mesh(tp=case["tp"], device=dev)
    out = []
    for spec in case["decoders"]:
        tp = mesh_utils.decoder_param_sharding(mesh, _decoder(spec, dev))
        x = spec["inputs"].to(dev).requires_grad_(True)
        sdf = tp(x)
        (grad,) = torch.autograd.grad(sdf.sum(), x)
        out.append({"sdf": sdf.detach().cpu(), "grad": grad.cpu()})
    return out


def _case_train(case, dev):
    """Train steps from one state over case['batches']: the first `warm`
    unsharded, then sharded on a (dp, tp = case['tp']) mesh, the last
    `tail` on the gathered state. The loss of each step, the gradients of
    the first sharded step and the parameters after it, the parameters at
    the end; rank 0 saves the gathered state's checkpoint and export under
    case['export_dir'] when one is given."""
    state = deepsdf_train.state_from(_decoder(case["decoder"], dev), case["codes"].to(dev), case["lr"])
    batches = [{k: v.to(dev) for k, v in b.items()} for b in case["batches"]]
    warm, tail = case.get("warm", 0), case.get("tail", 0)
    out = {"losses": []}

    def step(state, batch):
        out["losses"].append(float(deepsdf_train.train_step(state, batch, clamp=case["clamp"])))

    for batch in batches[:warm]:
        step(state, batch)
    state = deepsdf_train.shard_state(state, mesh_utils.make_mesh(tp=case["tp"], device=dev))
    out["mesh"] = tuple(state.mesh.shape)
    for i, batch in enumerate(batches[warm:len(batches) - tail]):
        step(state, batch)
        if i == 0:
            ws, bs = state.decoder.gather([w.grad for w in state.decoder.weights],
                                          [b.grad for b in state.decoder.biases])
            out["grads"] = _cpu(ws + bs + [state.codes.grad])
            full = deepsdf_train.gather_state(state)
            out["params_first"] = _cpu(list(full.decoder.parameters()) + [full.codes])
    state = deepsdf_train.gather_state(state)
    for batch in batches[len(batches) - tail:]:
        step(state, batch)
    out["params"] = _cpu(list(state.decoder.parameters()) + [state.codes])
    if case.get("export_dir") and dist.get_rank() == 0:
        deepsdf_train.save_checkpoint(state, os.path.join(case["export_dir"], "checkpoint.pt"))
        deepsdf_train.export_reference_format(state, case["export_dir"])
    return out


def _case_decode(case, dev):
    """The sharded voxel decode, and a mesh through MeshExtractor(mesh=)."""
    mesh = mesh_utils.make_mesh(tp=1, device=dev)
    decoder = _decoder(case["decoder"], dev)
    code = case["code"].to(dev)
    sdf = mesh_mod.decode_sdf_grid_sharded(decoder, code, case["vol"], mesh)
    ex = mesh_mod.MeshExtractor(decoder, code_len=len(code), voxels_dim=case["extract_vol"], device=dev, mesh=mesh)
    m = ex.extract_mesh_from_code(case["extract_code"])
    return {"sdf": sdf.cpu(), "vertices": torch.from_numpy(m["vertices"])}


def _case_gn(case, dev):
    """sharded_object_gn on a (dp, tp = case['tp']) mesh, and the K1
    launches this rank made in it."""
    mesh = mesh_utils.make_mesh(tp=case["tp"], device=dev)
    decoder = _decoder(case["decoder"], dev)
    recon = gn.batched_reconstruct(decoder, gn.GNConfig(**case["gn_config"]))
    args = [a.to(dev) for a in case["args"]]
    before = timing.totals().get("k1_launches", 0)
    out = mesh_utils.sharded_object_gn(mesh, recon, decoder, *args)
    return {**{k: v.cpu() for k, v in out.items()}, "k1_launches": timing.totals().get("k1_launches", 0) - before}


def _case_apps(case, dev):
    """Each (module, argv) app's main, in the open group."""
    for module, argv in case:
        importlib.import_module(module).main(argv)
    return None


CASES = {"mesh": _case_mesh, "tp_decoder": _case_tp_decoder, "train": _case_train, "decode": _case_decode,
         "gn": _case_gn, "apps": _case_apps}


def run_cases(spec_path: str, out_dir: str, device: str):
    """A rank's side of a parity run: the cases saved in `spec_path`
    (torch.save of {name: inputs}; a name is a key of CASES, optionally
    followed by ':' and a label) in the open group, each rank's results
    saved as `out_dir/rank<r>.pt`."""
    dev = mesh_utils.init_group(device)
    spec = torch.load(spec_path, weights_only=True)
    out = {name: CASES[name.split(":")[0]](case, dev) for name, case in spec.items()}
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
