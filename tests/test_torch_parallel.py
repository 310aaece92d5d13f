"""The port's (dp, tp) mesh (dspslam_tpu_torch/parallel/, the sharded
train_step, decode_sdf_grid_sharded, sharded_object_gn and the two apps'
multi-rank paths) on the CPU, in gloo groups of 2 and 4 ranks spawned from
this module, against the port's one-process paths and the JAX package's
mesh on its 8 virtual CPU devices (tests/conftest.py).

Each world size is spawned once per module: its ranks run every case of
`parallel.dryrun.run_cases` from inputs this module saves (numpy-seeded, the
decoders from JAX `init_params` / `init_state` through `params_from_jax`)
and save their results, which the tests below read.

Tolerances: the tensor-parallel decoder's forward and input gradient within
1e-6; sharded train steps against the one-process `train_step` with the
loss within 1e-6 relative, gradients within 1e-5 of each tensor's largest
entry and parameters within 1e-6, and against JAX's sharded `train_step`
with the loss at JAX's own rtol of 1e-4 (test_parallel.py); the sharded
decode within 1e-6; the sharded GN equal to the port's unsharded GN, and
within JAX's tolerances of JAX's sharded GN (`t_cam_obj` 2e-4, loss 1e-4,
test_parallel.py) without the rotation prior (see GN_CASES); checkpoints
and exports within 1e-6; the two-rank app outputs within 1e-5 of the
one-process run's, the sharded meshes equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu.models import deepsdf_train as jdt
from dspslam_tpu.parallel import mesh_utils as jmu
from dspslam_tpu.shape import gn as jgn
from dspslam_tpu.shape import mesh as jmesh
from dspslam_tpu_torch.apps import extract_map_objects, train_deepsdf
from dspslam_tpu_torch.models import deepsdf, deepsdf_train as tdt
from dspslam_tpu_torch.parallel import dryrun, mesh_utils, tp_decoder
from dspslam_tpu_torch.shape import gn, mesh as mesh_mod
from dspslam_tpu_torch.utils.io import read_mesh_ply
from torch_threads import one_torch_thread  # noqa: F401

PLAIN = dict(code_len=8, hidden=(64, 64, 64), latent_in=())        # JAX's test_parallel config
LATENT = dict(code_len=8, hidden=(64,) * 4, latent_in=(2,))        # JAX's dry run config
N_SHAPES = 4
LR = 1e-3
GN_CFG = dict(code_len=8, num_iterations=2, num_depth_samples=8, max_grad_points=64)   # JAX's test_parallel
# The port and JAX agree within 1.1e-6 in t_cam_obj after one GN iteration on
# these inputs, but the rotation prior (k4 = 1e7) amplifies f32 rounding on a
# sphere, whose rotation only the prior holds: after two they are up to 1.02
# apart, as ROADMAP's parity record has it for the GN. So JAX is held to the
# port at k4 = 0, and the sharded port to the unsharded port in both.
GN_CASES = {"gn": GN_CFG, "gn:no_rotation_prior": dict(GN_CFG, k4=0.0)}
TRAIN_APP = ["--synthetic", "--steps", "3", "--batch", "256", "--code_len", "8", "--hidden", "64", "--layers", "4",
             "--device", "cpu"]


def jax_params(cfg: dict, seed: int) -> dict:
    return jax.tree_util.tree_map(np.asarray, jdeepsdf.init_params(jdeepsdf.DecoderConfig(**cfg),
                                                                    jax.random.PRNGKey(seed)))


def decoder_spec(cfg: dict, params_np: dict) -> dict:
    dec = deepsdf.params_from_jax(params_np, deepsdf.DecoderConfig(**cfg))
    return {"config": dataclasses.asdict(dec.config), "weights": [w.detach() for w in dec.weights],
            "biases": [b.detach() for b in dec.biases]}


def batch_np(seed: int, n: int = 256) -> dict:
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    idx = rng.integers(0, N_SHAPES, n).astype(np.int32)
    return {"shape_idx": idx, "xyz": xyz, "sdf": (np.linalg.norm(xyz, axis=-1) - (0.3 + 0.1 * idx)).astype(np.float32)}


def t_batch(b: dict) -> dict:
    return {"shape_idx": torch.from_numpy(b["shape_idx"].astype(np.int64)), "xyz": torch.from_numpy(b["xyz"]),
            "sdf": torch.from_numpy(b["sdf"])}


BATCHES = [batch_np(10 + i) for i in range(4)]


@pytest.fixture(scope="module")
def jax_state():
    """One JAX TrainState (LATENT config) as numpy params and codes."""
    s = jdt.init_state(jdeepsdf.DecoderConfig(**LATENT), N_SHAPES, jax.random.PRNGKey(3), jdt.make_optimizer(LR))
    return jax.tree_util.tree_map(np.asarray, s.params), np.asarray(s.codes)


def train_case(jax_state, n_steps: int, **kw) -> dict:
    params_np, codes = jax_state
    return {"decoder": decoder_spec(LATENT, params_np), "codes": torch.from_numpy(np.array(codes)), "lr": LR, "clamp": 0.1,
            "batches": [t_batch(b) for b in BATCHES[:n_steps]], "tp": None, **kw}


def one_process_steps(jax_state, n_steps: int):
    """The port's one-process train_step: losses, first gradients,
    parameters after the first and the last step."""
    params_np, codes = jax_state
    st = tdt.state_from_jax(params_np, codes, deepsdf.DecoderConfig(**LATENT), device="cpu", lr=LR)
    out = {"losses": []}
    for i in range(n_steps):
        out["losses"].append(tdt.train_step(st, t_batch(BATCHES[i])).item())
        if i == 0:
            out["grads"] = [p.grad.clone() for p in st.decoder.parameters()] + [st.codes.grad.clone()]
            out["params_first"] = [p.detach().clone() for p in st.decoder.parameters()] + [st.codes.detach().clone()]
    out["params"] = [p.detach().clone() for p in st.decoder.parameters()] + [st.codes.detach().clone()]
    out["state"] = st
    return out


def write_map(map_dir: str):
    """A MapObjects.txt with two objects (code length 64, the sphere
    decoder's radius set by code[0])."""
    os.makedirs(map_dir, exist_ok=True)
    rng = np.random.default_rng(4)
    with open(os.path.join(map_dir, "MapObjects.txt"), "w") as f:
        for obj_id, r in ((3, 0.1), (7, -0.4)):
            Two = np.eye(4)[:3]
            Two[:, 3] = rng.uniform(-5, 5, 3)
            code = np.zeros(64)
            code[0] = r
            f.write(f"{obj_id}\n{' '.join(map(str, Two.ravel()))}\n{' '.join(map(str, code))}\n")


@pytest.fixture(scope="module")
def tp_specs():
    """The two JAX test configs' decoders with random biases (a bias added
    once per rank would show) and 64 inputs each."""
    rng = np.random.default_rng(7)
    specs = []
    for cfg, seed in ((PLAIN, 0), (LATENT, 1)):
        spec = decoder_spec(cfg, jax_params(cfg, seed))
        spec["biases"] = [b + 0.1 * torch.from_numpy(rng.normal(size=b.shape).astype(np.float32))
                          for b in spec["biases"]]
        spec["inputs"] = torch.from_numpy((rng.normal(size=(64, 11)) * 0.4).astype(np.float32))
        specs.append(spec)
    return specs


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_state, tp_specs):
    """Spawn 4 and 2 gloo ranks once each; returns ({world: [rank results]}, dirs)."""
    root = tmp_path_factory.mktemp("parallel")
    map_dir = str(root / "map")
    write_map(map_dir)
    dirs = {"export": root / "export", "app": root / "app", "meshes": root / "meshes_sharded", "map": map_dir}
    dirs["export"].mkdir()
    code = torch.zeros(8)
    code[0] = 0.5
    specs = {
        4: {"mesh": {},
            "train": train_case(jax_state, 3),
            "decode": {"decoder": {"sphere": 8}, "code": code, "vol": 17, "extract_code": torch.zeros(8),
                       "extract_vol": 25},
            **{name: {"decoder": {"sphere": 8}, "gn_config": cfg, "tp": 1,
                      "args": [torch.from_numpy(a) for a in dryrun.gn_inputs(8, 32, 32, 8)]}
               for name, cfg in GN_CASES.items()}},
        2: {"mesh": {},
            "tp_decoder": {"tp": 2, "decoders": tp_specs},
            "train": train_case(jax_state, 3, export_dir=str(dirs["export"])),
            "train:resume": train_case(jax_state, 4, warm=1, tail=1),
            "apps": [("dspslam_tpu_torch.apps.train_deepsdf", TRAIN_APP + ["--out", str(dirs["app"])]),
                     ("dspslam_tpu_torch.apps.extract_map_objects",
                      ["--map_dir", map_dir, "--voxels_dim", "32", "--output_dir", str(dirs["meshes"]), "--shard",
                       "--device", "cpu"])]},
    }
    results = {}
    for world, spec in specs.items():
        out_dir = root / f"world{world}"
        out_dir.mkdir()
        torch.save(spec, out_dir / "spec.pt")
        dryrun.spawn(dryrun.run_cases, world, str(out_dir / "spec.pt"), str(out_dir), "cpu", device="cpu")
        results[world] = [torch.load(out_dir / f"rank{r}.pt", weights_only=True) for r in range(world)]
    return results, dirs


def _close_rel(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-30), np.abs(a - b).max()


def _close(got: list, ref: list, atol: float):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# make_mesh and the process group


@pytest.mark.parametrize("world, shape", [(4, (2, 2)), (2, (1, 2))])
def test_make_mesh_shapes(runs, world, shape):
    for rank in runs[0][world]:
        assert rank["mesh"] == {"default": shape, "tp1": (world, 1)}


def test_make_mesh_one_rank():
    with mesh_utils.process_group("cpu") as dev:
        assert dev == torch.device("cpu")
        assert tuple(mesh_utils.make_mesh(device="cpu").shape) == (1, 1)
        with pytest.raises(ValueError, match="ranks"):
            mesh_utils.make_mesh(4, device="cpu")
    assert not torch.distributed.is_initialized()


def test_init_group_reads_torchrun_environment(monkeypatch):
    """RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT as torchrun sets them
    (one rank here) open the group through env://."""
    port = mesh_utils._free_port()
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    with mesh_utils.process_group("cpu") as dev:
        assert dev == torch.device("cpu") and torch.distributed.get_backend() == "gloo"
        assert torch.distributed.get_world_size() == 1
    assert not torch.distributed.is_initialized()


def test_no_device_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    for fn in (mesh_utils.make_mesh, mesh_utils.init_group, lambda: dryrun.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
    assert not torch.distributed.is_initialized()


def test_batch_sharding_refuses_an_uneven_split():
    with mesh_utils.process_group("cpu"):
        mesh = mesh_utils.make_mesh(device="cpu")
        put = mesh_utils.batch_sharding(mesh)
        assert put({"x": torch.arange(5)})["x"].tolist() == [0, 1, 2, 3, 4]
    # dp = 2 refuses 5 rows (the rank of a 2-rank mesh is only needed for the slice)
    fake = type("Mesh", (), {"size": lambda self, dim: 2, "get_local_rank": lambda self, name: 1})()
    put = mesh_utils.batch_sharding(fake)
    assert put({"x": torch.arange(6)})["x"].tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="dp = 2"):
        put({"x": torch.arange(5)})


# ---------------------------------------------------------------------------
# the tensor-parallel decoder


def test_layer_kinds():
    C, R, X = tp_decoder.COLUMN, tp_decoder.ROW, tp_decoder.REPLICATED
    assert tp_decoder.layer_kinds(deepsdf.DecoderConfig(), 2) == [C, R, C, R, C, R, C, R, X]
    assert tp_decoder.layer_kinds(deepsdf.DecoderConfig(**LATENT), 2) == [C, R, C, R, X]
    assert tp_decoder.layer_kinds(deepsdf.DecoderConfig(**PLAIN), 4) == [C, R, X, X]
    assert tp_decoder.layer_kinds(deepsdf.DecoderConfig(code_len=8, hidden=(64,) * 4, latent_in=(1,)), 2) == [
        X, C, R, X, X]
    assert tp_decoder.layer_kinds(deepsdf.DecoderConfig(), 1) == [X] * 9


@pytest.mark.parametrize("which", [0, 1], ids=["plain", "latent_in"])
def test_tp_decoder_equals_the_full_decoder(runs, tp_specs, which):
    """Forward and input gradient at tp = 2, on every rank."""
    spec = tp_specs[which]
    cfg = deepsdf.DecoderConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in spec["config"].items()})
    sdf, grad = deepsdf.DeepSDFDecoder(cfg, spec["weights"], spec["biases"]).sdf_and_input_grad(spec["inputs"])
    for rank in runs[0][2]:
        res = rank["tp_decoder"][which]
        np.testing.assert_allclose(res["sdf"].numpy(), sdf.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(res["grad"].numpy(), grad.numpy(), rtol=0, atol=1e-6)


def test_tp_decoder_gathers_back_and_refuses_an_uneven_split(monkeypatch):
    with mesh_utils.process_group("cpu"):
        group = mesh_utils.make_mesh(device="cpu").get_group("tp")
        dec = deepsdf.init_params(deepsdf.DecoderConfig(**PLAIN), torch.Generator().manual_seed(0))
        full = tp_decoder.gather_decoder(tp_decoder.TensorParallelDecoder(dec, group))
        for a, b in zip(full.parameters(), dec.parameters()):
            assert torch.equal(a, b) and not a.requires_grad
    # a 3-rank tp group, as the split sees it: the check raises before any collective
    monkeypatch.setattr(tp_decoder.dist, "get_world_size", lambda group=None: 3)
    with pytest.raises(ValueError, match="do not split over tp = 3"):
        tp_decoder.TensorParallelDecoder(dec, None)


# ---------------------------------------------------------------------------
# sharded training


@pytest.mark.parametrize("world, shape", [(4, (2, 2)), (2, (1, 2))])
def test_sharded_steps_equal_one_process(runs, jax_state, world, shape):
    """Loss of each of 3 steps, the first step's gradients, the parameters
    after steps 1 and 3; every rank holds the same full state."""
    ref = one_process_steps(jax_state, 3)
    for rank in runs[0][world]:
        res = rank["train"]
        assert res["mesh"] == shape
        for got, want in zip(res["losses"], ref["losses"]):
            _close_rel(want, got, 1e-6)
        for got, want in zip(res["grads"], ref["grads"]):
            _close_rel(want.numpy(), got.numpy(), 1e-5)
        _close(res["params_first"], ref["params_first"], 1e-6)
        _close(res["params"], ref["params"], 1e-6)


def test_one_rank_mesh_is_the_one_process_arithmetic(jax_state):
    """On a (1, 1) mesh (what the card runs) nothing is split: three steps
    give the one-process losses and parameters exactly."""
    ref = one_process_steps(jax_state, 3)
    params_np, codes = jax_state
    with mesh_utils.process_group("cpu"):
        st = tdt.state_from_jax(params_np, codes, deepsdf.DecoderConfig(**LATENT), device="cpu", lr=LR)
        st = tdt.shard_state(st, mesh_utils.make_mesh(device="cpu"))
        losses = [tdt.train_step(st, t_batch(BATCHES[i])).item() for i in range(3)]
        full = tdt.gather_state(st)
    assert losses == ref["losses"] and full.step == 3
    for a, b in zip(list(full.decoder.parameters()) + [full.codes], ref["params"]):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("world", [4, 2])
def test_sharded_steps_equal_jax_mesh(runs, jax_state, world):
    """JAX's sharded train_step on make_mesh(8) from the same state and
    batches, losses at JAX's rtol of 1e-4."""
    cfg = jdeepsdf.DecoderConfig(**LATENT)
    opt = jdt.make_optimizer(LR)
    js = jdt.init_state(cfg, N_SHAPES, jax.random.PRNGKey(3), opt)
    mesh = jmu.make_mesh(8)
    losses = []
    with mesh:
        js = jdt.TrainState(jmu.decoder_param_sharding(mesh, js.params),
                            jax.device_put(js.codes, NamedSharding(mesh, P())), js.opt_state, js.step)
        for b in BATCHES[:3]:
            js, loss = jdt.train_step(js, jmu.batch_sharding(mesh)({k: jnp.asarray(v) for k, v in b.items()}),
                                      cfg, opt)
            losses.append(float(loss))
    np.testing.assert_allclose(runs[0][world][0]["train"]["losses"], losses, rtol=1e-4)


def test_shard_and_gather_carry_adam_moments(runs, jax_state):
    """One unsharded step, two sharded at (1, 2), one more on the gathered
    state: four one-process steps."""
    ref = one_process_steps(jax_state, 4)
    for rank in runs[0][2]:
        res = rank["train:resume"]
        for got, want in zip(res["losses"], ref["losses"]):
            _close_rel(want, got, 1e-6)
        _close(res["params"], ref["params"], 1e-6)


def test_gathered_checkpoint_and_export_load_in_both_packages(runs, jax_state):
    export = str(runs[1]["export"])
    ref = one_process_steps(jax_state, 3)["state"]
    back = tdt.load_checkpoint(os.path.join(export, "checkpoint.pt"), device="cpu")
    assert back.step == 3 and back.decoder.config == deepsdf.DecoderConfig(**LATENT)
    _close([p.detach() for p in back.decoder.parameters()] + [back.codes.detach()],
           [p.detach() for p in ref.decoder.parameters()] + [ref.codes.detach()], 1e-6)
    x = np.random.default_rng(5).normal(size=(64, 11)).astype(np.float32) * 0.4
    want = ref.decoder(torch.from_numpy(x)).detach().numpy()
    _, tdec = deepsdf.load_torch_checkpoint(export)
    jcfg, jparams = jdeepsdf.load_torch_checkpoint(export)
    np.testing.assert_allclose(tdec(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jdeepsdf.apply(jparams, jnp.asarray(x), jcfg)), want, rtol=0, atol=1e-6)


def test_train_deepsdf_under_two_ranks(runs, tmp_path):
    """The app under 2 ranks (torchrun's environment, tp = 2) writes what the
    one-process run writes."""
    sharded = str(runs[1]["app"])
    single = str(tmp_path / "single")
    train_deepsdf.main(TRAIN_APP + ["--out", single])
    a = tdt.load_checkpoint(os.path.join(sharded, "checkpoint.pt"), device="cpu")
    b = tdt.load_checkpoint(os.path.join(single, "checkpoint.pt"), device="cpu")
    assert a.step == b.step == 3
    _close([p.detach() for p in a.decoder.parameters()] + [a.codes.detach()],
           [p.detach() for p in b.decoder.parameters()] + [b.codes.detach()], 1e-5)
    np.testing.assert_allclose(np.load(os.path.join(sharded, "latent_codes.npy")),
                               np.load(os.path.join(single, "latent_codes.npy")), rtol=0, atol=1e-5)
    _, da = deepsdf.load_torch_checkpoint(sharded)
    _, db = deepsdf.load_torch_checkpoint(single)
    _close(list(da.parameters()), list(db.parameters()), 1e-5)


# ---------------------------------------------------------------------------
# sharded inference: the voxel decode and the object GN


def test_sharded_decode_equals_unsharded(runs):
    """dp = 4 over 17^3 points (padded to a multiple of 4), every rank."""
    code = torch.zeros(8)
    code[0] = 0.5
    sphere = deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=8))
    ref = mesh_mod.decode_sdf_grid(sphere, code, 17).numpy()
    jref = np.asarray(jmesh.decode_sdf_grid(jdeepsdf.sphere_decoder_fn, jdeepsdf.make_sphere_params(code_len=8),
                                            code.numpy(), 17))
    for rank in runs[0][4]:
        np.testing.assert_allclose(rank["decode"]["sdf"].numpy(), ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(rank["decode"]["sdf"].numpy(), jref, rtol=0, atol=1e-6)


def test_extractor_with_mesh_produces_sphere(runs):
    r = np.linalg.norm(runs[0][4][0]["decode"]["vertices"].numpy(), axis=-1)
    assert len(r) > 100
    np.testing.assert_allclose(r.mean(), 0.5, atol=0.03)


def test_extract_map_objects_shard_under_two_ranks(runs, tmp_path):
    single = str(tmp_path / "meshes")
    extract_map_objects.main(["--map_dir", runs[1]["map"], "--voxels_dim", "32", "--output_dir", single,
                              "--device", "cpu"])
    for obj_id in (3, 7):
        va, fa = read_mesh_ply(os.path.join(str(runs[1]["meshes"]), f"{obj_id}.ply"))
        vb, fb = read_mesh_ply(os.path.join(single, f"{obj_id}.ply"))
        assert len(va) > 100
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(np.load(os.path.join(str(runs[1]["meshes"]), f"{obj_id}_pose.npy")),
                                      np.load(os.path.join(single, f"{obj_id}_pose.npy")))


@pytest.mark.parametrize("case", list(GN_CASES))
def test_sharded_object_gn_equals_unsharded(runs, case):
    """B = 8 objects over dp = 4, two GN iterations with the sphere decoder,
    every rank; objects are independent, so the results are equal."""
    args = [torch.from_numpy(a) for a in dryrun.gn_inputs(8, 32, 32, 8)]
    sphere = deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=8))
    ref = gn.batched_reconstruct(sphere, gn.GNConfig(**GN_CASES[case]))(*args)
    for rank in runs[0][4]:
        got = rank[case]
        assert got["k1_launches"] == 0 and got["is_good"].dtype == torch.bool
        for k in ("t_cam_obj", "code", "is_good", "loss"):
            assert torch.equal(got[k], ref[k]), k


def test_sharded_object_gn_equals_jax_mesh(runs):
    """Against JAX's sharded_object_gn on make_mesh(8, tp=1), at JAX's
    tolerances (no rotation prior, see GN_CASES)."""
    cfg = GN_CASES["gn:no_rotation_prior"]
    jrecon = jgn.batched_reconstruct(jdeepsdf.sphere_decoder_fn, jgn.GNConfig(**cfg))
    want = jmu.sharded_object_gn(jmu.make_mesh(8, tp=1), jrecon, jdeepsdf.make_sphere_params(code_len=8),
                                 *[jnp.asarray(a) for a in dryrun.gn_inputs(8, 32, 32, 8)])
    got = runs[0][4][0]["gn:no_rotation_prior"]
    np.testing.assert_allclose(got["t_cam_obj"].numpy(), np.asarray(want["t_cam_obj"]), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["is_good"].numpy(), np.asarray(want["is_good"]))


def test_dryrun_multichip_four_ranks():
    dryrun.dryrun_multichip(4, device="cpu")
