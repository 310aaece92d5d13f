"""`dspslam_tpu_torch.apps.bench`, the port of bench.py, on the CPU.

With `benchmark_slam.main` replaced by a recorder that returns canned
records, each arm passes the argv and frame counts that bench.py's
`_measure` passes (read from bench.py's syntax tree, so jax is not
imported), in bench.py's order; every key bench.py writes is on one of the
port's two JSON lines or in its list of relay keys left out; the last line
holds scalars only. A failing arm leaves its `<arm>_error` on a line that
still carries the other arms' keys, and the exit code is 1; so does the
deadline. The `gn` arm at a small decoder (code 64, 4 x 64, B = 2, one
iteration) equals the JAX package's `batched_reconstruct` on the same numpy
inputs and weights within 1e-3. Without a card the entry raises.
`benchmark_slam`'s `--async_kf` / `--sync_kf` set what the JAX parser sets.
The card runs the entry at bench.py's sizes in chip_smoke.py phase 15.
"""

import ast
import json
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.apps import benchmark_slam as jbenchmark_slam
from dspslam_tpu.models import deepsdf as jdeepsdf
from dspslam_tpu.shape import gn as jgn
from dspslam_tpu_torch.apps import bench, benchmark_slam
from dspslam_tpu_torch.models import deepsdf

BENCH_PY = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
ARM_ORDER = ["full", "ab", "mono_redwood", "mono_freiburg", "paced", "gn", "long_loop"]
SMALL = dict(code_len=64, hidden=(64,) * 4, latent_in=())


def _function(tree, name):
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def bench_py_calls() -> list:
    """bench.py's `_measure` arms in order: the argv of each
    `bench_slam_fps` call (`["--frames", str(frames), *extra]`) or "gn" for
    `bench_gn`. The re-measure inside the degraded-window branch (an `if`)
    is relay-only and left out."""
    tree = ast.parse(BENCH_PY.read_text())
    fps_def = _function(tree, "bench_slam_fps")
    defaults = {a.arg: ast.literal_eval(d) for a, d in zip(fps_def.args.args[-len(fps_def.args.defaults):],
                                                          fps_def.args.defaults)}
    calls = []
    for stmt in _function(tree, "_measure").body:
        if not isinstance(stmt, (ast.Assign, ast.Expr)) or not isinstance(stmt.value, ast.Call):
            continue
        func = stmt.value.func
        name = func.id if isinstance(func, ast.Name) else None
        if name == "bench_gn":
            calls.append("gn")
        elif name == "bench_slam_fps":
            kw = {**defaults, **{k.arg: ast.literal_eval(k.value) for k in stmt.value.keywords}}
            calls.append(["--frames", str(kw["frames"]), *kw["extra"]])
    return calls


def bench_py_keys() -> set:
    """Every key bench.py writes into RESULTS: the initial dict, subscript
    assignments, `RESULTS.update(...)` keywords and the long-loop `for key
    in (...)` loop."""
    tree = ast.parse(BENCH_PY.read_text())
    keys = set()
    loops = {n.target.id: ast.literal_eval(n.iter) for n in ast.walk(tree)
             if isinstance(n, ast.For) and isinstance(n.target, ast.Name) and isinstance(n.iter, ast.Tuple)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "RESULTS" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) and node.value.id == "RESULTS" \
                and isinstance(node.ctx, ast.Store):
            keys |= {node.slice.value} if isinstance(node.slice, ast.Constant) else set(loops[node.slice.id])
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "update" \
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "RESULTS":
            keys |= {k.arg for k in node.keywords}
    return keys


def canned(argv) -> dict:
    """A record with every key the entry reads from benchmark_slam's
    stereo, mono and long-loop records."""
    rec = {k: 1.5 for k in bench.HEADLINE_KEYS}
    rec.update(value=2.0, median_fps=2.5, workload="detectors+mlp", n_meshes=3, n_dynamic=1, lost_frames=0,
               travel_m=16.5, meshes_skipped={"bad": 0, "dynamic": 1}, stage_ms={"track": {"p50": 1.0}},
               frame_ms_p99=600.0, lost_after_init=0, drop_rate=0.9, ate_before_loop_cm=115.0,
               ate_after_loop_cm=6.0, loop_kfs=201, loops_closed=1, argv=list(argv))
    return rec


def canned_gn(device):
    return {"ms_per_object": 35.0, "matmul_precision": "highest", "out": None}


@pytest.fixture
def recorder(monkeypatch):
    """benchmark_slam.main recording its argv (less `--device cpu`) and the
    gn arm canned; `fail` names an arm that raises instead."""
    state = {"calls": [], "fail": None}

    def fake_main(argv):
        assert argv[-2:] == ["--device", "cpu"]
        state["calls"].append(argv[:-2])
        if state["fail"] is not None and state["fail"](argv[:-2]):
            raise RuntimeError("planted failure")
        return canned(argv)

    def gn(device):
        state["calls"].append("gn")
        if state["fail"] is not None and state["fail"](["gn"]):
            raise RuntimeError("planted failure")
        return canned_gn(device)

    monkeypatch.setattr(benchmark_slam, "main", fake_main)
    monkeypatch.setitem(bench.ARMS, "gn", (gn, bench.ARMS["gn"][1]))
    return state


def run_main(capsys, **kw):
    code = bench.main(["--device", "cpu"], **kw)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 2
    return code, json.loads(lines[0]), json.loads(lines[1])


def test_arms_pass_bench_py_argv_in_its_order(recorder, capsys):
    code, details, last = run_main(capsys)
    assert code == 0
    assert list(bench.ARMS) == ARM_ORDER
    assert recorder["calls"] == bench_py_calls()
    assert [c[:2] for c in recorder["calls"] if c != "gn"] == [
        ["--frames", "56"], ["--frames", "56"], ["--frames", "30"], ["--frames", "30"], ["--frames", "30"],
        ["--frames", "100"]]


def test_every_bench_py_key_is_on_a_line_or_left_out(recorder, capsys):
    _, details, last = run_main(capsys)
    written = bench_py_keys()
    assert {"value", "ate_joint_cm", "mono_freiburg_paced_drop_rate", "gn_recon_ms_per_object",
            "loops_closed", "relay_upload_ms_466KB"} <= written
    assert set(bench.LEFT_OUT) <= written
    missing = written - set(details) - set(last) - set(bench.LEFT_OUT)
    assert not missing
    assert not set(bench.LEFT_OUT) & (set(details) | set(last))
    assert all(v is None or isinstance(v, (bool, int, float, str)) for v in last.values())
    assert {"stage_ms", "mono_redwood_stage_ms", "mono_freiburg_stage_ms", "meshes_skipped"} <= set(details)
    # the mean first (R4), the median beside it; the A/B's joint arm is the headline run
    assert (last["value"], last["median_fps"], last["vs_baseline"]) == (2.0, 2.5, 0.2)
    assert last["mono_fps_redwood_median"] == 2.5 and last["mono_vs_freiburg_pacing_25fps"] == 2.0 / 25
    assert last["ate_joint_cm"] == last["ate_rmse_cm"] and last["gn_vs_baseline_50ms"] == 50.0 / 35.0
    assert last["gn_matmul_precision"] == "highest" and not any(k.endswith("_error") for k in last)


def test_prior_records_are_not_run_again(recorder, capsys):
    prior = {"full": canned(["prior"]), "long_loop": canned(["prior"])}
    code, _, last = run_main(capsys, prior=prior)
    assert code == 0 and len(recorder["calls"]) == len(bench_py_calls()) - 2
    assert ["--frames", "56"] not in recorder["calls"] and ["--frames", "100", "--long_loop"] not in recorder["calls"]
    assert last["value"] == 2.0 and last["ate_after_loop_cm"] == 6.0


@pytest.mark.parametrize("arm", ARM_ORDER)
def test_a_failing_arm_is_isolated(recorder, capsys, arm):
    keys = {"full": "value", "ab": "ate_points_only_cm", "mono_redwood": "mono_fps_redwood",
            "mono_freiburg": "mono_fps_freiburg", "paced": "mono_freiburg_paced_drop_rate",
            "gn": "gn_recon_ms_per_object", "long_loop": "ate_after_loop_cm"}
    argv_of = {name: call for name, call in zip(ARM_ORDER, bench_py_calls())}
    recorder["fail"] = lambda argv: argv == argv_of[arm] or argv == [arm]
    code, _, last = run_main(capsys)
    assert code == 1
    assert last[f"{arm}_error"] == "RuntimeError: planted failure"
    assert [k for k in last if k.endswith("_error")] == [f"{arm}_error"]
    others = [keys[a] for a in ARM_ORDER if a != arm and not (arm == "full" and a == "ab")]
    assert all(last.get(k) is not None for k in others)
    assert len(recorder["calls"]) == len(ARM_ORDER)


def test_the_deadline_prints_what_was_measured(recorder, capsys, monkeypatch):
    exits = []
    monkeypatch.setenv("BENCH_DEADLINE_S", "0.5")
    monkeypatch.setattr(bench, "_hard_exit", exits.append)
    slow_main = benchmark_slam.main

    def slow(argv):
        if "--mono" in argv and "--paced" not in argv and "redwood" in argv:
            time.sleep(2.5)
        return slow_main(argv)

    monkeypatch.setattr(benchmark_slam, "main", slow)
    code, _, last = run_main(capsys)
    assert code == 1 and exits == [1]
    assert "deadline_hit" in last and last["value"] == 2.0 and "mono_fps_redwood" not in last


def test_gn_arm_matches_jax():
    """bench_gn's inputs at B = 2 through one GN iteration on a 4 x 64
    decoder with canonical_params_np(0)'s weights, port against JAX."""
    cfg = deepsdf.DecoderConfig(**SMALL)
    res = bench.gn("cpu", config=cfg, batch=2, iterations=1, reps=1)
    assert res["ms_per_object"] > 0 and res["matmul_precision"] == "highest"
    params = bench.canonical_params_np(0, cfg)
    jparams = {k: [jnp.asarray(a) for a in v] for k, v in params.items()}
    inputs = [jnp.asarray(a.numpy()) for a in bench.bench_gn_inputs("cpu", batch=2)]
    ref = jgn.batched_reconstruct(jdeepsdf.make_decoder_fn(jdeepsdf.DecoderConfig(**SMALL)),
                                  jgn.GNConfig(code_len=64, num_iterations=1, max_grad_points=1024))(jparams, *inputs)
    out = res["out"]
    for key in ("t_cam_obj", "code"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-3, rtol=0)
    assert out["is_good"].tolist() == np.asarray(ref["is_good"]).tolist()
    assert bool(torch.isfinite(out["loss"]).all())


def test_bench_gn_inputs_are_bench_py_shapes():
    t, pts, pts_mask, rays, ray_mask, depth, fg_mask, code = bench.bench_gn_inputs("cpu")
    assert (t.shape, pts.shape, rays.shape, code.shape) == ((8, 4, 4), (8, 256, 3), (8, 512, 3), (8, 64))
    assert float(t[0, 2, 3]) == 8.0 and float(depth.min()) == float(depth.max()) == 8.0
    assert bool(pts_mask.all() and ray_mask.all() and fg_mask.all()) and not bool(code.any())
    assert [w.shape for w in bench.canonical_params_np(0)["w"]][3:5] == [(512, 445), (512, 512)]


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        bench.gn()


@pytest.mark.parametrize("argv", [[], ["--async_kf"], ["--sync_kf"], ["--sync_kf", "--async_kf"],
                                  ["--async_kf", "--sync_kf"]])
def test_async_kf_flags_match_jax(monkeypatch, argv):
    monkeypatch.setattr(jax.config, "update", lambda *a: None)      # JAX's main sets a /tmp compile cache
    monkeypatch.setattr(jbenchmark_slam, "main_mono", lambda args: args)
    monkeypatch.setattr(benchmark_slam, "main_mono", lambda args, device: args)
    ref = jbenchmark_slam.main(["--mono", *argv])
    ours = benchmark_slam.main(["--mono", "--device", "cpu", *argv])
    assert ours.async_kf == ref.async_kf == (argv[-1:] != ["--sync_kf"])
