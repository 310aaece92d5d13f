"""Each cell's tiny run on the CPU prints a last line with exactly the
contract's keys (and `checks` last), is correct, and loads neither JAX nor
the JAX package; planted faults make `correct` false."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("kitti_full", "kitti_gn", "freiburg_mono")
# cells kept for later (benchmark/later/<cell>.json): run from a checkout
# whose BENCHMARK.json regains them by those entries alone
LATER = ("freiburg_mono",)


@pytest.fixture(scope="module")
def later_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("later")
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "out", "__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for cell in LATER:
        entries = json.load(open(os.path.join(ROOT, "benchmark", "later", f"{cell}.json")))
        bench["configs"] += entries["configs"]
        bench["workloads"] += entries["workloads"]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in entries["metrics"]:
                m["workloads"].append(cell)
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return str(root)


def root_of(cell: str, request) -> str:
    return request.getfixturevalue("later_root") if cell in LATER else ROOT


def tiny_run(cell: str, trace: int = 0, variant: str | None = None, seed: int = 3_000_000_017,
             preload: str = "", root: str = ROOT) -> subprocess.CompletedProcess:
    """A fresh process, as the driver's runs are: the cell shrunk by tiny.py,
    run from `root` (the port is imported from this repo)."""
    code = (f"{preload}\n"
            "import sys\n"
            "from benchmark import manifest, run\n"
            "from benchmark.tests import tiny\n"
            "bench = manifest.load('.')\n"
            f"spec = manifest.workload(bench, {cell!r})\n"
            "cfg = manifest.config(bench, spec['config'], '.')\n"
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '{seed}', '--seconds', '12', '--trace',"
            f" '{trace}', '--device', 'cpu'], tiny.overrides({cell!r}, cfg), variant={variant!r}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                          timeout=900)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_tiny_run_prints_the_contract_line(cell, trace, request):
    root = root_of(cell, request)
    proc = tiny_run(cell, trace, root=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0, line["checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    if trace == 0:
        want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want
    else:
        # the CPU has no device trace: only the cell's span metrics, none in the GN cell
        assert all(m in {p["name"] for p in bench["per_layer"]} for m in line["metrics"])
        assert bool(line["metrics"]) == (cell != "kitti_gn")
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


def test_a_loaded_jax_package_fails_the_run():
    proc = tiny_run("kitti_gn", preload="import sys, types; sys.modules['dspslam_tpu'] = types.ModuleType('dspslam_tpu')")
    assert proc.returncode != 0 and not proc.stdout.strip().endswith("}")
    assert "dspslam_tpu" in proc.stderr


def test_the_port_alone_has_no_jax():
    proc = tiny_run("kitti_gn")
    assert proc.returncode == 0
    code = ("import sys, dspslam_tpu_torch.slam.system, dspslam_tpu_torch.shape.gn\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'dspslam_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    env = dict(os.environ, PYTHONPATH="")
    args = ["-m", "benchmark.run", "--workload", "kitti_gn", "--seed", "1", "--seconds", "1", "--trace", "0"]
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    import shutil
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "out", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, *args], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


GN_FAULTS = ("gn.unchanged", "gn.half_batch", "gn.altered")
SLAM_FAULTS = ("ba.unchanged", "ba.altered", "pose.unchanged", "pose.half_batch", "pose.altered")


@pytest.mark.parametrize("cell,fault", [("kitti_gn", f) for f in GN_FAULTS]
                         + [("kitti_full", f) for f in GN_FAULTS + SLAM_FAULTS]
                         + [("freiburg_mono", f) for f in SLAM_FAULTS])
def test_a_planted_fault_is_not_correct(cell, fault, request):
    """The timed path broken underneath in one layer (faults.py), the rest of
    the run as it is: each fault alone makes the run not correct."""
    proc = tiny_run(cell, variant=fault, root=root_of(cell, request))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
