"""BENCHMARK.json against the contract's shape, and discovery by name: a
new configuration, mix, cell and metric are new files plus new entries."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_files(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py")), m["name"]
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))
        assert manifest.limits(w["name"])


def test_bounds_and_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        reported = {m["name"] for m in manifest.end_to_end(bench, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = manifest.per_layer(bench, w["name"])
        assert layers and all(m["moves"] in reported for m in layers)


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """Copy the benchmark, add a mix, a configuration, a cell and a metric
    as new files plus entries, and run the new cell on the CPU: the new
    metric is in its line and no existing file was edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "out", "__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in map(str, (tmp_path / "benchmark").rglob("*")) if os.path.isfile(p)}
    mix = json.load(open(tmp_path / "benchmark" / "traffic" / "gn_burst.json"))
    mix["batch"] = 4
    json.dump(mix, open(tmp_path / "benchmark" / "traffic" / "gn_pairs.json", "w"))
    cfg = json.load(open(tmp_path / "benchmark" / "configs" / "kitti_04_12.json"))
    json.dump(dict(cfg, name="kitti_copy"), open(tmp_path / "benchmark" / "configs" / "kitti_copy.json", "w"))
    shutil.copy(tmp_path / "benchmark" / "limits" / "kitti_gn.json", tmp_path / "benchmark" / "limits" / "kitti_pairs.json")
    (tmp_path / "benchmark" / "metrics" / "gn_calls_per_s.py").write_text(
        "def read(run):\n    return run.cell.calls / run.window_s\n")
    bench["configs"].append({"name": "kitti_copy", "source": "https://example.org", "file":
                             "benchmark/configs/kitti_copy.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "kitti_pairs", "config": "kitti_copy", "traffic": "gn_pairs", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "gn_ms_per_object":
            m["workloads"].append("kitti_pairs")
    bench["per_layer"].append({"name": "gn_calls_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "gn_ms_per_object", "workloads": ["kitti_pairs"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = ("import json, sys\n"
            "from benchmark import run\n"
            "from benchmark.tests import tiny\n"
            "o = tiny.overrides('kitti_gn', {})\n"
            "o['mix']['batch'] = 2\n"
            "sys.exit(run.main(['--workload', 'kitti_pairs', '--seed', '5', '--seconds', '1', '--trace', '1',"
            " '--device', 'cpu'], o))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "gn_calls_per_s" in line["metrics"] and line["correct"] is True
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
