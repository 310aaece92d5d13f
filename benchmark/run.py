"""One run of one cell of the benchmark of dspslam_tpu_torch.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A new process per run: it loads the port, sets up the cell (kernels from
the port's build directory, the caches of renders and of the decoder fit
under benchmark/.cache/, a warm-up of the shapes the traffic uses),
measures for `--seconds`, checks what the timed path produced against the
plain references, and prints, as the last line of standard output, one
JSON object: correct, attempted, failed, metrics, device (with --trace 1
also busy_s and window_s), with --trace 1 a breakdown, and last the
numbers compared, each beside its limit (`checks`). The set-up breakdown,
the host spans, the card's nvidia-smi reading and every number the check
read (`numbers`, those without a limit too) go on the line before it and
into benchmark/out/. With --trace 0 the metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics (BENCHMARK.json).

The run exits non-zero and prints no result when no CUDA device is there
(or fewer than the cell asks for), when the port is not importable, or when
JAX or the JAX package is loaded once the window has closed.
`main(argv, overrides)` with `--device cpu` is the CPU tests' tiny path.
"""

from __future__ import annotations

import os
import time

T_PROCESS = time.perf_counter()
# one process, one host thread for numerical libraries: steadier runs on a
# shared host (the renders of set-up run in their own thread pool)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel caches at fixed paths inside the checkout (the port builds its own
# kernels into dspslam_tpu_torch/kernels/_build/, also inside it)
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, os.path.join(HERE, ".cache", _dir))
FORBIDDEN = ("jax", "jaxlib", "flax", "dspslam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def deep_update(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = deep_update(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return code


def parse(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help="cuda (the benchmark) or cpu (the CPU tests only)")
    return p.parse_args(argv)


def main(argv=None, overrides: dict | None = None, out=None, variant: str | None = None) -> int:
    """Run one cell; `overrides` ({"config": {...}, "mix": {...}}) patch the
    configuration and the mix (the CPU tests shrink them), and `variant`
    plants a fault or the precision control (faults.py; the tests and
    control.py only). Returns the exit code; the result line goes to `out`
    (stdout by default)."""
    out = out or sys.stdout
    args = parse(argv)
    if importlib.util.find_spec("dspslam_tpu_torch") is None:
        return _fail("the package under test, dspslam_tpu_torch, is not importable from here", 2)
    import torch

    from benchmark import manifest

    torch.set_num_threads(1)
    bench = manifest.load(ROOT)
    try:
        cell_spec = manifest.workload(bench, args.workload)
    except KeyError as e:
        return _fail(str(e), 2)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            return _fail("no CUDA device: this benchmark measures the port on an NVIDIA GPU", 3)
        if torch.cuda.device_count() < cell_spec["chips"]:
            return _fail(f"the cell needs {cell_spec['chips']} devices, {torch.cuda.device_count()} are visible", 3)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device(args.device)
    overrides = overrides or {}
    config = deep_update(manifest.config(bench, cell_spec["config"], ROOT), overrides.get("config", {}))
    mix = deep_update(manifest.mix(cell_spec["traffic"]), overrides.get("mix", {}))
    with contextlib.redirect_stdout(sys.stderr):
        record = measure(args, bench, cell_spec, config, mix, device, variant)
    bad = forbidden_modules()
    if bad:
        return _fail(f"JAX or the JAX package is loaded in the measuring process: {bad}", 4)
    for name, (value, limit) in record["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps({"setup_breakdown": record["setup"], "spans_ms": record["spans_ms"],
                      "nvidia_smi": record["smi"], "numbers": record["numbers"]}), file=out)
    line = {"correct": record["correct"], "attempted": record["attempted"], "failed": record["failed"],
            "metrics": record["metrics"], "device": record["device"]}
    if record.get("breakdown") is not None:
        line["breakdown"] = record["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in record["checks"].items()}
    print(json.dumps(line), file=out, flush=True)
    return 0


def measure(args, bench, cell_spec, config, mix, device, variant=None) -> dict:
    import torch

    from benchmark import common, manifest
    from benchmark.spans import Spans
    from benchmark.trace import DeviceTrace

    log = common.SetupLog()
    spans = Spans()
    cell = manifest.cell_class(mix["kind"])(config, mix, args.seed, device, spans, log)
    cell.variant = variant
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cell.setup()
    common.synchronize(device)
    setup_s = time.perf_counter() - T_PROCESS
    spans.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # a device trace exists only on the card: a CPU run reports no device metric
    trace = DeviceTrace(device) if args.trace and device.type == "cuda" else None
    window_s = cell.window(args.seconds, trace)
    t_end = time.perf_counter()
    common.synchronize(device)
    facts = common.device_facts(device, cell_spec["chips"])
    smi = common.nvidia_smi() if device.type == "cuda" else None
    attempted, failed = cell.attempted_failed()
    run = Run(cell, config, mix, window_s, t_end, setup_s, spans, trace, device)
    reduced = None
    if trace is not None:
        reduced = trace.reduce(spans.samples)
        run.trace_reduced = reduced
        facts["busy_s"] = reduced["busy_s"]
        facts["window_s"] = reduced["window_s"]
    cell.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # the references, off the clock, once the program's state is freed
    limits = manifest.limits(args.workload)
    try:
        with no_tf32():
            numbers = {k: float(v) for k, v in cell.check().items()}
        checks = {k: (numbers[k], lim) for k, lim in limits.items()}
        correct = all(v <= lim for v, lim in checks.values())
    except Exception:           # a failed check is a run that is not correct
        traceback.print_exc()
        numbers, checks, correct = {}, {"check_raised": (1.0, 0.0)}, False
    entries = manifest.per_layer(bench, args.workload) if args.trace else manifest.end_to_end(bench, args.workload)
    metrics = {}
    for m in entries:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    record = {
        "correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
        "device": facts, "checks": checks,
        "breakdown": None if reduced is None else {"device_ops": reduced["device_ops"],
                                                   "idle_gaps": reduced["idle_gaps"]},
        "setup": {"setup_s": setup_s, **{f"{k}_s": v for k, v in log.stages.items()}, **log.notes},
        "spans_ms": spans.summary_ms(), "smi": smi, "numbers": numbers,
    }
    write_detail(args, record, cell)
    return record


@contextlib.contextmanager
def no_tf32():
    import torch

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


class Run:
    """What a metric's reader sees of a run."""

    def __init__(self, cell, config, mix, window_s, t_end, setup_s, spans, trace, device):
        self.cell, self.config, self.mix = cell, config, mix
        self.window_s, self.t_end, self.setup_s = window_s, t_end, setup_s
        self.spans, self.trace, self.device = spans, trace, device
        self.trace_reduced = None

    def untraced(self, span: str) -> list[float]:
        """Durations of the span's samples that began after the device trace
        stopped (all of them without a trace): the profiler slows the host."""
        t1 = self.trace.t1 if self.trace is not None else float("-inf")
        return [b - a for a, b in self.spans.samples.get(span, ()) if a >= t1]

    def untraced_s(self) -> float:
        """Seconds of the window after the device trace stopped (the whole
        window without a trace)."""
        return self.t_end - self.trace.t1 if self.trace is not None else self.window_s


def write_detail(args, record: dict, cell):
    path = os.path.join(HERE, "out", f"{args.workload}.seed{args.seed}.trace{args.trace}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    detail = {k: v for k, v in record.items()}
    detail["checks"] = {k: list(v) for k, v in record["checks"].items()}
    detail["drives"] = [{k: v for k, v in d.items() if k != "trajectory"} for d in getattr(cell, "drives_done", [])]
    detail["frames_s"] = getattr(cell, "frames_s", None)
    detail["checked"] = getattr(cell, "checked", None)
    detail["trajectory"] = getattr(cell, "trajectory", None)
    with open(path, "w") as f:
        json.dump(detail, f)


if __name__ == "__main__":
    sys.exit(main())
