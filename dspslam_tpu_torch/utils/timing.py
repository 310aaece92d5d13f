"""Stage timing with explicit device synchronization, and the port's one
process-wide telemetry hook.

Port of dspslam_tpu/utils/timing.py: `StageTimer` is a reusable
accumulator that reports median/mean per stage. A stage given a CUDA
tensor to wait on calls `torch.cuda.synchronize()` on its device before
the clock stops, so the time covers the device work and not only its
enqueue.

The hook: `attach(sink)` makes `sink` the process's one telemetry sink,
any object with `add(name, seconds)` (a `StageTimer` is one). Code at any
depth of the port opens `with span(name):` around host work and calls
`count(name, n)` for host-known numbers (kernel launches, decoded rows),
so no span or counter is threaded through a signature and none reads a
device value.

* `span(name)` with no sink attached returns one shared no-op context: no
  clock read, no allocation. With a sink it reads `time.perf_counter()` at
  entry and exit and calls `sink.add(name, end - start)` at once at exit,
  so a sink that stamps the add with `perf_counter()` recovers the span's
  start. The clock is `time.perf_counter` because a device trace can be
  aligned to it (a synchronised marker kernel ties the two clocks), which
  labels each idle gap on the device by the host span open during it.
* Spans of one name never overlap or nest in themselves; spans of
  different names nest.
* `count(name, n)` always adds to a process-wide total (`totals()`), and
  forwards to `sink.count(name, n)` where the sink has a `count` method.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

_sink = None
_sink_count = None              # the sink's bound `count`, or None
_totals: dict[str, int] = {}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("sink", "name", "t0")

    def __init__(self, sink, name: str):
        self.sink, self.name = sink, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb):
        self.sink.add(self.name, time.perf_counter() - self.t0)
        return False


def attach(sink):
    """Make `sink` (an object with `add(name, seconds)`, or None) the
    process's telemetry sink; returns the previous one."""
    global _sink, _sink_count
    previous = _sink
    _sink, _sink_count = sink, getattr(sink, "count", None)
    return previous


def detach():
    """No sink: spans cost nothing; counters still total."""
    return attach(None)


def sink():
    """The attached sink, or None."""
    return _sink


@contextlib.contextmanager
def attached(sink):
    """`sink` attached inside the block (None: none), the previous sink
    restored on exit, also on an exception."""
    previous = attach(sink)
    try:
        yield sink
    finally:
        attach(previous)


def span(name: str):
    """Context manager timing a block of host work into the sink."""
    s = _sink
    if s is None:
        return _NO_SPAN
    return _Span(s, name)


def count(name: str, n: int = 1):
    """Add `n` to the process-wide total `name` (and the sink's count)."""
    _totals[name] = _totals.get(name, 0) + n
    if _sink_count is not None:
        _sink_count(name, n)


def totals() -> dict[str, int]:
    """A copy of the process-wide counter totals."""
    return dict(_totals)


class StageTimer:
    def __init__(self):
        self.samples = defaultdict(list)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: object = None):
        """Time a block; pass a tensor as `sync` (or set out["sync"]) to wait
        for its device at exit."""
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            target = out.get("sync", sync)
            if isinstance(target, torch.Tensor) and target.is_cuda:
                torch.cuda.synchronize(target.device)
            self.samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        """Record an externally timed sample."""
        self.samples[name].append(seconds)

    def count(self, name: str, n: int = 1):
        """Add to a counter (the hook forwards `timing.count` here)."""
        self.counts[name] += n

    def clear(self):
        self.samples.clear()
        self.counts.clear()

    def report(self) -> dict:
        return {
            name: {
                "median_ms": float(np.median(v) * 1e3),
                "mean_ms": float(np.mean(v) * 1e3),
                "p95_ms": float(np.percentile(v, 95) * 1e3),
                "max_ms": float(np.max(v) * 1e3),
                "total_ms": float(np.sum(v) * 1e3),
                "count": len(v),
            }
            for name, v in self.samples.items()
        }

    def __str__(self):
        rows = [
            f"{name:30s} median {s['median_ms']:8.2f} ms  mean {s['mean_ms']:8.2f} ms  n={s['count']}"
            for name, s in sorted(self.report().items())
        ]
        rows += [f"{name:30s} count {n}" for name, n in sorted(self.counts.items())]
        return "\n".join(rows)

    def summary_ms(self) -> dict:
        """Flat {stage: p50 / p95 / total ms and count} for a JSON line."""
        return {
            name: {"p50": s["median_ms"], "p95": s["p95_ms"], "total": s["total_ms"], "n": s["count"]}
            for name, s in sorted(self.report().items())
        }
