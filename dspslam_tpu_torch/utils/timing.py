"""Stage timing with explicit device synchronization.

Port of dspslam_tpu/utils/timing.py: a reusable accumulator that reports
median/mean per stage. A stage given a CUDA tensor to wait on calls
`torch.cuda.synchronize()` on its device before the clock stops, so the
time covers the device work and not only its enqueue.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


class StageTimer:
    def __init__(self):
        self.samples = defaultdict(list)

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
        return "\n".join(rows)

    def summary_ms(self) -> dict:
        """Flat {stage: p50 / p95 / total ms and count} for a JSON line."""
        return {
            name: {"p50": s["median_ms"], "p95": s["p95_ms"], "total": s["total_ms"], "n": s["count"]}
            for name, s in sorted(self.report().items())
        }
