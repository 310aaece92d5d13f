"""Host spans: named intervals on the host clock (time.perf_counter).

`Spans` is what the benchmark hands to `SLAMSystem.attach_telemetry`: the
system, its tracker and its local mapper call `add(name, seconds)` as each
stage ends, and the harness opens its own spans with `span(name)`. Every
sample keeps its start and end, so a traced run can say which span was open
while the device sat idle.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.samples: dict[str, list[tuple[float, float]]] = defaultdict(list)

    def add(self, name: str, seconds: float):
        """A span that ends now and lasted `seconds` (the port's telemetry call)."""
        end = time.perf_counter()
        self.samples[name].append((end - seconds, end))

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append((t0, time.perf_counter()))

    def summary_ms(self) -> dict:
        """{name: {n, mean, total}} in ms, for the run's detail file."""
        out = {}
        for name, iv in sorted(self.samples.items()):
            d = [b - a for a, b in iv]
            out[name] = {"n": len(d), "mean_ms": 1e3 * sum(d) / len(d), "total_ms": 1e3 * sum(d)}
        return out

    def clear(self):
        self.samples.clear()
