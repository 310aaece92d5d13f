"""The device trace of a `--trace 1` run and its reduction.

`DeviceTrace` wraps `torch.profiler` (CUDA activity only) over a part of
the measured window. Before it starts, a synchronised marker kernel ties
the trace's clock to the host's `time.perf_counter`, so each idle gap on
the device can be labelled by the host span that was open during it.

The reduction is plain arithmetic on (name, start, end) intervals, so the
CPU tests feed it synthetic intervals:
  * busy_s: the union of every device interval (kernels, copies, sets);
  * device_ops: total device seconds by operation name, the largest first;
  * idle_gaps: the gaps between busy intervals inside the window, each
    labelled by the shortest host span covering its midpoint, summed by
    label.
"""

from __future__ import annotations

import bisect
import time


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(intervals, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which some interval was running."""
    return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in merge(intervals))


def device_ops(events, top: int = 10) -> list:
    """[[name, seconds]] by total device time, the largest `top`."""
    tot = {}
    for name, a, b in events:
        tot[name] = tot.get(name, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


class SpanIndex:
    """Host spans by name, sorted by start, for `label(t)`: the name of the
    shortest span that covers time t, or "none". Spans of one name do not
    overlap (each is a call that returned before the next began)."""

    def __init__(self, spans: dict):
        self.rows = []
        for name, ivs in spans.items():
            ivs = sorted(ivs)
            self.rows.append((name, [a for a, _ in ivs], ivs))

    def label(self, t: float) -> str:
        best, best_len = "none", float("inf")
        for name, starts, ivs in self.rows:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ivs[i][1] >= t and ivs[i][1] - ivs[i][0] < best_len:
                best, best_len = name, ivs[i][1] - ivs[i][0]
        return best


def idle_gaps(intervals, t0: float, t1: float, spans: dict, top: int = 10) -> list:
    """[[label, seconds]]: the device-idle time in [t0, t1] summed by what
    the host was doing (the label of each gap's midpoint), the `top`
    largest."""
    index = SpanIndex(spans)
    tot, cursor = {}, t0

    def add(a, b):
        label = index.label(0.5 * (a + b))
        tot[label] = tot.get(label, 0.0) + (b - a)

    for a, b in merge(intervals):
        if b <= t0:
            continue
        if a >= t1:
            break
        if a > cursor:
            add(cursor, a)
        cursor = max(cursor, b)
    if cursor < t1:
        add(cursor, t1)
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


class DeviceTrace:
    """torch.profiler over part of a window. `start()` / `stop()` bracket
    it; `events` then holds (name, start, end) on the host clock."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.events: list[tuple[str, float, float]] = []
        self.t0 = self.t1 = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._mark = time.perf_counter()
        torch.zeros(1, device=self.device)          # the marker kernel
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type().name == "CUDA":
                raw.append((e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9))
        self.prof = None
        if not raw:
            raise RuntimeError("the profiler recorded no device activity")
        raw.sort(key=lambda e: e[1])
        offset = self._mark - raw[0][1]             # the marker ran first, right after _mark
        self.events = [(n, a + offset, b + offset) for n, a, b in raw[1:]]

    def window_s(self) -> float:
        return self.t1 - self.t0

    def reduce(self, spans: dict) -> dict:
        iv = [(a, b) for _, a, b in self.events]
        return {
            "busy_s": busy_seconds(iv, self.t0, self.t1),
            "window_s": self.window_s(),
            "device_ops": device_ops([e for e in self.events if e[1] >= self.t0]),
            "idle_gaps": idle_gaps(iv, self.t0, self.t1, spans),
        }
