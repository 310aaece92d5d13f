"""Arithmetic the metric readers share (a module of its own: no metric is
named `_common`)."""

from __future__ import annotations

import numpy as np


def mean_ms(run, span: str):
    """Mean duration of a host span over the untraced part of the window,
    in ms; None if the span never opened there."""
    d = run.untraced(span)
    return 1e3 * float(np.mean(d)) if d else None


def idle_percent(run):
    """Share of the traced window in which no operation ran on the device."""
    r = run.trace_reduced
    if r is None or r["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics
    (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
