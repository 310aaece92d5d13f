"""Mean host time of the tracker's call per frame (the system's `track`
span), in ms."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "track")
