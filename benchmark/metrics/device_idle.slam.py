"""Share of the traced part of a SLAM window in which no operation ran on
the device: 100 (1 - the union of device intervals / the window), in %."""

from benchmark.metrics._common import idle_percent


def read(run):
    return idle_percent(run)
