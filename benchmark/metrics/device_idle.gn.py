"""Share of the traced part of the GN window in which no operation ran on
the device, in %."""

from benchmark.metrics._common import idle_percent


def read(run):
    return idle_percent(run)
