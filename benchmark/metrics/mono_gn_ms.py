"""Mean host time of one joint GN call of the mono object pipeline (the
`mono_gn` span: the call's enqueue up to its result on the host; a first
reconstruction's seed and flip are one B = 2 call), in ms."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "mono_gn")
