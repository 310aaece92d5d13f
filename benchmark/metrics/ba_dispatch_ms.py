"""Mean host time to enqueue one local BA solve (the local mapper's
`ba_dispatch` span), in ms; absent where no solve was dispatched."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "ba_dispatch")
