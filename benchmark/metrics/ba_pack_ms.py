"""Mean host time to pack one local BA window (the local mapper's
`ba_pack` span: the window's keyframes, points, observations and object
edges, and their upload), in ms; absent where no window was packed."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "ba_pack")
