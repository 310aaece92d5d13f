"""Mean host time to enqueue one iteration of the object GN (the `gn_iter`
span around each iteration of shape/gn.py::reconstruct_object: the SDF
term, the render grid and its K1 rows, the solve), in ms; absent where no
iteration ran."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "gn_iter")
