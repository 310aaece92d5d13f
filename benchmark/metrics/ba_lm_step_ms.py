"""Mean host time to enqueue one Levenberg-Marquardt step of BA (the
`ba_lm_step` span around each step of backend/ba.py::bundle_adjust), in
ms; absent where no step ran."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "ba_lm_step")
