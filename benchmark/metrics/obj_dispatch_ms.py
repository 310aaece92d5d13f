"""Mean host time to enqueue a keyframe's object GN calls (the local
mapper's `kf_obj_dispatch` span), in ms."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "kf_obj_dispatch")
