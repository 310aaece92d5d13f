"""Mean host time of a keyframe drain (the system's `keyframe_drain` span,
frames that did keyframe work), in ms."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "keyframe_drain")
