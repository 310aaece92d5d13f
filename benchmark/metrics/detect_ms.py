"""Mean host time of a keyframe's online detection (the `detect` span of
`datasets.kitti.detect_online`: both networks' enqueue and the wait for
their outputs), in ms."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "detect")
