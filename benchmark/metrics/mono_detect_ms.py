"""Mean host time of a mono keyframe's online detection (the `detect_mono`
span of `datasets.mono.detect_online_mono`: Mask R-CNN's enqueue, the wait
for its outputs, the validity filter and the largest-mask detection), in
ms."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "detect_mono")
