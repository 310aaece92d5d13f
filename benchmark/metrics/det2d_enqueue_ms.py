"""Mean host time to enqueue Mask R-CNN for a keyframe (the
`det2d_dispatch` span of `Detector2D.dispatch`: the upload, the resize and
every launch up to the pinned copies of its outputs), in ms."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "det2d_dispatch")
