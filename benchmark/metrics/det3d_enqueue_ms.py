"""Mean host time to enqueue PointPillars for a keyframe (the
`det3d_dispatch` span of `Detector3D.dispatch`: the crop, the quantization,
the upload and every launch up to the pinned copies of its boxes), in ms."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "det3d_dispatch")
