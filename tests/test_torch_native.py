"""The native LiDAR crop (native/lidar_ops.cpp) through the PyTorch port's
own ctypes loader, against the JAX package's binding of the same library
and the port's numpy fallback (`objects.detections.crop_lidar_for_box`):
tests/test_native.py's scenes (3000 uniform points and a rotated 1.8 x 4.2
x 1.5 m box; a dense 5000-point cluster capped at 100) and a KITTI-like
sweep of 20,000 points with four boxes. The port's binding equals JAX's
exactly in every case, and the numpy fallback exactly wherever no cap
applies. Under the cap both packages' C++ picks the rounded linspace index
and their numpy the truncated one (a quirk the two packages share): the
counts are equal there.
"""

import numpy as np
import pytest

from dspslam_tpu import native as jnative
from dspslam_tpu_torch import native as tnative
from dspslam_tpu_torch.objects import detections as tdet


def _scenes():
    rng = np.random.default_rng(13)
    ones = lambda n: np.ones((n, 1))  # noqa: E731
    uniform = np.concatenate([rng.uniform(-10, 10, (3000, 3)), ones(3000)], -1).astype(np.float32)
    cluster = np.concatenate([rng.normal([2.0, -1.0, 1.0], 0.3, (5000, 3)), ones(5000)], -1).astype(np.float32)
    sweep = np.concatenate([rng.uniform([0, -20, -2], [40, 20, 1], (20000, 3)), rng.uniform(0, 1, (20000, 1))],
                           -1).astype(np.float32)
    yield uniform, np.array([2.0, -1.0, 0.5, 1.8, 4.2, 1.5, 0.7], np.float32), 250
    yield cluster, np.array([2.0, -1.0, 0.0, 3.0, 3.0, 3.0, 0.0], np.float32), 100
    for box in ([10.0, 2.0, -0.8, 1.7, 4.0, 1.5, 0.3], [25.0, -5.0, -0.8, 1.8, 4.5, 1.6, -1.2],
                [6.0, -1.5, -0.5, 2.0, 5.0, 2.0, 3.0], [33.0, 8.0, -1.0, 1.6, 3.9, 1.4, 1.57]):
        yield sweep, np.asarray(box, np.float32), 250


@pytest.mark.parametrize("case", range(6))
def test_crop_equals_jax_binding_and_numpy(case):
    assert tnative.available() and jnative.available()
    velo, box, cap = list(_scenes())[case]
    out = tnative.crop_lidar_box(velo, box, cap)
    np.testing.assert_array_equal(out, jnative.crop_lidar_box(velo, box, cap))
    ref = tdet.crop_lidar_for_box(velo, box, cap)[:, :3]
    if case == 1:
        assert len(out) == len(ref) == 100
    else:
        assert 0 < len(out) < cap
        np.testing.assert_array_equal(out, ref)
