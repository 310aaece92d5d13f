"""The port's rotated BEV IoU (dspslam_tpu_torch/ops/rotated_iou.py) against
dspslam_tpu/ops/rotated_iou.py on identical, disjoint, nested, crossed and
random box pairs (seeded numpy). Tolerance 1e-5 on the IoU: both clip in
f32, and the port batches the (N, M) pairs where JAX maps them one by one.
"""

import numpy as np
import pytest
import torch

from dspslam_tpu.ops import rotated_iou as jriou
from dspslam_tpu_torch.ops import rotated_iou as triou
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _box(x, y, w, l, yaw):
    return [x, y, -1.0, w, l, 1.5, yaw]


CASES = {
    "identical": ([_box(1.0, 2.0, 1.6, 3.9, 0.3)], [_box(1.0, 2.0, 1.6, 3.9, 0.3)], 1.0),
    "disjoint": ([_box(0.0, 0.0, 1.6, 3.9, 0.0)], [_box(10.0, 0.0, 1.6, 3.9, 0.0)], 0.0),
    "nested": ([_box(0.0, 0.0, 1.0, 1.0, 0.2)], [_box(0.0, 0.0, 2.0, 2.0, 0.2)], 0.25),
    # a 1 x 4 bar crossed by its 90-degree turn: intersection 1, union 7
    "crossed": ([_box(0.0, 0.0, 1.0, 4.0, 0.0)], [_box(0.0, 0.0, 1.0, 4.0, np.pi / 2)], 1.0 / 7.0),
}


def _both(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    j = np.asarray(jriou.rotated_iou_matrix(a, b))
    t = triou.rotated_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    return j, t


@pytest.mark.parametrize("case", sorted(CASES))
def test_planted_pairs(case):
    a, b, want = CASES[case]
    j, t = _both(a, b)
    assert t.shape == (1, 1)
    np.testing.assert_allclose(t, j, atol=TOL)
    assert t[0, 0] == pytest.approx(want, abs=1e-5)


def test_random_pairs_match_jax():
    rng = np.random.default_rng(11)

    def boxes(n):
        b = np.zeros((n, 7), np.float32)
        b[:, :2] = rng.uniform(-3, 3, (n, 2))
        b[:, 3:5] = rng.uniform(0.3, 4.0, (n, 2))
        b[:, 6] = rng.uniform(-np.pi, np.pi, n)
        return b

    a, b = boxes(40), boxes(30)
    b[:6] = a[:6]                        # some identical pairs
    j, t = _both(a, b)
    assert t.shape == (40, 30) and 0.2 < (t > 0).mean() < 0.9
    np.testing.assert_allclose(t, j, atol=TOL)
    assert np.all(t >= 0) and np.all(t <= 1 + 1e-6)


def test_corners_counter_clockwise_and_degenerate():
    b = torch.tensor([_box(0.0, 0.0, 2.0, 4.0, 0.7)])
    c = triou.box_corners_bev(b)[0].numpy()
    np.testing.assert_allclose(c, np.asarray(jriou.box_corners_bev(b.numpy()))[0], atol=1e-6)
    area2 = sum(c[i, 0] * c[(i + 1) % 4, 1] - c[(i + 1) % 4, 0] * c[i, 1] for i in range(4))
    assert area2 == pytest.approx(2 * 8.0, rel=1e-5)          # CCW: positive signed area
    zero = torch.tensor([_box(0.0, 0.0, 0.0, 0.0, 0.0)])
    assert triou.rotated_iou_matrix(zero, zero).item() == 0.0
