"""The greedy-NMS entry of dspslam_tpu_torch/kernels/greedy_nms.py on the CPU:
the keep test of the plain loop (strict or inclusive, in f32) and the input
checks the CUDA wrapper makes before it launches. The kernel itself runs
only on the card (tests/test_torch_nms_cuda.py holds it to the loop); the
loop is held to the JAX package through the detectors' planted-ties tests
(test_torch_maskrcnn.py, test_torch_pointpillars.py).
"""

import pytest
import torch

from dspslam_tpu_torch.kernels import greedy_nms
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("inclusive,kept", [(False, [1, 0, 0, 0]), (True, [1, 1, 1, 0])],
                         ids=["strict", "inclusive"])
def test_keep_test_on_the_threshold(inclusive, kept):
    # f32(0.1) lies above the double 0.1: the comparison is in f32, so a
    # score of 0.1 is at the threshold, not above it
    scores = torch.tensor([0.9, 0.1, 0.1, 0.05])
    iou = torch.zeros(4, 4)
    j, s, ok = greedy_nms.greedy_suppress(iou, scores, 4, 0.5, -1.0, 0.1, inclusive)
    assert j.tolist() == [0, 1, 2, 3] and j.dtype == torch.int64
    assert torch.equal(s, scores)
    assert ok.tolist() == [bool(x) for x in kept] and ok.dtype == torch.bool


def test_only_a_kept_pick_suppresses():
    # 0 overlaps 1 exactly at the threshold (no suppression) and 2 above
    # it; 3 overlaps 4. Kept, the pick of 3 suppresses 4, and the rounds
    # after the last live slot pick index 0 at `dead`; not kept, it does
    # not, and 4 is picked next
    iou = torch.eye(5)
    iou[0, 1] = iou[1, 0] = 0.5
    iou[0, 2] = iou[2, 0] = 0.75
    iou[3, 4] = iou[4, 3] = 0.9
    scores = torch.tensor([0.9, 0.8, 0.7, 0.02, 0.01])
    j, s, ok = greedy_nms.greedy_suppress(iou, scores, 6, 0.5, -1e9, 0.0)
    assert j.tolist() == [0, 1, 3, 0, 0, 0]
    assert s.tolist()[-3:] == [-1e9] * 3
    assert ok.tolist() == [True, True, True, False, False, False]
    j, _, ok = greedy_nms.greedy_suppress(iou, scores, 4, 0.5, -1e9, 0.05)
    assert j.tolist() == [0, 1, 3, 4] and ok.tolist() == [True, True, False, False]


def _bad(case):
    n = 6
    iou, scores, k = torch.zeros(n, n), torch.ones(n), 3
    if case == "above_cap":
        n = greedy_nms.MAX_N + 1
        iou, scores = torch.empty(n, n), torch.ones(n)      # pages never touched
    elif case == "not_contiguous":
        iou = torch.zeros(n, 2 * n)[:, ::2]
    elif case == "scores_strided":
        scores = torch.ones(2 * n)[::2]
    elif case == "not_f32":
        iou = iou.double()
    elif case == "lengths":
        scores = torch.ones(n + 1)
    elif case == "scores_f64":
        scores = scores.double()
    elif case == "no_rounds":
        k = 0
    return iou, scores, k


@pytest.mark.parametrize("case,says", [
    ("above_cap", "the kernel takes 1 to"), ("not_contiguous", "contiguous"), ("scores_strided", "contiguous"),
    ("not_f32", "iou must be float32"), ("lengths", "iou must be float32"), ("scores_f64", "scores must be float32"),
    ("no_rounds", "k must be"),
])
def test_check_refuses(case, says):
    with pytest.raises(ValueError, match=says):
        greedy_nms.check(*_bad(case))


@pytest.mark.parametrize("n,k", [(4441, 1000), (1000, 100), (100, 50), (1, 1), (greedy_nms.MAX_N, 3)])
def test_check_takes_the_cells_shapes(n, k):
    greedy_nms.check(torch.empty(n, n), torch.empty(n), k)
