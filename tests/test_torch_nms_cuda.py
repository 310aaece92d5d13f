"""The greedy-NMS kernel (csrc/greedy_nms.cu) on the card against its plain
version, the eager loop of kernels/greedy_nms.py, run on the CPU: picks,
scores and ok equal, round for round, on the same overlap matrices (built
on the CPU and copied to the card). Every test here needs a CUDA device and
skips without one. The file imports neither JAX nor the JAX package, so on
a machine with a card it runs without the JAX test harness:

    python -m pytest --noconftest tests/test_torch_nms_cuda.py -q

Shapes: the kitti_detect cell's three calls (benchmark/configs/
kitti_04_12_online.json): the RPN's 4441 candidates (1000 a level on P2-P5,
P6's 441) and 1000 rounds with its per-level mask, the R-CNN's 1000 and 100
rounds, PointPillars' 100 and 50 rounds over rotated overlaps; then every
block size the launch picks, planted ties, fewer live candidates than
rounds, and scores and overlaps exactly at their thresholds.
"""

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.detect import maskrcnn
from dspslam_tpu_torch.kernels import greedy_nms
from dspslam_tpu_torch.ops.rotated_iou import rotated_iou_matrix
from dspslam_tpu_torch.utils import timing


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_kernel_is_loop(cuda, iou, scores, k, iou_thresh, dead, keep_thresh, inclusive):
    """The kernel's (picks, scores, ok) equal the CPU loop's; returns the
    loop's."""
    want = greedy_nms.greedy_suppress(iou, scores, k, iou_thresh, dead, keep_thresh, inclusive)
    got = greedy_nms.greedy_suppress(iou.to(cuda), scores.to(cuda), k, iou_thresh, dead, keep_thresh, inclusive)
    torch.cuda.synchronize()
    for name, w, g in zip(("picks", "scores", "ok"), want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        g = g.cpu()
        differ = (g != w) & ~(torch.isnan(g.float()) & torch.isnan(w.float()))
        assert not differ.any(), f"{name} first differs at round {int(differ.nonzero()[0])}"
    return want


def xyxy(rng, n, size, hw):
    """n boxes of about `size` px (one size per box) inside an (h, w) image."""
    h, w = hw
    c = rng.uniform((0, 0), (w, h), (n, 2))
    wh = size[:, None] * np.exp(rng.normal(0, 0.4, (n, 2)))
    b = np.concatenate([c - wh / 2, c + wh / 2], 1)
    return torch.from_numpy(np.clip(b, 0, (w, h, w, h)).astype(np.float32))


def rpn_case(seed):
    """The RPN's call: top-k logits per level (two decimals: ties), boxes of
    8 x stride, suppression within each level only."""
    rng = np.random.default_rng(seed)
    counts, strides = (1000, 1000, 1000, 1000, 441), (4, 8, 16, 32, 64)
    size = np.concatenate([np.full(c, 8.0 * s) for c, s in zip(counts, strides)])
    boxes = xyxy(rng, size.size, size, (404, 1333))
    scores = torch.from_numpy(np.concatenate(
        [-np.sort(-np.round(rng.normal(0, 2, c), 2)) for c in counts]).astype(np.float32))
    groups = torch.from_numpy(np.repeat(np.arange(5), counts))
    iou = maskrcnn.iou_matrix(boxes, boxes)
    iou = torch.where(groups[:, None] == groups[None, :], iou, 0.0)
    return iou, scores, 1000, 0.7, -1e9, -1e9, False


def rcnn_case(seed):
    """The R-CNN's call: 1000 decoded boxes, best class probabilities, a
    tenth of the proposals invalid (score 0)."""
    rng = np.random.default_rng(seed)
    boxes = xyxy(rng, 1000, rng.uniform(20, 200, 1000), (404, 1333))
    p = rng.dirichlet(np.full(81, 0.05), 1000)[:, 1:].max(1) * (rng.uniform(size=1000) > 0.1)
    return maskrcnn.iou_matrix(boxes, boxes), torch.from_numpy(p.astype(np.float32)), 100, 0.5, -1e9, 0.05, False


def pointpillars_case(seed):
    """PointPillars' call: the top 100 cars (sigmoid scores in top-k order),
    a third of them beside another, rotated BEV overlaps."""
    rng = np.random.default_rng(seed)
    b = np.zeros((100, 7), np.float32)
    b[:, :2] = rng.uniform((0, -39.68), (69.12, 39.68), (100, 2))
    b[:, 2] = -1.78
    b[:, 3:6] = np.array([1.6, 3.9, 1.56]) * np.exp(rng.normal(0, 0.1, (100, 3)))
    b[:, 6] = rng.uniform(-np.pi, np.pi, 100)
    b[60:, :2] = b[:40, :2] + rng.normal(0, 1.0, (40, 2))
    boxes = torch.from_numpy(b)
    scores = torch.sigmoid(torch.from_numpy(-np.sort(-rng.normal(-1, 2, 100)).astype(np.float32)))
    return rotated_iou_matrix(boxes, boxes), scores, 50, 0.01, -1.0, 0.1, True


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", [rpn_case, rcnn_case, pointpillars_case], ids=["rpn", "rcnn", "pointpillars"])
def test_kernel_matches_loop_at_the_cells_shapes(cuda, case, seed):
    iou, scores, k, *rest = case(seed)
    picks, _, ok = assert_kernel_is_loop(cuda, iou, scores, k, *rest)
    assert ok.any() and len(set(picks[ok].tolist())) == int(ok.sum())


@pytest.mark.cuda
# one block of min(1024, n rounded up to a warp) threads, 1-8 candidates a
# thread; a keep threshold of -inf keeps the dead picks too (they suppress)
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1023, 1024, 1025, 2049, 3073, 4096, 5000, 7169, 8191, 8192])
@pytest.mark.parametrize("keep", [(-np.inf, False), (0.5, True)], ids=["keep_all", "keep_half"])
def test_kernel_matches_loop_at_every_block_size(cuda, n, keep):
    g = torch.Generator().manual_seed(n)
    iou = torch.rand(n, n, generator=g) ** 8                 # sparse overlaps above 0.5
    scores = torch.randint(0, 10, (n,), generator=g).float() / 10     # ties everywhere
    assert_kernel_is_loop(cuda, iou, scores, min(n, 300) + 5, 0.5, -1e9, *keep)


@pytest.mark.cuda
def test_planted_ties_and_nan(cuda):
    """Equal scores: the lowest live index each round; a NaN is picked
    before every number (torch.argmax's order), and never kept."""
    g = torch.Generator().manual_seed(3)
    iou = torch.rand(2000, 2000, generator=g) ** 16
    scores = torch.full((2000,), 0.5)
    picks, _, _ = assert_kernel_is_loop(cuda, iou, scores, 100, 0.3, -1e9, 0.05, False)
    assert picks[0] == 0
    scores[[7, 1500]] = float("nan")
    picks, _, ok = assert_kernel_is_loop(cuda, iou, scores, 100, 0.3, -1e9, 0.05, False)
    assert picks[:2].tolist() == [7, 1500] and not ok[:2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [(-1e9, False), (-np.inf, False), (0.2, True)], ids=["rpn", "keep_all", "pointpillars"])
def test_fewer_live_candidates_than_rounds(cuda, keep):
    """The rounds past the last live candidate pick index 0 at `dead`."""
    g = torch.Generator().manual_seed(5)
    iou = torch.rand(50, 50, generator=g)
    scores = torch.rand(50, generator=g)
    picks, vals, _ = assert_kernel_is_loop(cuda, iou, scores, 120, 0.6, -1e9, *keep)
    assert picks[-1] == 0 and vals[-1] == -1e9


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [(0.05, False), (0.05, True), (0.1, False), (0.1, True)],
                         ids=["gt_0.05", "ge_0.05", "gt_0.1", "ge_0.1"])
@pytest.mark.parametrize("iou_thresh", [0.01, 0.5, 0.7])
def test_scores_and_overlaps_at_their_thresholds(cuda, keep, iou_thresh):
    """A third of the scores sit on the keep threshold and a third of the
    overlaps on the NMS threshold, each as f32 holds the Python number; few
    overlaps lie above it, so the rounds reach the scores at the threshold."""
    g = torch.Generator().manual_seed(11)
    n = 600
    scores = torch.rand(n, generator=g) * 0.2
    scores[torch.rand(n, generator=g) < 1 / 3] = keep[0]
    iou = torch.where(torch.rand(n, n, generator=g) < 0.02, torch.rand(n, n, generator=g), 0.0)
    iou[torch.rand(n, n, generator=g) < 1 / 3] = iou_thresh
    _, vals, ok = assert_kernel_is_loop(cuda, iou, scores, 700, iou_thresh, -1.0, *keep)
    at = vals == torch.tensor(keep[0])
    assert at.sum() > 10 and bool(ok[at].eq(keep[1]).all())


@pytest.mark.cuda
def test_one_launch_a_call(cuda):
    g = torch.Generator().manual_seed(2)
    boxes = xyxy(np.random.default_rng(2), 300, np.full(300, 40.0), (200, 300))
    scores = torch.rand(300, generator=g)
    before = timing.totals()
    maskrcnn.greedy_nms(boxes.to(cuda), scores.to(cuda), 50, 0.5)
    greedy_nms.greedy_suppress(torch.zeros(9, 9, device=cuda), torch.ones(9, device=cuda), 4, 0.5, -1.0, 0.1, True)
    greedy_nms.greedy_suppress(torch.zeros(9, 9), torch.ones(9), 4, 0.5, -1.0, 0.1, True)      # the CPU: the loop
    torch.cuda.synchronize()
    after = timing.totals()
    assert after.get("nms_launches", 0) - before.get("nms_launches", 0) == 2
    assert after["det2d_nms_rounds"] - before.get("det2d_nms_rounds", 0) == 50


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["above_cap", "not_contiguous", "not_f32", "lengths"])
def test_wrapper_refuses(cuda, case):
    n = greedy_nms.MAX_N + 1 if case == "above_cap" else 64
    iou = torch.zeros(n, n, device=cuda)
    scores = torch.ones(n, device=cuda)
    if case == "not_contiguous":
        iou = torch.zeros(n, 2 * n, device=cuda)[:, ::2]
    elif case == "not_f32":
        iou = iou.double()
    elif case == "lengths":
        scores = torch.ones(n - 1, device=cuda)
    before = timing.totals().get("nms_launches", 0)
    with pytest.raises(ValueError, match="greedy_nms"):
        greedy_nms.greedy_suppress(iou, scores, 10, 0.5, -1.0, 0.1)
    assert timing.totals().get("nms_launches", 0) == before
