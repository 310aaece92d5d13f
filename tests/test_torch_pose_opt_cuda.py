"""The pose GN's CUDA graph (slam/pose_opt.py `PoseGraph`) on the card,
against the same GN run eagerly on the card. Every test here needs a CUDA
device and skips without one. The file imports neither JAX nor the JAX
package, so on a machine with a card it runs without the JAX test harness:

    python -m pytest --noconftest tests/test_torch_pose_opt_cuda.py -q

Tolerance 1e-6 on the pose: a replay launches the kernels the eager GN
launches, on the same inputs.
"""

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.ops import lie_np
from dspslam_tpu_torch.slam import pose_opt
from dspslam_tpu_torch.utils import timing

INTR = np.array([400.0, 400.0, 240.0, 80.0, 160.0], np.float32)
SETTINGS = (1e-3, (4, 10), (1.0, 1.0, 1.0, 1.0))


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(pose_opt, "_GRAPHS", {})
    return torch.device("cuda")


def problem(seed, stereo, cap, device, n_frac=0.4):
    """optimize_pose's inputs: seeded points seen from a perturbed pose with
    pixel noise, a fifth of them outliers, padded to `cap` slots."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, bf = INTR.astype(np.float64)
    n = int(cap * n_frac)
    T_gt = lie_np.exp_se3(np.r_[rng.normal(0, 0.3, 3), rng.normal(0, 0.05, 3)])
    pc = np.c_[rng.uniform(-6, 6, n), rng.uniform(-2, 2, n), rng.uniform(4, 30, n)]
    pts = (pc - T_gt[:3, 3]) @ T_gt[:3, :3]
    obs = np.c_[fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy, np.zeros(n)]
    obs[:, 2] = obs[:, 0] - bf / pc[:, 2]
    obs += rng.normal(0, 0.7, (n, 3))
    outl = rng.uniform(size=n) < 0.2
    obs[outl, :2] += rng.uniform(-40, 40, (outl.sum(), 2))

    def pad(a, fill=0.0):
        return np.concatenate([a, np.full((cap - n,) + a.shape[1:], fill)])

    smask = np.full(n, 1.0 if stereo else 0.0)
    if not stereo:
        obs[:, 2] = 0.0
    T0 = lie_np.exp_se3(rng.normal(0, 0.02, 6)) @ T_gt
    arrays = [T0, pad(pts), pad(obs), pad(1.0 / 1.2 ** (2 * rng.integers(0, 3, n)), 1.0),
              pad(np.ones(n)), pad(smask), INTR]
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in arrays)


def captures_and_replays():
    t = timing.totals()
    return t.get("pose_graph_capture", 0), t.get("pose_graph_replay", 0)


def assert_close(out, ref):
    assert (out[0] - ref[0]).abs().max().item() <= 1e-6
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])


@pytest.mark.cuda
def test_graph_matches_eager_counts_and_keeps_results(cuda):
    calls = [(4096, 0, True), (4096, 1, False), (4096, 2, True), (512, 3, False), (512, 4, True)]
    c0, r0 = captures_and_replays()
    kept = []
    for cap, seed, stereo in calls:
        args = problem(seed, stereo, cap, cuda)
        ref = pose_opt._gauss_newton(*args, *SETTINGS)
        out = pose_opt.optimize_pose(*args)
        torch.cuda.synchronize()
        assert_close(out, ref)
        assert 0.3 * cap * 0.4 < out[2].item() <= cap * 0.4      # a fit, not a stale or empty result
        kept.append((out, tuple(t.clone() for t in out)))
    c1, r1 = captures_and_replays()
    assert (c1 - c0, r1 - r0) == (2, 1)        # one capture per shape, a replay for the third 4096 call
    assert len(pose_opt._GRAPHS) == 2
    # later replays write the graph's static outputs, never a returned tensor
    for out, snapshot in kept:
        assert all(torch.equal(a, b) for a, b in zip(out, snapshot))


@pytest.mark.cuda
def test_eager_inside_an_outer_capture(cuda):
    args = problem(5, True, 256, cuda)
    ref = pose_opt._gauss_newton(*args, *SETTINGS)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pose_opt._gauss_newton(*args, *SETTINGS)           # the outer graph's warm-up
    torch.cuda.current_stream().wait_stream(stream)
    counts = captures_and_replays()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer, stream=stream):
        out = pose_opt.optimize_pose(*args)
    assert captures_and_replays() == counts and not pose_opt._GRAPHS
    outer.replay()
    torch.cuda.synchronize()
    assert_close(out, ref)
