"""The CUDA graphs of `dspslam_tpu_torch/ops/graphs.py` on the card, through
their two entry points, each against the same solve run eagerly on the
card: the tracker's pose GN (`slam/pose_opt.py` `optimize_pose`) and local
BA (`backend/ba.py` `bundle_adjust`). Every test here needs a CUDA device
and skips without one. The file imports neither JAX nor the JAX package,
so on a machine with a card it runs without the JAX test harness:

    python -m pytest --noconftest tests/test_torch_graphs_cuda.py -q

Pose GN: tolerance 1e-6 on the pose and equal inlier masks, since a replay
launches the kernels the eager GN launches, on the same inputs. Local BA,
on windows at the local mapper's shapes (16 keyframes: 8 free, the oldest
fixed, 8 fixed observers; P points in a bucket of `BA_PT_BUCKETS`, 4P
observation slots, 8 object slots and 32 edge slots): the port's BA
tolerances (1e-4 in poses, 1e-3 in points) and at most 2 observations
classified apart, since the card's scatter-adds sum in the order their
atomics land.
"""

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.backend import ba
from dspslam_tpu_torch.ops import lie_np
from dspslam_tpu_torch.slam import pose_opt
from dspslam_tpu_torch.utils import timing


class Pose:
    """The pose GN: `size` observation slots, `variant` stereo or mono."""

    module, name = pose_opt, "pose"
    INTR = np.array([400.0, 400.0, 240.0, 80.0, 160.0], np.float32)
    SETTINGS = (1e-3, (4, 10), (1.0, 1.0, 1.0, 1.0))
    # (size, seed, variant); one capture per shape, every later call replays
    calls = [(4096, 0, True), (4096, 1, False), (4096, 2, True), (512, 3, False), (512, 4, True)]
    counts = (2, 3)
    outer = (256, 5, True)

    @classmethod
    def problem(cls, size, seed, stereo, device, n_frac=0.4):
        """optimize_pose's inputs: seeded points seen from a perturbed pose
        with pixel noise, a fifth of them outliers, padded to `size` slots."""
        rng = np.random.default_rng(seed)
        fx, fy, cx, cy, bf = cls.INTR.astype(np.float64)
        n = int(size * n_frac)
        T_gt = lie_np.exp_se3(np.r_[rng.normal(0, 0.3, 3), rng.normal(0, 0.05, 3)])
        pc = np.c_[rng.uniform(-6, 6, n), rng.uniform(-2, 2, n), rng.uniform(4, 30, n)]
        pts = (pc - T_gt[:3, 3]) @ T_gt[:3, :3]
        obs = np.c_[fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy, np.zeros(n)]
        obs[:, 2] = obs[:, 0] - bf / pc[:, 2]
        obs += rng.normal(0, 0.7, (n, 3))
        outl = rng.uniform(size=n) < 0.2
        obs[outl, :2] += rng.uniform(-40, 40, (outl.sum(), 2))

        def pad(a, fill=0.0):
            return np.concatenate([a, np.full((size - n,) + a.shape[1:], fill)])

        smask = np.full(n, 1.0 if stereo else 0.0)
        if not stereo:
            obs[:, 2] = 0.0
        T0 = lie_np.exp_se3(rng.normal(0, 0.02, 6)) @ T_gt
        arrays = [T0, pad(pts), pad(obs), pad(1.0 / 1.2 ** (2 * rng.integers(0, 3, n)), 1.0),
                  pad(np.ones(n)), pad(smask), cls.INTR]
        return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in arrays)

    @classmethod
    def eager(cls, args):
        return pose_opt._gauss_newton(*args, *cls.SETTINGS)

    @staticmethod
    def solve(args):
        return pose_opt.optimize_pose(*args)

    @staticmethod
    def assert_close(out, ref):
        assert (out[0] - ref[0]).abs().max().item() <= 1e-6
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])

    @staticmethod
    def assert_fit(out, args, size):
        assert 0.3 * size * 0.4 < out[2].item() <= size * 0.4      # a fit, not a stale or empty result

    @staticmethod
    def tensors(out):
        return tuple(out)


class BA:
    """Local BA: P = `size` point slots, `variant` with objects or not."""

    module, name = ba, "ba"
    INTR = np.array([707.0912, 707.0912, 601.8873, 183.1104, 379.8145], np.float32)
    K, M, Q = 16, 8, 32
    calls = [(1024, 0, True), (1024, 1, True), (1024, 2, True), (2048, 3, False), (2048, 4, False)]
    counts = (2, 3)
    outer = (1024, 5, True)

    @classmethod
    def problem(cls, P, seed, objects, device):
        """bundle_adjust's arguments for a seeded street window: cameras 0.5 m
        apart along z, points 8-40 m ahead seen by 2-4 keyframes each with
        0.5 px noise, two thirds of them stereo, 5% gross outliers; free poses
        and points perturbed. With `objects`, 5 objects and 20 edges whose
        measurements carry small pose noise."""
        K, M, Q = cls.K, cls.M, cls.Q
        rng = np.random.default_rng(seed)
        fx, fy, cx, cy, bf = cls.INTR.astype(np.float64)
        poses_true = np.stack([lie_np.exp_se3(np.r_[0.0, 0.0, -0.5 * k, 0.0, 0.01 * k, 0.0]) for k in range(K)])
        n = int(0.8 * P)
        pts_true = np.c_[rng.uniform(-8, 8, n), rng.uniform(-2, 2, n), rng.uniform(16, 48, n)]
        O = 4 * P
        obs_kf, obs_pt, obs_uvr, obs_stereo = [], [], [], []
        for p in range(n):
            for k in rng.choice(K, rng.integers(2, 5), replace=False):
                pc = poses_true[k, :3, :3] @ pts_true[p] + poses_true[k, :3, 3]
                u, v = fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy
                stereo = rng.uniform() < 2 / 3
                obs_kf.append(k)
                obs_pt.append(p)
                obs_uvr.append([u, v, u - bf / pc[2] if stereo else 0.0])
                obs_stereo.append(float(stereo))
        m = min(len(obs_kf), O)
        uvr = np.asarray(obs_uvr[:m]) + rng.normal(0, 0.5, (m, 3)) * np.c_[np.ones((m, 2)), obs_stereo[:m]]
        outl = rng.uniform(size=m) < 0.05
        uvr[outl, :2] += rng.uniform(-30, 30, (outl.sum(), 2))

        def pad(a, length, fill=0.0):
            a = np.asarray(a, np.float64)
            return np.concatenate([a, np.full((length - len(a),) + a.shape[1:], fill)])

        kf_fixed = np.r_[1.0, np.zeros(7), np.ones(K - 8)]
        kf_poses = poses_true.copy()
        for k in range(1, 8):
            kf_poses[k] = lie_np.exp_se3(rng.normal(0, 0.01, 6)) @ kf_poses[k]
        points = pad(pts_true + rng.normal(0, 0.05, pts_true.shape), P)
        arrays = [kf_poses, kf_fixed, points, pad(np.ones(n), P), pad(obs_kf[:m], O), pad(obs_pt[:m], O),
                  pad(uvr, O), pad(obs_stereo[:m], O), pad(1.0 / 1.2 ** (2 * rng.integers(0, 4, m)), O, 1.0),
                  pad(np.ones(m), O), cls.INTR]
        args = tuple(torch.from_numpy(np.asarray(a, np.int32 if i in (4, 5) else np.float32)).to(device)
                     for i, a in enumerate(arrays))
        if not objects:
            return args, None
        T_wo = np.stack([np.eye(4)] * M)
        for o in range(5):
            T_wo[o] = lie_np.exp_se3(np.r_[rng.uniform(-6, 6), 0.8, rng.uniform(14, 30), 0.0,
                                           rng.uniform(-1, 1), 0.0])
        edge_kf, edge_obj = rng.integers(0, 8, 20), rng.integers(0, 5, 20)
        edge_Tco = np.stack([lie_np.exp_se3(rng.normal(0, 0.02, 6)) @ poses_true[k] @ T_wo[o]
                             for k, o in zip(edge_kf, edge_obj)])
        start = T_wo.copy()
        for o in range(5):
            start[o] = lie_np.exp_se3(rng.normal(0, 0.03, 6)) @ start[o]
        obj = {"poses": start, "fixed": np.r_[np.zeros(5), np.ones(M - 5)], "edge_kf": pad(edge_kf, Q),
               "edge_obj": pad(edge_obj, Q),
               "edge_Tco": np.concatenate([edge_Tco, np.tile(np.eye(4), (Q - 20, 1, 1))]),
               "edge_valid": pad(np.ones(20), Q)}
        obj = {k: torch.from_numpy(np.asarray(v, np.int32 if k in ("edge_kf", "edge_obj") else np.float32))
               .to(device) for k, v in obj.items()}
        return args, obj

    @staticmethod
    def eager(args):
        return ba._adjust(args[0], 1e-3, args[1], (5, 10), card=True)

    @staticmethod
    def solve(args):
        return ba.bundle_adjust(*args[0], 1e-3, args[1])

    @staticmethod
    def assert_close(out, ref):
        for key in ("kf_poses", "obj_poses"):
            assert out[key].shape == ref[key].shape
            assert out[key].numel() == 0 or (out[key] - ref[key]).abs().max().item() <= 1e-4, key
        assert (out["points"] - ref["points"]).abs().max().item() <= 1e-3
        assert (out["obs_inlier"] != ref["obs_inlier"]).sum().item() <= 2
        assert torch.equal(out["obj_edge_inlier"], ref["obj_edge_inlier"])

    @staticmethod
    def assert_fit(out, args, size):
        # a fit, not a stale or empty result: the outliers dropped, the rest kept
        assert 0.85 < out["obs_inlier"].sum().item() / args[0][9].sum().item() < 0.97
        assert (out["kf_poses"] - args[0][0]).abs().max().item() > 1e-3

    @staticmethod
    def tensors(out):
        return tuple(out[k] for k in sorted(out))


@pytest.fixture(params=[Pose, BA], ids=["pose", "ba"])
def entry(request, monkeypatch):
    """An entry point on the card with TF32 off, from an empty graph cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(request.param.module.CUDA_GRAPHS, "cache", {})
    return request.param


def captures_and_replays(entry):
    t = timing.totals()
    return t.get(f"{entry.name}_graph_capture", 0), t.get(f"{entry.name}_graph_replay", 0)


@pytest.mark.cuda
def test_graph_matches_eager_counts_and_keeps_results(entry):
    c0, r0 = captures_and_replays(entry)
    kept = []
    for size, seed, variant in entry.calls:
        args = entry.problem(size, seed, variant, torch.device("cuda"))
        ref = entry.eager(args)
        out = entry.solve(args)
        torch.cuda.synchronize()
        entry.assert_close(out, ref)
        entry.assert_fit(out, args, size)
        kept.append((out, tuple(t.clone() for t in entry.tensors(out))))
    c1, r1 = captures_and_replays(entry)
    assert (c1 - c0, r1 - r0) == entry.counts
    assert len(entry.module.CUDA_GRAPHS.cache) == 2
    # later replays write the graphs' static state, never a returned tensor
    for out, snapshot in kept:
        assert all(torch.equal(a, b) for a, b in zip(entry.tensors(out), snapshot))


@pytest.mark.cuda
def test_tf32_switch_captures_a_new_key(entry):
    size, seed, variant = entry.calls[0]
    args = entry.problem(size, seed, variant, torch.device("cuda"))
    ref = entry.eager(args)
    c0, r0 = captures_and_replays(entry)
    entry.solve(args)
    torch.backends.cuda.matmul.allow_tf32 = True        # the entry fixture restores it
    entry.solve(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = entry.solve(args)
    torch.cuda.synchronize()
    c1, r1 = captures_and_replays(entry)
    assert (c1 - c0, r1 - r0) == (2, 1)
    assert len(entry.module.CUDA_GRAPHS.cache) == 2
    entry.assert_close(out, ref)


@pytest.mark.cuda
def test_eager_inside_an_outer_capture(entry):
    args = entry.problem(*entry.outer, torch.device("cuda"))
    ref = entry.eager(args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        entry.eager(args)                                  # the outer graph's warm-up
    torch.cuda.current_stream().wait_stream(stream)
    counts = captures_and_replays(entry)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer, stream=stream):
        out = entry.solve(args)
    assert captures_and_replays(entry) == counts and not entry.module.CUDA_GRAPHS.cache
    outer.replay()
    torch.cuda.synchronize()
    entry.assert_close(out, ref)
