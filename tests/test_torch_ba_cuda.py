"""Local BA's CUDA graphs (backend/ba.py `BAGraph`) on the card, against the
same solve run eagerly on the card. Every test here needs a CUDA device and
skips without one. The file imports neither JAX nor the JAX package, so on
a machine with a card it runs without the JAX test harness:

    python -m pytest --noconftest tests/test_torch_ba_cuda.py -q

Windows at the local mapper's shapes: 16 keyframes (8 free, the oldest
fixed, 8 fixed observers), P points in a bucket of `BA_PT_BUCKETS`, 4P
observation slots, 8 object slots and 32 edge slots. Tolerances: the
port's BA tolerances (1e-4 in poses, 1e-3 in points) and at most 2
observations classified apart: a replay launches the kernels the eager
solve launches, but the card's scatter-adds sum in the order their atomics
land.
"""

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.backend import ba
from dspslam_tpu_torch.ops import lie_np
from dspslam_tpu_torch.utils import timing

INTR = np.array([707.0912, 707.0912, 601.8873, 183.1104, 379.8145], np.float32)
K, M, Q = 16, 8, 32


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(ba, "_GRAPHS", {})
    return torch.device("cuda")


def window(seed, P, objects, device):
    """bundle_adjust's arguments for a seeded street window: cameras 0.5 m
    apart along z, points 8-40 m ahead seen by 2-4 keyframes each with
    0.5 px noise, two thirds of them stereo, 5% gross outliers; free poses
    and points perturbed. With `objects`, 5 objects and 20 edges whose
    measurements carry small pose noise."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, bf = INTR.astype(np.float64)
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
    arrays = [kf_poses, kf_fixed, points, pad(np.ones(n), P), pad(obs_kf[:m], O), pad(obs_pt[:m], O), pad(uvr, O),
              pad(obs_stereo[:m], O), pad(1.0 / 1.2 ** (2 * rng.integers(0, 4, m)), O, 1.0), pad(np.ones(m), O),
              INTR]
    args = tuple(torch.from_numpy(np.asarray(a, np.int32 if i in (4, 5) else np.float32)).to(device)
                 for i, a in enumerate(arrays))
    if not objects:
        return args, None
    T_wo = np.stack([np.eye(4)] * M)
    for o in range(5):
        T_wo[o] = lie_np.exp_se3(np.r_[rng.uniform(-6, 6), 0.8, rng.uniform(14, 30), 0.0, rng.uniform(-1, 1), 0.0])
    edge_kf, edge_obj = rng.integers(0, 8, 20), rng.integers(0, 5, 20)
    edge_Tco = np.stack([lie_np.exp_se3(rng.normal(0, 0.02, 6)) @ poses_true[k] @ T_wo[o]
                         for k, o in zip(edge_kf, edge_obj)])
    start = T_wo.copy()
    for o in range(5):
        start[o] = lie_np.exp_se3(rng.normal(0, 0.03, 6)) @ start[o]
    obj = {"poses": start, "fixed": np.r_[np.zeros(5), np.ones(M - 5)], "edge_kf": pad(edge_kf, Q),
           "edge_obj": pad(edge_obj, Q), "edge_Tco": np.concatenate([edge_Tco, np.tile(np.eye(4), (Q - 20, 1, 1))]),
           "edge_valid": pad(np.ones(20), Q)}
    obj = {k: torch.from_numpy(np.asarray(v, np.int32 if k in ("edge_kf", "edge_obj") else np.float32)).to(device)
           for k, v in obj.items()}
    return args, obj


def captures_and_replays():
    t = timing.totals()
    return t.get("ba_graph_capture", 0), t.get("ba_graph_replay", 0)


def assert_close(out, ref):
    for key in ("kf_poses", "obj_poses"):
        assert out[key].shape == ref[key].shape
        assert out[key].numel() == 0 or (out[key] - ref[key]).abs().max().item() <= 1e-4, key
    assert (out["points"] - ref["points"]).abs().max().item() <= 1e-3
    assert (out["obs_inlier"] != ref["obs_inlier"]).sum().item() <= 2
    assert torch.equal(out["obj_edge_inlier"], ref["obj_edge_inlier"])


@pytest.mark.cuda
def test_graph_matches_eager_counts_and_keeps_results(cuda):
    calls = [(1024, True, 0), (1024, True, 1), (1024, True, 2), (2048, False, 3), (2048, False, 4)]
    c0, r0 = captures_and_replays()
    kept = []
    for P, objects, seed in calls:
        args, obj = window(seed, P, objects, cuda)
        ref = ba._adjust(args, 1e-3, obj, (5, 10), card=True)
        out = ba.bundle_adjust(*args, 1e-3, obj)
        torch.cuda.synchronize()
        assert_close(out, ref)
        # a fit, not a stale or empty result: the outliers dropped, the rest kept
        assert 0.85 < out["obs_inlier"].sum().item() / args[9].sum().item() < 0.97
        assert (out["kf_poses"] - args[0]).abs().max().item() > 1e-3
        kept.append((out, {k: v.clone() for k, v in out.items()}))
    c1, r1 = captures_and_replays()
    assert (c1 - c0, r1 - r0) == (2, 3)        # one capture per key; every later solve replays
    assert len(ba._GRAPHS) == 2
    # later solves write the graphs' static carry, never a returned tensor
    for out, snapshot in kept:
        assert all(torch.equal(out[k], snapshot[k]) for k in out)


@pytest.mark.cuda
def test_eager_inside_an_outer_capture(cuda):
    args, obj = window(5, 1024, True, cuda)
    ref = ba._adjust(args, 1e-3, obj, (5, 10), card=True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ba._adjust(args, 1e-3, obj, (5, 10), card=True)          # the outer graph's warm-up
    torch.cuda.current_stream().wait_stream(stream)
    counts = captures_and_replays()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer, stream=stream):
        out = ba.bundle_adjust(*args, 1e-3, obj)
    assert captures_and_replays() == counts and not ba._GRAPHS
    outer.replay()
    torch.cuda.synchronize()
    assert_close(out, ref)
