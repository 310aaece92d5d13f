"""Motion-only pose optimization (frame-to-map reprojection GN).

Port of dspslam_tpu/slam/pose_opt.py (Optimizer::PoseOptimization,
Optimizer.cc:239-451): refine T_cw from matched 3D map points and keypoint
observations with 4 rounds of 10 Gauss-Newton iterations, re-classifying
outliers between rounds at chi2 5.991 (mono) / 7.815 (stereo), with Huber
weights of the same deltas. Mono and stereo observations share a
3-residual layout (the third masked off for mono).

The rounds and iterations are Python loops of a fixed count, and the 6x6
systems are solved without an error check (`torch.linalg.solve_ex` on the
CPU, an elementwise Cholesky on a device), so the whole solve is queued on
the device without a host sync. On a CUDA device the 4 x 10 loop is
captured once per shape as a CUDA graph and replayed (`PoseGraph`): eagerly
it is ~4,000 small launches, whose enqueue, not the device, set the pace.
Matrix products run in full f32 (callers keep TF32 off).
"""

from __future__ import annotations

import torch

from ..ops import lie
from ..ops.linalg import cholesky_solve_spd
from ..utils import timing

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def project_stereo(T_cw, pts_w, fx, fy, cx, cy, bf) -> torch.Tensor:
    """World points -> (u, v, u_right) pixel triplets. (N, 3)."""
    pc = lie.transform_points(T_cw, pts_w)
    zs = torch.clamp(pc[:, 2], min=1e-6)
    u = fx * pc[:, 0] / zs + cx
    v = fy * pc[:, 1] / zs + cy
    return torch.stack([u, v, u - bf / zs], dim=-1)


def _residuals_and_jac(T_cw, pts_w, obs, stereo_mask, fx, fy, cx, cy, bf):
    """Per-observation residual (N, 3) and Jacobian wrt se(3) (N, 3, 6),
    left perturbation T <- exp(dx) T, dx = [v, w]."""
    pc = lie.transform_points(T_cw, pts_w)                # (N, 3)
    x, y = pc[:, 0], pc[:, 1]
    inv_z = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
    inv_z2 = inv_z * inv_z

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    res = torch.stack(
        [u - obs[:, 0], v - obs[:, 1], (ur - obs[:, 2]) * stereo_mask], dim=-1
    )

    zero = torch.zeros_like(x)
    du = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * inv_z2], dim=-1)
    dpix_dpc = torch.stack([du, dv, dur * stereo_mask[:, None]], dim=-2)   # (N, 3, 3)
    J = dpix_dpc @ lie.points_to_pose_jacobian_se3(pc)    # (N, 3, 6)
    return res, J


def _solve(H, b):
    """dx = H^-1 b for the damped 6 x 6 normal equations: `solve_ex` on the
    CPU, `cholesky_solve_spd` on a device (H is J^T W J + damping I)."""
    if H.is_cpu:
        return torch.linalg.solve_ex(H, b).result
    return cholesky_solve_spd(H, b)


def _gauss_newton(T_cw_init, pts_w, obs, inv_sigma2, valid, stereo_mask, intrinsics,
                  damping, rounds_iters, chi2_anneal):
    """The GN of `optimize_pose`; no host sync, so a CUDA graph can hold it."""
    fx, fy, cx, cy, bf = (intrinsics[i] for i in range(5))
    rounds, iters = rounds_iters
    anneal = tuple(chi2_anneal) + (1.0,) * max(0, rounds - len(chi2_anneal))
    chi2_base = torch.where(stereo_mask > 0, CHI2_STEREO, CHI2_MONO)
    damp = damping * torch.eye(6, dtype=pts_w.dtype, device=pts_w.device)

    T = T_cw_init
    inlier = valid
    for r in range(rounds):
        chi2_th = chi2_base * anneal[r]
        for _ in range(iters):
            res, J = _residuals_and_jac(T, pts_w, obs, stereo_mask, fx, fy, cx, cy, bf)
            chi2 = torch.sum(res * res, dim=-1) * inv_sigma2
            hub = torch.where(
                chi2 <= chi2_th, 1.0, torch.sqrt(chi2_th / torch.clamp(chi2, min=1e-12))
            )
            w = inlier * valid * inv_sigma2 * hub
            Jw = (J * w[:, None, None]).reshape(-1, 6)
            H = Jw.t() @ J.reshape(-1, 6) + damp
            b = -(Jw.t() @ res.reshape(-1))
            T = lie.exp_se3(_solve(H, b)) @ T
        res, _ = _residuals_and_jac(T, pts_w, obs, stereo_mask, fx, fy, cx, cy, bf)
        chi2 = torch.sum(res * res, dim=-1) * inv_sigma2
        inlier = (chi2 <= chi2_th).to(torch.float32) * valid
    return T, inlier, torch.sum(inlier)


class PoseGraph:
    """Static buffers of one key of `optimize_pose` and the CUDA graph that
    reads and writes them.

    A call copies its inputs into the static inputs. The first call then
    runs `run` eagerly on a side stream: the warm-up that capture needs
    (cuBLAS and the solver set up their handles and workspaces there). The
    second captures `run` on that stream and launches the graph (counted
    as `pose_graph_capture`); every later call replays it (counted as
    `pose_graph_replay`). Each call returns clones of the static outputs:
    a chained tracker queues the next frame before it fetches this one's
    result, and the next replay overwrites them."""

    def __init__(self, inputs, settings):
        device = inputs[1].device
        self.inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs)
        self.settings = settings
        self.outputs = None
        self.stream = None
        self.graph = None

    def load(self, inputs):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src, non_blocking=True)

    def run(self):
        """The captured body: the GN of the static inputs into the outputs."""
        self.outputs = _gauss_newton(*self.inputs, *self.settings)

    def __call__(self, inputs):
        self.load(inputs)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.inputs[1].device)
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                self.run()
            torch.cuda.current_stream().wait_stream(self.stream)
        elif self.graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self.stream):
                self.run()
            self.graph = graph
            timing.count("pose_graph_capture")
            graph.replay()
        else:
            self.graph.replay()
            timing.count("pose_graph_replay")
        return tuple(t.clone() for t in self.outputs)


_GRAPHS: dict = {}   # key -> PoseGraph, shared by every tracker of the process


def optimize_pose(T_cw_init, pts_w, obs, inv_sigma2, valid, stereo_mask, intrinsics,
                  damping: float = 1e-3, rounds_iters: tuple = (4, 10),
                  chi2_anneal: tuple = (1.0, 1.0, 1.0, 1.0)):
    """Returns (T_cw, inlier_mask (N,), n_inliers). T_cw_init (4, 4),
    pts_w (N, 3), obs (N, 3) [u, v, u_right], inv_sigma2 / valid /
    stereo_mask (N,), intrinsics (5,) [fx, fy, cx, cy, bf]. chi2_anneal
    scales the chi2 threshold per round (the default keeps it constant).

    On a CUDA device the GN goes through the process's `PoseGraph` of its
    key: the device, each input's shape and dtype, the settings and the
    TF32 switch, all of which a graph bakes in. It runs eagerly on the CPU
    and while the current stream is capturing (an outer graph holds it)."""
    with timing.span("pose_opt"):
        inputs = (T_cw_init, pts_w, obs, inv_sigma2, valid, stereo_mask, intrinsics)
        settings = (float(damping), tuple(rounds_iters), tuple(float(a) for a in chi2_anneal))
        if not pts_w.is_cuda or torch.cuda.is_current_stream_capturing():
            return _gauss_newton(*inputs, *settings)
        key = (pts_w.device, torch.backends.cuda.matmul.allow_tf32, settings,
               tuple((tuple(x.shape), x.dtype) for x in inputs))
        graph = _GRAPHS.get(key)
        if graph is None:
            graph = _GRAPHS[key] = PoseGraph(inputs, settings)
        return graph(inputs)
