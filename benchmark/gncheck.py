"""The object GN followed step by step, from the program's own state.

Ten undamped GN iterations in float32 amplify rounding: from the same
inputs, the plain reference in float32 and in float64 end up to a shape
code apart (measured on the CPU; PERF.md), and a one-iteration step moves
weakly constrained code directions by ~1e-3 for a state perturbed at
float32's rounding. So neither the final code nor a step's code can tell a
sound run from one a precision lower. What the timed path computes at each
step can, measured where it is well conditioned. `DecoderTap` wraps the
port's decoder object (which the benchmark builds and hands to the port)
and, during a sampled GN call, keeps the rows it was asked to evaluate and
what it returned. From those:

  gn_k1_gap        K1's value and input gradient against the plain decoder
                   on the same rows: the larger of the two relative errors
                   ||prog - ref|| / ||ref|| over the call's rows;
  gn_grid_gap      the render grid's forward against the plain decoder on
                   a seeded subset of its rows, the largest difference;
  gn_step_gap      each iteration's state, read back from the rows of its
                   surface-point K1 call (the code is in every row; the
                   pose maps the input points onto the rows' points), and
                   the call's output, against one plain reference step from
                   the state before it (the first state against the call's
                   inputs), compared as surfaces: the metric SDF
                   (scale x decoder) of both states at the object's live
                   surface points, in meters, the largest difference;
  gn_step_gap_median  the same steps, at the median object: per step the
                   median over the objects with live points of each
                   object's largest difference, the largest over the steps
                   (steadier than the widest gap, which one ill-conditioned
                   object sets);
  gn_calls_short   sampled calls whose K1 rows do not show the
                   configuration's iterations on every object (exact).

A cell compares the numbers that limits/<cell>.json gives a limit (PERF.md
gives the readings).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import gn as gn_ref
from .reference import lie


class DecoderTap:
    """Wraps `decoder.forward` and `decoder.sdf_and_input_grad` on the
    instance. While `record` is a list, each call appends ("k1", x, sdf,
    grad) or ("grid", x rows, sdf rows) (`grid_rows` rows drawn from
    `rng`); otherwise a call passes straight through."""

    def __init__(self, decoder, grid_rows: int, rng: np.random.Generator):
        self.decoder, self.grid_rows, self.rng = decoder, grid_rows, rng
        self.record = None
        self._inner = False
        self._forward, self._grad = decoder.forward, decoder.sdf_and_input_grad
        decoder.forward, decoder.sdf_and_input_grad = self.forward, self.sdf_and_input_grad

    def forward(self, x):
        y = self._forward(x)
        if self.record is not None and not self._inner:
            n = x.shape[0]
            idx = torch.from_numpy(self.rng.choice(n, min(self.grid_rows, n), replace=False)).to(x.device)
            self.record.append(("grid", x[idx], y[idx]))
        return y

    def sdf_and_input_grad(self, x):
        self._inner = True          # a generic decoder's gradient pass calls forward
        try:
            sdf, g = self._grad(x)
        finally:
            self._inner = False
        if self.record is not None:
            self.record.append(("k1", x, sdf, g))
        return sdf, g

    def remove(self):
        del self.decoder.forward
        del self.decoder.sdf_and_input_grad


def plain_decoders(weights, biases, latent_in):
    """The plain reference decoder in float32, and a float64 copy that
    measures surfaces."""
    return (gn_ref.PlainDecoder(weights, biases, latent_in),
            gn_ref.PlainDecoder([w.double() for w in weights], [b.double() for b in biases], latent_in))


def recover_pose(pts_cam: torch.Tensor, pts_obj: torch.Tensor) -> torch.Tensor:
    """The T_obj_cam (B, 4, 4) with pts_obj = T_obj_cam pts_cam: the affine
    least-squares fit over each object's points in float64, rounded to
    float32. The rows hold the program's float32 product of its state and
    the points, so over hundreds of points the fit lands within a fraction
    of a float32 step of the program's own matrix, and the rounding most
    often gives it back exactly."""
    out = []
    for a, b in zip(pts_cam.double().cpu().numpy(), pts_obj.double().cpu().numpy()):
        T = np.eye(4)
        A = np.concatenate([a, np.ones((len(a), 1))], 1)
        if np.linalg.matrix_rank(A) == 4:       # a padded slot's points are all zero: no pose to read
            T[:3, :] = np.linalg.lstsq(A, b, rcond=None)[0].T
        out.append(T)
    return torch.as_tensor(np.stack(out), dtype=torch.float32, device=pts_cam.device)


def metric_sdf(dec64: gn_ref.PlainDecoder, T_obj_cam, code, pts) -> torch.Tensor:
    """scale x SDF (B, P) of the states (T_obj_cam, code) at the camera-frame
    points `pts`, in float64: the object's surface in meters."""
    T = T_obj_cam.double()
    x = lie.transform_points(T, pts.double())
    B, P, _ = x.shape
    rows = torch.cat([code.double()[:, None, :].expand(B, P, code.shape[-1]), x], -1).reshape(B * P, -1)
    scale = 1.0 / torch.linalg.det(T[:, :3, :3]).abs().pow(1.0 / 3.0)
    return scale[:, None] * dec64(rows).reshape(B, P)


def gn_call_gaps(args, out: dict, record: list, dec: gn_ref.PlainDecoder, dec64: gn_ref.PlainDecoder,
                 p: gn_ref.GNParams) -> dict:
    """The numbers of one sampled GN call (see the module's docstring),
    and under "rows" the reference's (grid rows inside the unit ball, live
    gradient rows) summed over the call's iterations."""
    B, P = args[0].shape[0], args[1].shape[1]
    live = (args[2] > 0) & (args[2].sum(-1, keepdim=True) > 0)
    k1 = [r for r in record if r[0] == "k1"]
    grid = [r for r in record if r[0] == "grid"]
    k1_gap = grid_gap = 0.0
    for _, x, sdf, g in k1:
        sr, gr = dec.sdf_and_input_grad(x)
        k1_gap = max(k1_gap, float((sdf - sr).norm() / sr.norm().clamp(min=1e-30)),
                     float((g - gr).norm() / gr.norm().clamp(min=1e-30)))
    for _, x, y in grid:
        grid_gap = max(grid_gap, float((y - dec(x)).abs().max()))
    surf = k1[0::2]
    inputs = args[1:7]
    if len(surf) != p.num_iterations or any(x.shape[0] != B * P for _, x, _, _ in surf):
        # the iterations the configuration states did not all run on every object
        return {"gn_k1_gap": k1_gap, "gn_grid_gap": grid_gap, "gn_step_gap": float("inf"),
                "gn_step_gap_median": float("inf"), "gn_calls_short": 1.0, "rows": None}
    L = p.code_len
    states = []
    for _, x, _, _ in surf:
        rows = x.reshape(B, P, -1)
        states.append((recover_pose(args[1], rows[..., L:L + 3]), rows[:, 0, :L]))

    objects = live.any(-1)

    def gap(a, b):
        """(the largest difference, the median object's largest difference)"""
        if not live.any():
            return 0.0, 0.0
        d = (metric_sdf(dec64, *a, args[1]) - metric_sdf(dec64, *b, args[1])).abs()
        per_object = torch.where(live, d, 0.0).amax(-1)[objects]
        return float(per_object.max()), float(per_object.median())

    gaps = [gap((lie.inverse_sim3(args[0]), args[7][:, :L]), states[0])]
    nxt = states[1:] + [(lie.inverse_sim3(out["t_cam_obj"]), out["code"])]
    counts = [0.0, 0.0]
    for (T, c), following in zip(states, nxt):
        T_ref, c_ref, _, _, n_valid, n_grad = gn_ref.step(dec, p, T, c, *inputs)
        gaps.append(gap(following, (T_ref, c_ref)))
        counts = [counts[0] + float(n_valid), counts[1] + float(n_grad)]
    return {"gn_k1_gap": k1_gap, "gn_grid_gap": grid_gap, "gn_step_gap": max(g for g, _ in gaps),
            "gn_step_gap_median": max(m for _, m in gaps), "gn_calls_short": 0.0, "rows": counts}
