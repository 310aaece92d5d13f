"""Planted faults and the precision control, for the tests of `correct`.

Neither runs in a benchmark run: `run.main(..., variant=...)` is how the
tests (benchmark/tests/) and `benchmark/control.py` reach them.

A fault is planted in one layer, named "<layer>.<fault>": the layer is
`gn` (the object GN), `ba` (local BA) or `pose` (the tracker's pose
optimisation), each wrapped around its timed step:
  unchanged    the step returns its state unchanged (the GN its initial
               pose and code, local BA its input poses and points, the
               pose optimisation its initial pose);
  half_batch   half of the batch left out: the GN solves only the first
               half of its objects and hands the rest back unchanged; the
               pose optimisation uses every other observation slot;
  altered      an answer is altered where it is produced (the GN's codes
               moved by 0.05 per entry, BA's and the pose optimisation's
               camera translations by 5 cm).
The control (`tf32`): the configuration's float32 steps one precision
lower, TF32 for products with TF32 off. The render grid runs at the
program's own "default" matmul precision (cuBLAS TF32); kernel K1, which
has no lower path in the program (3xTF32 at every precision), local BA and
the pose optimisation are replaced by the plain references computed in
TF32 (the decoder's products on the tensor cores; BA's and the pose
optimisation's products with their operands rounded to TF32, with cuBLAS
TF32 on).
"""

from __future__ import annotations

import contextlib

import torch

from .reference import ba as ba_ref
from .reference import gn as gn_ref
from .reference import pose as pose_ref
from .reference.precision import tf32 as tf32_round


def planted(variant: str | None, layer: str) -> str | None:
    """The fault `variant` plants in `layer` ("tf32" in every layer), or None."""
    if variant == "tf32":
        return variant
    if variant is not None and variant.startswith(layer + "."):
        return variant.split(".", 1)[1]
    return None


@contextlib.contextmanager
def cublas_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before

def _unchanged_gn(args):
    return {"t_cam_obj": args[0].clone(), "code": args[7].clone(), "is_good": torch.ones(args[0].shape[0],
            dtype=torch.bool, device=args[0].device), "loss": torch.zeros(args[0].shape[0], device=args[0].device)}


def wrap_gn(fn, variant: str | None):
    """fn(t_cam_obj, pts, pts_mask, rays, ray_mask, depth, fg_mask, code)
    with `variant`'s GN fault planted (none: fn itself)."""
    variant = planted(variant, "gn")
    if variant in (None, "tf32"):
        return fn
    if variant == "unchanged":
        return lambda *a: _unchanged_gn(a)
    if variant == "half_batch":
        def half(*a):
            h = max(a[0].shape[0] // 2, 1)
            out = fn(*(x[:h] for x in a))
            keep = _unchanged_gn(a)
            return {k: torch.cat([out[k], keep[k][h:]]) for k in out}
        return half
    if variant == "altered":
        def altered(*a):
            out = dict(fn(*a))
            out["code"] = out["code"] + 0.05
            return out
        return altered
    raise ValueError(variant)


def wrap_ba(fn, variant: str | None):
    """local BA with `variant`'s BA fault planted (none: fn itself)."""
    variant = planted(variant, "ba")
    if variant is None:
        return fn
    if variant == "unchanged":
        def unchanged(*a, **k):
            out = fn(*a, **k)
            return dict(out, kf_poses=a[0].clone(), points=a[2].clone())
        return unchanged
    if variant == "altered":
        def altered(*a, **k):
            out = dict(fn(*a, **k))
            poses = out["kf_poses"].clone()
            poses[:, :3, 3] += 0.05
            out["kf_poses"] = poses
            return out
        return altered
    if variant == "tf32":
        def tf32(*a, **k):
            with cublas_tf32():
                return ba_ref.bundle_adjust(*a, **k, operand=tf32_round)
        return tf32
    raise ValueError(variant)


def wrap_pose(fn, variant: str | None):
    """The tracker's pose optimisation fn(T_cw_init, pts_w, obs, inv_sigma2,
    valid, stereo_mask, intrinsics, ...) with `variant`'s pose fault
    planted (none: fn itself)."""
    variant = planted(variant, "pose")
    if variant is None:
        return fn
    if variant == "unchanged":
        def unchanged(T, pts, obs, inv_s2, valid, *a, **k):
            return T.clone(), valid.clone(), valid.sum()
        return unchanged
    if variant == "half_batch":
        def half(T, pts, obs, inv_s2, valid, *a, **k):
            # every other slot: the map's points fill the slots from the front
            even = (torch.arange(valid.shape[0], device=valid.device) % 2 == 0).to(valid.dtype)
            return fn(T, pts, obs, inv_s2, valid * even, *a, **k)
        return half
    if variant == "altered":
        def altered(*a, **k):
            T, inlier, n = fn(*a, **k)
            T = T.clone()
            T[:3, 3] += 0.05
            return T, inlier, n
        return altered
    if variant == "tf32":
        def tf32(*a, **k):
            with cublas_tf32():
                return pose_ref.optimize_pose(*a, **k, operand=tf32_round)
        return tf32
    raise ValueError(variant)


def control_decoder(decoder, weights, biases, latent_in):
    """The control's K1: the plain decoder's value and input gradient in
    TF32, put in the place of the port's `sdf_and_input_grad`."""
    decoder.sdf_and_input_grad = gn_ref.PlainDecoder(weights, biases, latent_in, tf32=True).sdf_and_input_grad
