"""Planted faults of the mono object path, and its part of the precision
control, for the tests of `correct` (neither runs in a benchmark run;
faults.py has the SLAM layers', detfaults.py the detector's).

A fault is named "mono.<stage>" and breaks one stage of the port, so that
one number fails:
  mono.det   the detection's mask eroded by two pixels more      (mono_det_miss)
  mono.seed  the PCA cuboid's centre moved 5 cm along x          (mono_seed_gap)
  mono.pick  a first reconstruction keeps the higher-loss candidate
                                                                  (mono_pick_miss)
  mono.mesh  the mesh's voxel grid spans [-1.1, 1.1] instead of [-1, 1]
                                                                  (mesh_grid_gap)
The control (`tf32`, faults.py's): the PCA cuboid computed by the plain
reference from its points rounded to TF32 (10 mantissa bits, one precision
below the configuration's float32 geometry); the mesh grid decodes through
the control's decoder, at the program's own "default" matmul precision
(set up with faults.py's control).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import mono as ref_mono
from .reference.precision import tf32 as tf32_round

FAULTS = ("mono.det", "mono.seed", "mono.pick", "mono.mesh")
CONTROL = "tf32"


def install(variant: str | None, mono, cuboid, pipeline, mesh):
    """Replace stage functions of the port's modules `mono`
    (datasets/mono.py), `cuboid`, `pipeline` (objects/mono_pipeline.py) and
    `mesh` (shape/mesh.py) for `variant`; returns the originals for
    `restore`."""
    saved = {}

    def put(mod, name, fn):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, fn)

    if variant == CONTROL:
        def pca(points_w):
            out = ref_mono.cuboid_pca(points_w, operand=tf32_round)
            return None if out is None else {"T_wo_sim3": out["T_wo_sim3"], "inlier_mask": out["inliers"]}
        put(cuboid, "compute_cuboid_pca", pca)
    elif variant == "mono.det":
        fn = mono.build_mono_detection

        def eroded_more(*a, **k):
            return fn(*a, **{**k, "mask_erosion": k.get("mask_erosion", 0) + 2})
        put(mono, "build_mono_detection", eroded_more)
    elif variant == "mono.seed":
        fn = cuboid.compute_cuboid_pca

        def moved(points_w):
            out = fn(points_w)
            if out is not None:
                out = dict(out, T_wo_sim3=out["T_wo_sim3"].copy())
                out["T_wo_sim3"][0, 3] += 0.05
            return out
        put(cuboid, "compute_cuboid_pca", moved)
    elif variant == "mono.pick":
        def worst_of(results):
            finite = [r for r in results if np.isfinite(r["t_cam_obj"]).all()]
            return max(finite, key=lambda r: r["loss"]) if finite else None
        put(pipeline, "best_of", worst_of)
    elif variant == "mono.mesh":
        def wide_grid(decoder, code, vol_dim, chunk=64 ** 3):
            pts = 1.1 * torch.from_numpy(mesh.create_voxel_grid(vol_dim)).to(code.device)
            return mesh._decode_points(decoder, code, pts, chunk).reshape(vol_dim, vol_dim, vol_dim)
        put(mesh, "decode_sdf_grid", wide_grid)
    return saved


def restore(saved: dict):
    for (mod, name), fn in saved.items():
        setattr(mod, name, fn)
