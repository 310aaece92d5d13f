"""Tiny overrides of each configuration and mix, for CPU runs of a cell
(the CPU tests only: the benchmark itself runs the files as they are)."""

from __future__ import annotations

SMALL_DECODER = {"code_len": 64, "hidden": [128, 128, 128, 128], "latent_in": [2]}


def camera(cam: dict, div: int) -> dict:
    out = dict(cam)
    for k in ("fx", "fy", "cx", "cy", "baseline_fx"):
        out[k] = cam[k] / div
    out["width"], out["height"] = cam["width"] // div, cam["height"] // div
    return out


def overrides(cell: str, config: dict) -> dict:
    """{"config": ..., "mix": ...} that shrink `cell` to a CPU run of a few seconds."""
    if cell == "kitti_gn":
        return {"config": {"decoder": SMALL_DECODER, "detection": {"max_surface_points": 32, "max_rays": 16},
                           "optimizer": {"num_iterations": 2, "max_grad_points": 64, "num_depth_samples": 8}},
                "mix": {"batch": 2, "pool_size": 3, "decoder_fit_steps": 5, "warmup_calls": 1,
                        "check": {"gn_spacing": 2}}}
    cfg = {"camera": camera(config["camera"], 2), "orb": {"n_features": 600, "n_levels": 4},
           "tracker": {"min_init_features": 150}}
    mix = {"warmup_frames": 2, "world": {"texture_seeds": [0]},
           "check": {"ba_spacing": 1, "gn_spacing": 1, "pose_spacing": 3, "min_frames_for_ate": 5}}
    if cell == "kitti_full":
        cfg.update({"decoder": SMALL_DECODER,
                    "optimizer": {"num_iterations": 2, "max_grad_points": 64, "num_depth_samples": 8},
                    "detection": {"max_surface_points": 64, "max_rays": 64}, "voxels_dim": 8})
        mix.update({"frames_per_drive": 10, "decoder_fit_steps": 5})
    else:
        mix.update({"frames_per_drive": 10})
    return {"config": cfg, "mix": mix}
