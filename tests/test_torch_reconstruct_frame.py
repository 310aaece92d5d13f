"""The port's single-frame reconstruction app against the JAX app, end to
end on the CPU: the synthetic two-sphere KITTI-like frame padded to the
full caps (B=8, P=256, R=512, S=50, K=1024, 10 GN iterations), first with
the analytic sphere decoder, then with a small DeepSDF experiment dir
(reference format) named by a native config.

Tolerances: poses and codes within 1e-4 for the sphere decoder (its
gradients are closed-form on both sides, so only f32 operation order
differs). The DeepSDF case runs 3 GN iterations and compares at 1e-3:
its near-spherical field leaves the object's rotation constrained only by
the damping and the k4 = 1e7 rotation prior, and f32 rounding there walks
both packages away from a float64 run of the port by the same amounts
(2e-6 after 1 iteration, 3e-4 after 3, 2.4e-2 after 10). Meshes agree
within 1 mm symmetric chamfer in the camera frame.
"""

import json

import numpy as np
import pytest
import torch

from dspslam_tpu import config as jconfig
from dspslam_tpu.apps import reconstruct_frame as japp
from dspslam_tpu_torch.apps import reconstruct_frame as tapp
from dspslam_tpu_torch.models import deepsdf
from dspslam_tpu_torch.utils import io as io_mod

from test_torch_deepsdf import write_experiment
from test_torch_shape import SMALL, sphere_like_params
from torch_threads import one_torch_thread  # noqa: F401


def _chamfer_m(rec_a, rec_b):
    """Symmetric mean nearest-neighbour distance of two object meshes,
    each placed in the camera frame by its own t_cam_obj (metres)."""
    pts = []
    for rec in (rec_a, rec_b):
        v, _ = io_mod.read_mesh_ply(rec["mesh"])
        T = np.asarray(rec["t_cam_obj"])
        pts.append(v @ T[:3, :3].T + T[:3, 3])
    d = np.linalg.norm(pts[0][:, None, :] - pts[1][None, :, :], axis=-1)
    return 0.5 * (d.min(axis=1).mean() + d.min(axis=0).mean())


def _run_both(tmp_path, extra, atol):
    common = ["--synthetic", "--voxels_dim", "33", *extra]
    ours = tapp.main([*common, "--device", "cpu", "--output_dir", str(tmp_path / "torch")])
    ref = japp.main([*common, "--output_dir", str(tmp_path / "jax")])
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a["is_good"] and b["is_good"]
        np.testing.assert_allclose(a["t_cam_obj"], b["t_cam_obj"], atol=atol)
        np.testing.assert_allclose(a["code"], b["code"], atol=atol)
        assert _chamfer_m(a, b) <= 1e-3
    return ours


def test_synthetic_sphere_matches_jax_app(tmp_path):
    _run_both(tmp_path, [], atol=1e-4)


def test_synthetic_deepsdf_config_matches_jax_app(tmp_path):
    cfg = deepsdf.DecoderConfig(**SMALL)
    exp = tmp_path / "exp"
    write_experiment(exp, cfg, sphere_like_params(), weight_norm=True)
    config = tmp_path / "config.json"
    jconfig.SystemConfig(
        deepsdf_dir=str(exp),
        optimizer=jconfig.GNConfig(code_len=cfg.code_len, num_iterations=3),
    ).to_json(str(config))
    ours = _run_both(tmp_path, ["--config", str(config)], atol=1e-3)
    summary = json.loads((tmp_path / "torch" / "frame_recon.json").read_text())
    assert [r["code"] for r in summary] == [r["code"] for r in ours]
    assert len(ours[0]["code"]) == cfg.code_len


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tapp.main(["--synthetic", "--output_dir", "unused"])
