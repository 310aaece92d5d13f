"""The monocular CLI end to end: dspslam_tpu.apps.dsp_slam_mono.main and the
PyTorch port's (`--device cpu`) over a 3-frame mono fixture written here:
tests/test_mono_objects.py's scene (240 x 640, the textured sphere before
two depth layers, 0.15 m strafe) as PNGs in image_0/, the sphere's mask and
box as .npz 2D labels, and a native config (mono sensor, the scene's
camera, 800 features, 4 levels, mask erosion 5).

Checked: the four output files parse (MapPoints.txt, MapObjects.txt with
the 64-float codes of the sphere decoder, Cameras.txt,
trajectory_tum.txt); trajectory_tum.txt and Cameras.txt within 1e-3 of the
JAX run's (f32 pose GN summed in another order), the same map-point count
and the same objects (created by mask voting; no reconstruction in 3
frames).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))
import test_mono_objects as scene  # noqa: E402

N_FRAMES = 3


def write_fixture(root) -> str:
    from dspslam_tpu_torch import config as cfg_mod
    from dspslam_tpu_torch.detect import offline

    world = scene.layered_background()
    os.makedirs(root / "image_0")
    for k in range(N_FRAMES):
        x = k * scene.STEP
        img = np.clip(np.round(scene.render(world, x)), 0, 255).astype(np.uint8)
        Image.fromarray(img).convert("RGB").save(root / "image_0" / f"{k:06d}.png")
        hit, _ = scene.sphere_hit(x)
        ys, xs = np.nonzero(hit)
        box = np.array([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]], np.float32)
        offline.save_labels_npz(str(root / "labels"), str(root / "labels_3d"), k,
                                np.zeros((0, 7), np.float32), box, hit[None])
    cfg = cfg_mod.SystemConfig(
        data_type="Synthetic", sensor="mono",
        camera=cfg_mod.CameraConfig(fx=scene.FX, fy=scene.FY, cx=scene.CX, cy=scene.CY, width=scene.W,
                                    height=scene.H, fps=10.0, baseline_fx=0.0),
        orb=cfg_mod.ORBConfig(n_features=800, n_levels=4),
        detection=dataclasses.replace(cfg_mod.DetectionConfig(), path_label_2d=str(root / "labels"),
                                      mask_erosion=5),
    )
    path = str(root / "config.json")
    cfg.to_json(path)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dspslam_tpu.apps import dsp_slam_mono as jmono
    from dspslam_tpu_torch.apps import dsp_slam_mono as tmono

    root = tmp_path_factory.mktemp("mono_cli")
    cfg = write_fixture(root)
    common = ["--sequence_dir", str(root), "--config", cfg]
    js = jmono.main(common + ["--map_dir", str(root / "jax")])
    ts = tmono.main(common + ["--map_dir", str(root / "torch"), "--device", "cpu"])
    return js, ts, str(root / "jax"), str(root / "torch")


def _objects(path):
    lines = [ln for ln in open(path).read().split("\n") if ln.strip()]
    assert len(lines) % 3 == 0
    return [(int(lines[i]), np.array(lines[i + 1].split(), float), np.array(lines[i + 2].split(), float))
            for i in range(0, len(lines), 3)]


def test_cli_matches_jax(runs):
    js, ts, jdir, tdir = runs
    assert ts.state.name == js.state.name == "OK"
    jt = np.loadtxt(os.path.join(jdir, "trajectory_tum.txt")).reshape(-1, 8)
    tt = np.loadtxt(os.path.join(tdir, "trajectory_tum.txt")).reshape(-1, 8)
    assert tt.shape == jt.shape and len(tt) >= 2
    assert np.abs(tt - jt).max() <= 1e-3
    jc = np.loadtxt(os.path.join(jdir, "Cameras.txt")).reshape(-1, 3, 4)
    tc = np.loadtxt(os.path.join(tdir, "Cameras.txt")).reshape(-1, 3, 4)
    assert tc.shape == jc.shape and np.abs(tc - jc).max() <= 1e-3
    jp = np.loadtxt(os.path.join(jdir, "MapPoints.txt")).reshape(-1, 3)
    tp = np.loadtxt(os.path.join(tdir, "MapPoints.txt")).reshape(-1, 3)
    assert len(tp) == len(jp) > 80
    jo, to = _objects(os.path.join(jdir, "MapObjects.txt")), _objects(os.path.join(tdir, "MapObjects.txt"))
    assert len(to) == len(jo) >= 1
    for (_, a, ca), (_, b, cb) in zip(jo, to):
        assert b.shape == (12,) and cb.shape == (64,)
        assert np.abs(a - b).max() <= 1e-3 and np.abs(ca - cb).max() <= 1e-3


def test_vocabulary_raises(tmp_path):
    """`--vocabulary` loads the file it names (relocalization is ported):
    a missing one raises before any frame is read."""
    from dspslam_tpu_torch.apps import dsp_slam_mono as tmono

    with pytest.raises(FileNotFoundError):
        tmono.main(["--sequence_dir", str(tmp_path), "--device", "cpu", "--vocabulary",
                    str(tmp_path / "voc.npz")])


def test_cli_defaults_to_the_card(tmp_path):
    from dspslam_tpu_torch.apps import dsp_slam_mono as tmono

    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tmono.main(["--sequence_dir", str(tmp_path), "--map_dir", str(tmp_path / "out")])
