"""`dspslam_tpu_torch.datasets.get_sequence` against the JAX package's
factory: the same kind of sequence over the same frames, with the same
intrinsics, for a KITTI config (tests/fixtures/mini_kitti) and a mono config
(a small image_0 directory written here)."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from dspslam_tpu import config as jconfig
from dspslam_tpu import datasets as jdatasets
from dspslam_tpu_torch import config as tconfig
from dspslam_tpu_torch import datasets as tdatasets

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_kitti")


def kitti_config(tmp_path) -> str:
    with open(os.path.join(FIXTURE, "config.template.json")) as f:
        text = f.read().replace("{SEQ}", FIXTURE)
    path = tmp_path / "kitti.json"
    path.write_text(text)
    return str(path)


def mono_dir_and_config(tmp_path) -> tuple[str, str]:
    root = tmp_path / "mono"
    (root / "image_0").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for k in range(3):
        Image.fromarray(rng.integers(0, 255, (48, 64), np.uint8)).convert("RGB").save(
            root / "image_0" / f"{k:06d}.png")
    cfg = {"data_type": "Freiburg", "sensor": "mono",
           "camera": {"fx": 50.0, "fy": 52.0, "cx": 32.0, "cy": 24.0, "width": 64, "height": 48},
           "detection": {"path_label_2d": str(root / "labels_2d")}}
    path = tmp_path / "mono.json"
    path.write_text(json.dumps(cfg))
    return str(root), str(path)


@pytest.mark.parametrize("kind", ["kitti", "mono"])
def test_get_sequence_matches_the_jax_factory(tmp_path, kind):
    if kind == "kitti":
        data_dir, cfg_path = FIXTURE, kitti_config(tmp_path)
    else:
        data_dir, cfg_path = mono_dir_and_config(tmp_path)
    jseq = jdatasets.get_sequence(data_dir, jconfig.SystemConfig.load(cfg_path))
    tseq = tdatasets.get_sequence(data_dir, tconfig.SystemConfig.load(cfg_path), device="cpu")
    assert type(tseq).__name__ == type(jseq).__name__ == {"kitti": "KITTISequence", "mono": "MonoSequence"}[kind]
    assert type(tseq).__module__ == f"dspslam_tpu_torch.datasets.{kind}"
    assert tseq.num_frames == jseq.num_frames == 3
    np.testing.assert_allclose(tseq.K, jseq.K, rtol=0, atol=0)
