"""Reference-format dataset JSON (fault R5): the two fixtures under
tests/fixtures/reference_configs, written from the keys
`SystemConfig.from_reference_json` reads (config_kitti.json and
config_redwood_01053.json of the reference's configs/), load through the
JAX package and the PyTorch port to equal configurations, field by field,
with the values tests/test_pipeline.py::TestConfig asserts on the
reference's own files.
"""

import dataclasses
import os

import pytest

from dspslam_tpu import config as jcfg
from dspslam_tpu_torch import config as tcfg

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "reference_configs")


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", ["config_kitti.json", "config_redwood_01053.json"])
def test_both_packages_load_the_same_config(name):
    path = os.path.join(FIXTURES, name)
    j, t = jcfg.SystemConfig.from_reference_json(path), tcfg.SystemConfig.from_reference_json(path)
    jf, tf = _fields(j), _fields(t)
    assert jf.keys() == tf.keys()
    for section in jf:
        assert tf[section] == jf[section], section
    # SystemConfig.load dispatches a reference-format file the same way
    assert _fields(tcfg.SystemConfig.load(path)) == tf


def test_kitti_values():
    cfg = tcfg.SystemConfig.from_reference_json(os.path.join(FIXTURES, "config_kitti.json"))
    assert cfg.optimizer.k2 == 100.0
    assert cfg.optimizer.k4 == 1e7
    assert cfg.optimizer.num_iterations == 10
    assert cfg.optimizer.pose_only_iterations == 5
    assert cfg.detection.num_lidar_max == 250
    assert cfg.voxels_dim == 32
    assert cfg.data_type == "KITTI" and cfg.deepsdf_dir == "weights/deepsdf/cars_64"


def test_redwood_values():
    cfg = tcfg.SystemConfig.from_reference_json(os.path.join(FIXTURES, "config_redwood_01053.json"))
    assert cfg.optimizer.k1 == 10.0
    assert cfg.optimizer.k4 == 0.0
    assert cfg.optimizer.scale_damping == 100.0
    assert cfg.data_type == "Redwood" and cfg.detection.weight_path_3d is None
