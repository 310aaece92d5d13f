"""Import hygiene of the PyTorch port: no module of `dspslam_tpu_torch`
(nor `chip_smoke.py`) imports JAX, the JAX package, optax, orbax, OpenCV or
torchvision,
checked on the source's syntax tree so that a lazy import inside a function
counts too."""

import ast
import pathlib

import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the card's machine has no OpenCV and no torchvision either; the trainers
# use torch.optim, not optax or orbax
FORBIDDEN = ("jax", "jaxlib", "dspslam_tpu", "cv2", "torchvision", "optax", "orbax")


def _sources():
    files = sorted((ROOT / "dspslam_tpu_torch").rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    return files + ([smoke] if smoke.exists() else [])


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_has_sources():
    names = {p.name for p in _sources()}
    assert {"decoder_fused.py", "deepsdf.py", "gn.py", "reconstruct_frame.py"} <= names
    assert {
        "_nvcc.py", "fast_score.py", "lie_np.py", "orb.py", "orb_pattern.py", "undistort.py",
        "matcher.py", "stereo.py", "pose_opt.py", "map.py", "frame_step.py", "tracking.py",
        "synthetic.py", "evaluation.py",
    } <= names
    assert {
        "keyframe_step.py", "ba.py", "local_mapping.py", "association.py", "pipeline.py",
        "system.py", "kitti.py", "dsp_slam.py", "benchmark_slam.py",
    } <= names
    assert {
        "initializer.py", "cuboid.py", "mono.py", "mono_pipeline.py", "dsp_slam_mono.py",
    } <= names
    assert {
        "vocabulary.py", "orbvoc.py", "sim3.py", "loop_closing.py", "pose_graph.py", "pnp.py",
        "relocalization.py", "state_io.py", "street_loop.py", "extract_map_objects.py",
    } <= names
    assert {
        "rotated_iou.py", "layers.py", "maskrcnn.py", "pointpillars.py", "benchmark_detectors.py",
    } <= names
    assert {
        "deepsdf_train.py", "train_deepsdf.py", "maskrcnn_train.py", "pointpillars_train.py",
        "train_vocabulary.py", "frame_drawer.py", "renderer.py", "live_viewer.py", "visualize_map.py",
    } <= names
    assert {"mesh_utils.py", "tp_decoder.py", "dryrun.py"} <= names
    assert "bench.py" in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imported_modules(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"
