"""Import hygiene of the PyTorch port: no module of `dspslam_tpu_torch`
(nor `chip_smoke.py`) imports JAX or the JAX package, checked on the
source's syntax tree so that a lazy import inside a function counts too."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "dspslam_tpu")


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


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imported_modules(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"
