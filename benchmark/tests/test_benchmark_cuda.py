"""On the card: the precision control of each cell comes out not correct,
at the cells' own sizes with short windows (about three minutes in all).

    python -m pytest benchmark/tests/test_benchmark_cuda.py -q   (on the card)

The decision whether a card is there is made inside the test; without one
every case skips."""

import io
import json

import pytest

CASES = [("kitti_gn", 8), ("kitti_full", 25)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", CASES)
def test_the_tf32_control_is_not_correct(cell, seconds):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs the cell at its own size on the card")
    from benchmark import run

    lines = {}
    for variant in (None, "tf32"):
        buf = io.StringIO()
        rc = run.main(["--workload", cell, "--seed", "7001", "--seconds", str(seconds), "--trace", "0"], out=buf,
                      variant=variant)
        assert rc == 0
        lines[variant] = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert lines[None]["correct"] is True, lines[None]["checks"]
    assert lines["tf32"]["correct"] is False, lines["tf32"]["checks"]
