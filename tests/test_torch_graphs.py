"""The CUDA-graph mechanism's key (`dspslam_tpu_torch/ops/graphs.py`) on the
CPU. The graphs themselves run on the card: tests/test_torch_graphs_cuda.py
there, and the bodies' CPU tests in test_torch_pose_opt.py and
test_torch_ba.py."""

import torch

from dspslam_tpu_torch.ops import graphs
from torch_threads import one_torch_thread  # noqa: F401


def test_key_separates_shape_dtype_settings_and_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    inputs = (torch.zeros(4, 3), torch.zeros(5, dtype=torch.int32))
    base = graphs.key(inputs, 1e-3, (5, 10))
    # the values are not part of the key: a call loads them into the static inputs
    assert graphs.key((torch.ones(4, 3), torch.ones(5, dtype=torch.int32)), 1e-3, (5, 10)) == base
    assert graphs.key((torch.zeros(8, 3), inputs[1]), 1e-3, (5, 10)) != base
    assert graphs.key((torch.zeros(4, 3), torch.zeros(5, dtype=torch.int64)), 1e-3, (5, 10)) != base
    assert graphs.key(inputs, 1e-2, (5, 10)) != base
    assert graphs.key(inputs, 1e-3, (10,)) != base
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert graphs.key(inputs, 1e-3, (5, 10)) != base
