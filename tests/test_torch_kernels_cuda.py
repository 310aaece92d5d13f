"""Kernel K1 (csrc/decoder_fused.cu) on the card, against its plain PyTorch
version. Every test here needs a CUDA device and skips without one. The
file imports neither JAX nor the JAX package, so on a machine with a card
it runs without the JAX test harness:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances (from tests/test_pallas_kernel.py): sdf within 1e-5; gradient
99th-percentile error < 1e-4 with at most max(3, N/1000) rows above 1e-4
(a point on a ReLU boundary may take the other subgradient).
"""

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.kernels import decoder_fused
from dspslam_tpu_torch.models import deepsdf


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def canonical(device, seed=0):
    rng = np.random.default_rng(seed)
    dims = deepsdf.DecoderConfig().layer_dims()
    params = {
        "w": [(rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(np.float32) for i, o in dims],
        "b": [(rng.normal(size=(o,)) * 0.05).astype(np.float32) for _, o in dims],
    }
    return deepsdf.params_from_jax(params, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 300, 2048, 4000])   # 16-row and 32-row blocks
def test_k1_kernel_matches_plain(cuda, n):
    dec = canonical(cuda)
    x = torch.from_numpy(
        (np.random.default_rng(n).normal(size=(n, 67)) * 0.3).astype(np.float32)
    ).to(cuda)
    before = decoder_fused.sdf_and_input_grad.launches
    sdf, grad = dec.sdf_and_input_grad(x)
    torch.cuda.synchronize()
    assert decoder_fused.sdf_and_input_grad.launches == before + 1
    sdf_p, grad_p = decoder_fused.sdf_and_input_grad_plain(list(dec.weights), list(dec.biases), x)
    assert (sdf - sdf_p).abs().max().item() <= 1e-5
    err = (grad - grad_p).abs().amax(dim=1)
    assert torch.quantile(err, 0.99).item() < 1e-4
    assert int((err > 1e-4).sum()) <= max(3, n // 1000)


@pytest.mark.cuda
def test_k1_repacks_after_an_in_place_weight_update(cuda):
    dec = canonical(cuda)
    x = torch.full((5, 67), 0.1, device=cuda)
    before, _ = dec.sdf_and_input_grad(x)
    with torch.no_grad():
        dec.biases[8].add_(0.5)
    after, _ = dec.sdf_and_input_grad(x)
    expected, _ = decoder_fused.sdf_and_input_grad_plain(list(dec.weights), list(dec.biases), x)
    assert not torch.allclose(before, after)
    assert (after - expected).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_non_canonical_decoder_raises(cuda):
    cfg = deepsdf.DecoderConfig(code_len=8, hidden=(32,) * 4, latent_in=(2,))
    dec = deepsdf.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    with pytest.raises(ValueError, match="code_len=8"):
        dec.sdf_and_input_grad(torch.zeros((4, 11), device=cuda))
