"""FAST score maps of the PyTorch port against the JAX package.

* K2's plain version (`kernels/fast_score.fast_score_map_plain`, which CPU
  tensors take) against the Pallas kernel run in interpret mode,
  `fast_score_map_pallas(..., interpret=True)`: EXACT equality. The inputs
  are integer-valued images (blobs on rounded noise), so every d and every
  sum |d| is an integer and both sides add the 16 terms in the same order.
  Shapes are not multiples of the TPU kernel's 48-row / 128-column blocks.
* The arc-min path (`frontend/orb.fast_score_map`) against
  `dspslam_tpu.frontend.orb.fast_score_map`: EXACT, wraparound included
  (only subtractions, comparisons, min and max).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.frontend import orb as jorb
from dspslam_tpu.ops.pallas import fast_kernel
from dspslam_tpu_torch.datasets.synthetic import blob_images
from dspslam_tpu_torch.frontend import orb as torb
from dspslam_tpu_torch.kernels import fast_score


def blob_image(h, w, seed=0):
    """One (h, w) image of datasets/synthetic.blob_images (integer-valued
    blobs on rounded noise, tests/test_pallas_kernel.py's recipe rounded)."""
    return blob_images(1, h, w, seed)[0]


@pytest.mark.parametrize("shape", [(100, 157), (49, 130)])
@pytest.mark.parametrize("thresholds", [(7.0, 20.0), (5.0, 12.0)])
def test_k2_plain_equals_pallas_interpret(shape, thresholds):
    t_lo, t_hi = thresholds
    img = blob_image(*shape, seed=shape[0])
    ref = np.asarray(fast_kernel.fast_score_map_pallas(jnp.asarray(img), t_lo, t_hi, 1e4, True))
    out = fast_score.fast_score_map_plain(torch.from_numpy(img)[None], t_lo, t_hi, 1e4)[0].numpy()
    assert (ref >= 1e4).sum() > 10 and ((ref > 0) & (ref < 1e4)).sum() > 10
    np.testing.assert_array_equal(out, ref)


def test_k2_batch_pads_each_image_alone():
    """(B, H, W) is B independent zero-padded images, unlike the TPU's
    row-flattened batch."""
    imgs = np.stack([blob_image(40, 70, seed=s) for s in range(3)])
    out = fast_score.fast_score_map_plain(torch.from_numpy(imgs), 7.0, 20.0, 1e4)
    for b in range(3):
        one = fast_score.fast_score_map_plain(torch.from_numpy(imgs[b])[None], 7.0, 20.0, 1e4)
        assert torch.equal(out[b], one[0])


def test_k2_wrapper_on_cpu_takes_the_plain_version_and_checks_inputs():
    img = torch.from_numpy(blob_image(30, 50))[None]
    before = fast_score.fast_score_map.launches
    out = fast_score.fast_score_map(img, 7.0, 20.0, 1e4)
    assert fast_score.fast_score_map.launches == before
    assert torch.equal(out, fast_score.fast_score_map_plain(img, 7.0, 20.0, 1e4))
    with pytest.raises(ValueError, match="float32"):
        fast_score.fast_score_map(img.double())
    with pytest.raises(ValueError, match="float32"):
        fast_score.fast_score_map(img[0])
    with pytest.raises(ValueError, match="contiguous"):
        fast_score.fast_score_map(img.transpose(1, 2))


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_arc_min_score_map_matches_jax(threshold):
    img = blob_image(64, 90, seed=3) + np.float32(0.25)
    ref = np.asarray(jorb.fast_score_map(jnp.asarray(img), threshold))
    out = torb.fast_score_map(torch.from_numpy(img), threshold).numpy()
    assert (ref > 0).sum() > 20
    np.testing.assert_array_equal(out, ref)


def test_local_maxima_matches_jax():
    img = blob_image(64, 90, seed=4)
    score = np.array(jorb.fast_score_map(jnp.asarray(img), 7.0))
    ref = np.asarray(jorb._local_maxima(jnp.asarray(score)))
    out = torb._local_maxima(torch.from_numpy(score)).numpy()
    np.testing.assert_array_equal(out, ref)
