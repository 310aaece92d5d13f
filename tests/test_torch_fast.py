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
from dspslam_tpu_torch.utils import timing


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
    img = torch.from_numpy(blob_image(30, 50))
    before = timing.totals().get("k2_launches", 0)
    (out,) = fast_score.fast_score_maps([img], 7.0, 20.0, 1e4)
    assert timing.totals().get("k2_launches", 0) == before
    assert torch.equal(out, fast_score.fast_score_map_plain(img[None], 7.0, 20.0, 1e4)[0])
    with pytest.raises(ValueError, match="float32"):
        fast_score.fast_score_maps([img.double()])
    with pytest.raises(ValueError, match="float32"):
        fast_score.fast_score_maps([img[None]])
    with pytest.raises(ValueError, match="contiguous"):
        fast_score.fast_score_maps([img.t()])
    with pytest.raises(ValueError, match="float32"):
        fast_score.fast_score_map_plain(img)


KITTI_LEVELS = torb.level_shapes(torb.ORBParams(), 376, 1241)


def test_multi_map_plain_is_the_plain_version_per_map():
    """The multi-map entry on CPU tensors: `fast_score_map_plain` of each map,
    whatever the shapes, in order; no kernel launch."""
    shapes = [(40, 70), (40, 70), (33, 21), (7, 5), (64, 90)]
    imgs = [torch.from_numpy(blob_image(h, w, seed=i)) for i, (h, w) in enumerate(shapes)]
    before = timing.totals().get("k2_launches", 0)
    outs = fast_score.fast_score_maps(imgs, 7.0, 20.0, 1e4)
    assert timing.totals().get("k2_launches", 0) == before
    assert len(outs) == len(imgs)
    for img, out in zip(imgs, outs):
        assert torch.equal(out, fast_score.fast_score_map_plain(img[None], 7.0, 20.0, 1e4)[0])
    assert sum(int((o >= 1e4).sum()) for o in outs) > 10


def kernel_tiles(table, n_tiles):
    """The kernel's block -> (map, pixels) mapping, mirrored: a binary search
    over the first-tile prefix, then the tile's 32 x 16 pixels clipped to
    the map (csrc/fast_score.cu)."""
    count = len(table)
    for block in range(n_tiles):
        m, step = 0, fast_score.MAX_MAPS // 2
        while step:
            if m + step < count and block >= table[m + step][4]:
                m += step
            step //= 2
        off, h, w, tiles_x, first = table[m]
        t = block - first
        by, bx = divmod(t, tiles_x)
        ys = np.arange(by * fast_score.TILE_H, min((by + 1) * fast_score.TILE_H, h))
        xs = np.arange(bx * fast_score.TILE_W, min((bx + 1) * fast_score.TILE_W, w))
        yield m, off + (ys[:, None] * w + xs[None, :]).ravel()


@pytest.mark.parametrize("shapes", [
    [s for s in KITTI_LEVELS for _ in (0, 1)],             # a KITTI stereo frame
    [(1, 1), (17, 33), (16, 32), (15, 31), (49, 130), (3, 200), (200, 3)],
], ids=["kitti_16_levels", "odd_shapes"])
def test_tile_table_covers_every_pixel_of_every_map_once(shapes):
    table = fast_score.tile_table(shapes)
    assert [(h, w) for _, h, w, _, _ in table] == shapes
    off, h, w, tiles_x, first = table[-1]
    n_tiles = first + tiles_x * -(-h // fast_score.TILE_H)
    total = sum(h * w for h, w in shapes)
    hits = np.zeros(total, np.int64)
    for m, pix in kernel_tiles(table, n_tiles):
        o, h, w = table[m][:3]
        assert pix.size and pix.min() >= o and pix.max() < o + h * w
        np.add.at(hits, pix, 1)
    assert (hits == 1).all()


def test_map_table_is_built_once_per_shapes_and_copied():
    """The launch's ctypes map table follows `tile_table`; each call gets a
    copy of the cached one, so filling in its sources leaves the cache
    alone."""
    shapes = tuple(s for s in KITTI_LEVELS for _ in (0, 1))
    table, n_tiles = fast_score._map_table(shapes)
    rows = fast_score.tile_table(shapes)
    assert table.count == len(rows)
    for i, (off, h, w, tiles_x, first) in enumerate(rows):
        d = table.map[i]
        assert (d.out, d.h, d.w, d.tiles_x, d.first_tile) == (off, h, w, tiles_x, first)
    off, h, w, tiles_x, first = rows[-1]
    assert n_tiles == first + tiles_x * -(-h // fast_score.TILE_H)
    table.map[0].src = 1234
    again, _ = fast_score._map_table(shapes)
    assert again.map[0].src is None
    assert fast_score._tables[shapes][0] is not table


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
