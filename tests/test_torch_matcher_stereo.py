"""Descriptor matching and stereo matching of the PyTorch port against
dspslam_tpu/frontend/{matcher,stereo}.py.

Descriptors are uint32 words in JAX and their int32 bit view in the port.
Distances are integers and the masks booleans, so matching is compared
EXACTLY, with ties on purpose (both argmins return the first minimum).
stereo_match: `valid` exactly; `u_right` and `depth` within 1e-4 (the SADs
are exact integer sums on integer images; the parabola step and bf / d
are a few f32 operations). One case has an even count of SADs entering
the median gate, which pins the two-middle-value average of nanmedian.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.frontend import matcher as jm
from dspslam_tpu.frontend import orb as jorb
from dspslam_tpu.frontend import stereo as jst
from dspslam_tpu_torch.datasets.synthetic import LayeredWorld
from dspslam_tpu_torch.frontend import matcher as tm
from dspslam_tpu_torch.frontend import stereo as tst


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _desc(rng, n):
    d = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    d[::3, :] |= np.uint32(1 << 31)                        # bit 31 set often
    return d


def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    a, b = _desc(rng, 37), _desc(rng, 51)
    b[:5] = a[:5]                                          # distance 0
    b[5] = ~a[5]                                           # distance 256
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    out = tm.hamming_matrix(_t(a), _t(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ref[5, 5] == 256 and (np.diag(ref)[:5] == 0).all()


@pytest.mark.parametrize("ratio,mutual", [(0.9, True), (None, True), (0.9, False), (None, False)])
def test_masked_match_with_ties(ratio, mutual):
    rng = np.random.default_rng(1)
    dist = rng.integers(20, 60, (60, 45)).astype(np.int32)    # many ties
    mask = rng.uniform(size=dist.shape) < 0.5
    ref = jm.masked_match(jnp.asarray(dist), jnp.asarray(mask), 50, ratio, mutual)
    out = tm.masked_match(_t(dist), _t(mask), 50, ratio, mutual)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert (np.asarray(ref[0]) >= 0).sum() > 3


def test_window_mask_and_projection_search():
    rng = np.random.default_rng(2)
    n, m = 80, 120
    xy_a = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    xy_b = rng.uniform(0, 100, (m, 2)).astype(np.float32)
    va = (rng.uniform(size=n) < 0.9).astype(np.float32)
    vb = (rng.uniform(size=m) < 0.9).astype(np.float32)
    la = rng.integers(0, 4, n).astype(np.int32)
    lb = rng.integers(0, 4, m).astype(np.int32)
    for levels in [(None, None), (la, lb)]:
        ref = jm.window_mask(jnp.asarray(xy_a), jnp.asarray(xy_b), 15.0, jnp.asarray(va),
                             jnp.asarray(vb), *(None if l is None else jnp.asarray(l) for l in levels))
        out = tm.window_mask(_t(xy_a), _t(xy_b), 15.0, _t(va), _t(vb),
                             *(None if l is None else _t(l) for l in levels))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    desc_a, desc_b = _desc(rng, n), _desc(rng, m)
    desc_b[: n // 2] = desc_a[: n // 2] ^ np.uint32(0x0F0F)   # close pairs
    feats = {"xy": xy_b, "desc": desc_b, "valid": vb, "level": lb}
    for slack in (None, 1):
        ref = jm.match_by_projection(jnp.asarray(xy_a), jnp.asarray(va), jnp.asarray(desc_a),
                                     jnp.asarray(la), {k: jnp.asarray(v) for k, v in feats.items()},
                                     radius=30.0, level_slack=slack)
        out = tm.match_by_projection(_t(xy_a), _t(va), _t(desc_a), _t(la),
                                     {k: _t(v) for k, v in feats.items()}, radius=30.0,
                                     level_slack=slack)
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_rotation_consistency_exact():
    rng = np.random.default_rng(3)
    ang_a = rng.uniform(-np.pi, np.pi, 90).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 70).astype(np.float32)
    idx = rng.integers(-1, 70, 90).astype(np.int32)
    ang_a[:40] = ang_b[np.maximum(idx[:40], 0)] + 0.1      # a dominant bin
    ref = jm.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(idx))
    out = tm.rotation_consistency(_t(ang_a), _t(ang_b), _t(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("values", [
    [3.0, np.nan, 1.0, 7.0, np.nan, 5.0],                 # even count
    [3.0, np.nan, 1.0, 7.0, 2.0],                         # odd count
    [np.nan, np.nan, np.nan],                             # none
    [4.0, 4.0],
])
def test_nanmedian(values):
    x = np.asarray(values, np.float32)
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    out = tst.nanmedian(_t(x)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.fixture(scope="module")
def stereo_pair():
    H, W, fx, b = 160, 480, 400.0, 0.4
    world = LayeredWorld(W, H, fx, depths=(30.0, 14.0, 8.0), x_range=(-1.0, 3.0), seed=5)
    img_l = np.round(world.render(0.5)).astype(np.uint8)
    img_r = np.round(world.render(0.5, b)).astype(np.uint8)
    p = jorb.ORBParams(n_features=400, n_levels=2)
    feats = [jax.device_get(jorb.extract(jnp.asarray(im), p)) for im in (img_l, img_r)]
    return img_l, img_r, feats, fx * b


def _stereo_both(img_l, img_r, fl, fr, bf):
    ref = jst.stereo_match({k: jnp.asarray(v) for k, v in fl.items()},
                           {k: jnp.asarray(v) for k, v in fr.items()},
                           jnp.asarray(img_l), jnp.asarray(img_r),
                           jnp.float32(bf), jnp.float32(bf / 0.5))
    out = tst.stereo_match({k: _t(v) for k, v in fl.items()}, {k: _t(v) for k, v in fr.items()},
                           _t(img_l), _t(img_r), bf, bf / 0.5)
    return jax.device_get(ref), {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("drop", [0, 1])
def test_stereo_match(stereo_pair, drop):
    """drop=1 removes one keypoint that was a valid match, so that the two
    cases have SAD counts of both parities at the median gate."""
    img_l, img_r, (fl, fr), bf = stereo_pair
    fl = dict(fl)
    if drop:
        ref0, _ = _stereo_both(img_l, img_r, fl, fr, bf)
        first_valid = int(np.nonzero(ref0["valid"] > 0)[0][0])
        fl["valid"] = fl["valid"].copy()
        fl["valid"][first_valid] = 0.0
    ref, out = _stereo_both(img_l, img_r, fl, fr, bf)
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    assert np.abs(out["u_right"] - ref["u_right"]).max() <= 1e-4
    assert np.abs(out["depth"] - ref["depth"]).max() <= 1e-4
    assert ref["valid"].sum() > 100


def test_depth_to_virtual_right():
    u = np.array([100.0, 200.0, 300.0], np.float32)
    d = np.array([2.0, -1.0, 0.0], np.float32)
    ref = jst.depth_to_virtual_right(jnp.asarray(u), jnp.asarray(d), 160.0)
    out = tst.depth_to_virtual_right(_t(u), _t(d), 160.0)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
