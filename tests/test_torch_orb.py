"""ORB extraction of the PyTorch port against dspslam_tpu/frontend/orb.py.

Inputs are LayeredWorld renders (integer-valued like camera frames), or
random images, made with numpy from a seed. Tolerances and why:

* pyramid resize: <= 2e-2 on 0-255 against `jax.image.resize`. The port
  applies JAX's own antialiased weight matrices in f32; what is left is the
  rounding of JAX's CPU einsum, measured at ~1e-2 against a float64
  evaluation of the same matrices.
* select_keypoints, FAST maps, descriptors on level 0: EXACT. Level 0 is
  integer-valued, so scores and orientation moments are exact integer sums
  in f32, whatever the order of summation (the two atan2 implementations
  may still differ in the last bit of an angle).
* orientations: 1e-5 rad on an integer image; 1e-4 rad on a resized
  (non-integer) level, where the 961-term moment sums round differently
  in another order and atan2 amplifies that where the moments are small.
* gaussian_blur7: 1e-4 (shifted adds; a fused multiply-add rounds once).
* brief_descriptors: bit-exact; a differing bit is allowed only for a pair
  whose two blurred samples differ by < 1e-3, which the test checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.frontend import orb as jorb
from dspslam_tpu_torch.datasets.synthetic import LayeredWorld, forward_turn_trajectory
from dspslam_tpu_torch.frontend import orb as torb
from dspslam_tpu_torch.kernels import fast_score
from dspslam_tpu_torch.utils import timing
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def frame():
    world = LayeredWorld(480, 160, 400.0, x_range=(-1, 4), seed=1,
                         yaw_max=np.radians(40), z_range=(0, 5))
    return np.round(world.render_pose(forward_turn_trajectory(3)[1])).astype(np.float32)


@pytest.fixture(scope="module")
def level1(frame):
    h, w = torb.level_shapes(torb.ORBParams(), *frame.shape)[1]
    return np.array(jax.image.resize(jnp.asarray(frame), (h, w), "bilinear"))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_resize_matches_jax_at_every_kitti_level():
    H, W = 376, 1241
    img = np.random.default_rng(0).integers(0, 256, (H, W)).astype(np.float32)
    shapes = torb.level_shapes(torb.ORBParams(), H, W)
    assert shapes[-1] == (105, 346)
    for h, w in shapes[1:]:
        ref = np.asarray(jax.image.resize(jnp.asarray(img), (h, w), "bilinear"))
        out = torb.resize(_t(img), h, w).numpy()
        assert out.shape == (h, w)
        assert np.abs(out - ref).max() <= 2e-2, (h, w)


def test_select_keypoints_exact_with_tied_scores(frame):
    score = fast_score.fast_score_map_plain(_t(frame)[None], 7.0, 20.0, 1e4)[0].numpy()
    vals = score[score > 0]
    assert len(vals) > len(np.unique(vals)) + 50          # many integer ties
    for k, cell, per_cell in [(300, 16, 4), (1000, 30, 2)]:
        ref = jorb.select_keypoints(jnp.asarray(score), k, cell, per_cell)
        out = torb.select_keypoints(_t(score), k, cell, per_cell)
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _keypoints(img, n=400):
    score = np.array(jorb.fast_score_map(jnp.asarray(img), 7.0))
    xy, _, valid = jorb.select_keypoints(jnp.asarray(score), n)
    return np.array(xy)[np.asarray(valid) > 0]


def test_orientations_integer_image(frame):
    xy = _keypoints(frame)
    ref = np.asarray(jorb.orientations(jnp.asarray(frame), jnp.asarray(xy)))
    out = torb.orientations(_t(frame), _t(xy)).numpy()
    assert np.abs(out - ref).max() <= 1e-5


def test_orientations_resized_level(level1):
    xy = _keypoints(level1)
    ref = np.asarray(jorb.orientations(jnp.asarray(level1), jnp.asarray(xy)))
    out = torb.orientations(_t(level1), _t(xy)).numpy()
    assert np.abs(out - ref).max() <= 1e-4


@pytest.mark.parametrize("which", ["frame", "level1"])
def test_gaussian_blur7(which, request):
    img = request.getfixturevalue(which)
    ref = np.asarray(jorb.gaussian_blur7(jnp.asarray(img)))
    out = torb.gaussian_blur7(_t(img)).numpy()
    assert np.abs(out - ref).max() <= 1e-4


@pytest.mark.parametrize("which", ["frame", "level1"])
def test_brief_descriptors_bits(which, request):
    img = request.getfixturevalue(which)
    xy = _keypoints(img)
    ang = np.asarray(jorb.orientations(jnp.asarray(img), jnp.asarray(xy)))
    pattern = jorb.brief_pattern(1234)
    blurred = np.asarray(jorb.gaussian_blur7(jnp.asarray(img)))
    ref = np.asarray(jorb.brief_descriptors(
        jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(ang), jnp.asarray(pattern)))
    out = torb.brief_descriptors(
        torb.gaussian_blur7(_t(img)), _t(xy), _t(ang), _t(pattern.astype(np.float32))
    ).numpy().view(np.uint32)
    assert ref.dtype == np.uint32 and out.shape == ref.shape
    bits = lambda d: np.unpackbits(d.view(np.uint8), bitorder="little").reshape(len(d), 256)
    diff = np.argwhere(bits(out) != bits(ref))
    if len(diff):
        # sample values JAX compared for each differing test pair
        fx, fy = jorb._rotated_offsets(jnp.asarray(xy), jnp.asarray(ang), jnp.asarray(pattern))
        H, W = img.shape
        gx = np.clip(np.round(np.asarray(fx)), 0, W - 1).astype(int)
        gy = np.clip(np.round(np.asarray(fy)), 0, H - 1).astype(int)
        vals = blurred[gy, gx]
        for kp, bit in diff:
            assert abs(vals[kp, bit, 0] - vals[kp, bit, 1]) < 1e-3
    assert len(diff) <= 8


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_extract_single_level_equals_jax(frame, backend):
    """"xla": the arc-min path against JAX's default (the CPU takes its XLA
    path); "pallas": K2's plain version against JAX's fast_backend="pallas"
    (the Pallas kernel in interpret mode). Exact, but for the angles: the
    moments are exact integer sums, and XLA's and PyTorch's atan2 may then
    differ in the last bit (1e-6 rad)."""
    img = frame.astype(np.uint8)
    ref = jax.device_get(jorb.extract(
        jnp.asarray(img), jorb.ORBParams(n_features=500, n_levels=1, fast_backend=backend)))
    out = torb.extract(_t(img), torb.ORBParams(n_features=500, n_levels=1, fast_backend=backend))
    assert set(out) == set(ref)
    for k in ref:
        o = out[k].numpy()
        if k == "desc":
            o = o.view(np.uint32)
        assert o.dtype == np.asarray(ref[k]).dtype, k
        if k == "angle":
            assert np.abs(o - ref[k]).max() <= 1e-6
        else:
            np.testing.assert_array_equal(o, np.asarray(ref[k]), err_msg=k)
    assert out["valid"].sum() > 300


def test_auto_backend_is_the_arc_min_path_on_the_cpu(frame):
    auto = torb.extract(_t(frame), torb.ORBParams(n_features=300, n_levels=1))
    xla = torb.extract(_t(frame), torb.ORBParams(n_features=300, n_levels=1, fast_backend="xla"))
    for k in auto:
        assert torch.equal(auto[k], xla[k]), k


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_extract_level_on_jax_level_images(frame, backend):
    """Three levels: each level image is JAX's own resize, so only the
    per-level program is compared. Keypoints, responses and descriptors
    are exact; angles within 1e-4 rad (see the module docstring)."""
    jp = jorb.ORBParams(n_features=500, n_levels=3, fast_backend=backend)
    tp = torb.ORBParams(n_features=500, n_levels=3, fast_backend=backend)
    ref = jax.device_get(jorb.extract(jnp.asarray(frame), jp))
    pattern = torb.brief_pattern_tensor(tp, CPU)
    outs = []
    for level, (h, w) in enumerate(torb.level_shapes(tp, *frame.shape)):
        img = frame if level == 0 else np.array(jax.image.resize(jnp.asarray(frame), (h, w), "bilinear"))
        score = torb.two_tier_scores([_t(img)], tp)[0]
        outs.append(torb.extract_level(_t(img), level, tp, pattern, score))
    out = {k: torch.cat([o[k] for o in outs]).numpy() for k in outs[0]}
    out["desc"] = out["desc"].view(np.uint32)
    for k in ref:
        if k == "angle":
            assert np.abs(out[k] - ref[k]).max() <= 1e-4
        else:
            np.testing.assert_array_equal(out[k], np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_extract_stereo_equals_two_extract_calls(frame, backend):
    """The stereo entry (both pyramids first, one K2 call for all levels of
    both images) returns bit for bit what two `extract` calls return."""
    params = torb.ORBParams(n_features=500, n_levels=3, fast_backend=backend)
    right = np.roll(frame, -7, axis=1).astype(np.uint8)
    left = frame.astype(np.uint8)
    before = timing.totals().get("k2_launches", 0)
    out_l, out_r = torb.extract_stereo(_t(left), _t(right), params)
    assert timing.totals().get("k2_launches", 0) == before      # CPU: plain version
    for out, img in ((out_l, left), (out_r, right)):
        ref = torb.extract(_t(img), params)
        assert set(out) == set(ref)
        for k in ref:
            assert torch.equal(out[k], ref[k]), k
    assert not torch.equal(out_l["xy"], out_r["xy"])
    with pytest.raises(ValueError, match="shape"):
        torb.extract_stereo(_t(left), _t(left[:, :-1]), params)


def test_extract_stereo_keeps_jax_level0_parity(frame):
    """Level 0 of the stereo entry on K2's response against JAX's
    fast_backend="pallas" (the Pallas kernel in interpret mode), as
    test_extract_single_level_equals_jax checks `extract`."""
    img = frame.astype(np.uint8)
    right = np.roll(img, -5, axis=1)
    jp = jorb.ORBParams(n_features=500, n_levels=1, fast_backend="pallas")
    tp = torb.ORBParams(n_features=500, n_levels=1, fast_backend="pallas")
    outs = torb.extract_stereo(_t(img), _t(right), tp)
    for out, im in zip(outs, (img, right)):
        ref = jax.device_get(jorb.extract(jnp.asarray(im), jp))
        for k in ref:
            o = out[k].numpy()
            if k == "desc":
                o = o.view(np.uint32)
            if k == "angle":
                assert np.abs(o - ref[k]).max() <= 1e-6
            else:
                np.testing.assert_array_equal(o, np.asarray(ref[k]), err_msg=k)
        assert out["valid"].sum() > 300


def test_unported_modes_raise(frame):
    """"onehot" (a TPU gather workaround) is not carried over; neither mode
    takes a value outside the ported set."""
    with pytest.raises(NotImplementedError, match="orient_mode"):
        torb.extract(_t(frame), torb.ORBParams(n_levels=1, orient_mode="onehot"))
    with pytest.raises(NotImplementedError, match="brief_mode"):
        torb.extract(_t(frame), torb.ORBParams(n_levels=1, brief_mode="onehot"))


def test_params_budgets_match_jax():
    for kw in [{}, {"n_features": 500, "n_levels": 3}, {"n_features": 1000, "scale_factor": 1.3}]:
        assert torb.ORBParams(**kw).features_per_level() == jorb.ORBParams(**kw).features_per_level()
        assert torb.ORBParams(**kw).level_scales() == jorb.ORBParams(**kw).level_scales()
    np.testing.assert_array_equal(
        torb.pattern_for(torb.ORBParams(pattern="reference")),
        jorb.pattern_for(jorb.ORBParams(pattern="reference")),
    )


def test_undistort_is_the_jax_package_copy():
    from dspslam_tpu.frontend import undistort as jund
    from dspslam_tpu_torch.frontend import undistort as tund

    K = np.array([[718.856, 0, 607.19], [0, 718.856, 185.22], [0, 0, 1.0]])
    dist = (-0.28, 0.07, 1e-4, -2e-4, 0.0)
    xy = np.random.default_rng(5).uniform([0, 0], [1241, 376], (50, 2)).astype(np.float32)
    np.testing.assert_array_equal(tund.undistort_points(xy, K, dist), jund.undistort_points(xy, K, dist))
    np.testing.assert_array_equal(tund.distort_points(xy, K, dist), jund.distort_points(xy, K, dist))
    assert tund.undistorted_bounds(1241, 376, K, dist) == jund.undistorted_bounds(1241, 376, K, dist)
    assert not tund.has_distortion((0.0,) * 5) and tund.has_distortion(dist)
