"""The monocular building blocks of the PyTorch port against the JAX package:
window matching for the two-view initialization, the initializer (numpy
copy), the PCA cuboid (numpy copy), the mono detection builder with its
numpy mask erosion, and the two ORB modes orient_mode="conv" and
brief_mode="patch".

Tolerances:
* match_in_windows: the same indices and distances, EXACT (integer
  distances, boolean masks, first-minimum argmins). Angles come from the
  same JAX extraction, so rotation bins cannot split on atan2's last bit.
* initializer: the same R, t, points, good mask and model, EXACT (a copy
  fed the same matches and the same RANSAC seed).
* cuboid: EXACT (a copy).
* build_mono_detection with mask_erosion = 10: the mask EXACTLY equal to
  JAX's, and so to `cv2.erode` (which the JAX package calls), rays exact.
* orient_mode="conv" and brief_mode="patch" through `extract` on an
  integer level 0: keypoints and descriptors EXACT, angles within 1e-6 rad
  (atan2's last bit); the two functions on JAX's resized level image:
  angles within 1e-4 rad (moment sums in another order, as for the patch
  orientations), descriptors EXACT.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.datasets import mono as jmono
from dspslam_tpu.frontend import matcher as jm
from dspslam_tpu.frontend import orb as jorb
from dspslam_tpu.objects import cuboid as jcuboid
from dspslam_tpu.slam import initializer as jinit
from dspslam_tpu_torch.datasets import mono as tmono
from dspslam_tpu_torch.datasets.synthetic import LayeredWorld, strafe_yaw_trajectory
from dspslam_tpu_torch.frontend import matcher as tm
from dspslam_tpu_torch.frontend import orb as torb
from dspslam_tpu_torch.objects import cuboid as tcuboid
from dspslam_tpu_torch.slam import initializer as tinit
from torch_threads import one_torch_thread  # noqa: F401

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])


def _t(feats):
    out = {}
    for k, v in feats.items():
        v = np.array(v)
        out[k] = torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
    return out


@pytest.fixture(scope="module")
def two_views():
    """JAX ORB features of two frames of a strafing camera (160 x 480)."""
    world = LayeredWorld(480, 160, 400.0, x_range=(-1, 3), seed=3, yaw_max=np.radians(10))
    poses = strafe_yaw_trajectory(6, step=0.1, yaw_start=2, yaw_frames=3, total_yaw=np.radians(4.0))
    params = jorb.ORBParams(n_features=500, n_levels=3)
    return [jax.device_get(jorb.extract(jnp.asarray(np.round(world.render_pose(T)).astype(np.float32)),
                                        params)) for T in (poses[0], poses[1])]


def test_match_in_windows_equals_jax(two_views):
    a, b = two_views
    for radius in (100.0, 20.0):
        ref = jm.match_in_windows({k: jnp.asarray(v) for k, v in a.items()},
                                  {k: jnp.asarray(v) for k, v in b.items()}, radius=radius)
        out = tm.match_in_windows(_t(a), _t(b), radius=radius)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
        assert (out[0].numpy() >= 0).sum() > 50


def _project(X):
    h = X @ K.T
    return h[:, :2] / h[:, 2:3]


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _scene(which):
    """tests/test_mono.py's three initializer scenes, from their seeds."""
    rng = np.random.default_rng(11)
    if which == "general":
        X = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200), rng.uniform(4, 12, 200)], -1)
        R, t, noise, seed = _rot_y(0.06), np.array([0.5, 0.05, 0.02]), 0.3, 1
    elif which == "planar":
        x, y = rng.uniform(-4, 4, 200), rng.uniform(-3, 3, 200)
        X = np.stack([x, y, 6 + 0.3 * x], -1)
        R, t, noise, seed = _rot_y(0.04), np.array([0.8, 0.0, 0.1]), 0.2, 2
    else:
        return rng.uniform(0, 640, (100, 2)), rng.uniform(0, 640, (100, 2)), 3
    p1 = _project(X) + rng.normal(0, noise, (200, 2))
    p2 = _project(X @ R.T + t) + rng.normal(0, noise, (200, 2))
    return p1, p2, seed


@pytest.mark.parametrize("which", ["general", "planar", "noise"])
def test_initializer_equals_jax(which):
    p1, p2, seed = _scene(which)
    ref = jinit.initialize_two_view(p1, p2, K, seed=seed)
    out = tinit.initialize_two_view(p1, p2, K, seed=seed)
    assert (ref is None) == (out is None)
    if which == "noise":
        assert out is None or out["n_good"] < 30
        return
    assert out["model"] == ref["model"] == {"general": "F", "planar": "H"}[which]
    for k in ("R", "t", "points3d", "good_mask"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert out["n_good"] == ref["n_good"] > 100


def test_cuboid_equals_jax():
    rng = np.random.default_rng(4)
    local = rng.uniform(-0.5, 0.5, (300, 3)) * np.array([1.8, 1.5, 4.2])
    pts = np.concatenate([local @ _rot_y(0.5).T + [2.0, -0.5, 8.0],
                          rng.uniform(-20, 20, (30, 3)) + [2.0, -0.5, 8.0]])
    ref, out = jcuboid.compute_cuboid_pca(pts), tcuboid.compute_cuboid_pca(pts)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    T = out["T_wo_sim3"]
    np.testing.assert_array_equal(tcuboid.flipped_pose(T), jcuboid.flipped_pose(T))
    np.testing.assert_array_equal(tcuboid.floor_scale_to_domain(T, pts), jcuboid.floor_scale_to_domain(T, pts))
    verts = rng.uniform(-0.8, 0.8, (50, 3))
    np.testing.assert_array_equal(tcuboid.remove_outliers_model(pts, T, verts),
                                  jcuboid.remove_outliers_model(pts, T, verts))


@pytest.mark.parametrize("k", [1, 2, 3, 10])
def test_erode_box_is_cv2_erode(k):
    rng = np.random.default_rng(k)
    for _ in range(5):
        m = rng.uniform(size=(rng.integers(8, 70), rng.integers(8, 70))) < 0.9
        m[:, :3] = True                      # masks touching the border
        ref = cv2.erode(m.astype(np.uint8), np.ones((k, k), np.uint8)).astype(bool)
        np.testing.assert_array_equal(tmono.erode_box(m, k), ref)


def test_build_mono_detection_equals_jax():
    H, W = 120, 160
    yy, xx = np.mgrid[:H, :W]
    masks = np.stack([(xx - 70) ** 2 + (yy - 60) ** 2 < 45 ** 2, (xx < 30) & (yy < 30)])
    masks[0, :, :8] = True                   # erosion at the image border
    boxes = np.array([[25, 15, 116, 106], [0, 0, 30, 30]], np.float32)
    invK = np.linalg.inv(np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]])).astype(np.float32)
    for dist in (None, (-0.147571, -0.0943432, 0.0, 0.0, 0.0)):
        kw = dict(min_mask_area=500.0, bg_stride=4.0, max_bg_rays=200, mask_erosion=10, dist_coeffs=dist)
        ref = jmono.build_mono_detection(masks, boxes, invK, **kw)
        out = tmono.build_mono_detection(masks, boxes, invK, **kw)
        np.testing.assert_array_equal(out.mask, ref.mask)
        np.testing.assert_array_equal(out.mask, cv2.erode(masks[0].astype(np.uint8), np.ones((10, 10), np.uint8)) > 0)
        np.testing.assert_array_equal(out.rays, ref.rays)
        np.testing.assert_array_equal(out.bbox, ref.bbox)
        assert out.rays.shape[0] > 20 and out.num_foreground == 0
    assert tmono.build_mono_detection(masks[1:], boxes[1:], invK, min_mask_area=5000.0) is None


@pytest.mark.parametrize("orient_mode,brief_mode", [("conv", "patch"), ("conv", "auto"), ("patch", "patch")])
def test_orb_modes_equal_jax_on_level0(orient_mode, brief_mode):
    """Level 0 is integer-valued: the moment maps are exact integer sums."""
    world = LayeredWorld(480, 160, 400.0, x_range=(-1, 3), seed=1)
    img = np.round(world.render(0.3)).astype(np.float32)
    kw = dict(n_features=500, n_levels=1, orient_mode=orient_mode, brief_mode=brief_mode)
    ref = jax.device_get(jorb.extract(jnp.asarray(img), jorb.ORBParams(**kw)))
    out = torb.extract(torch.from_numpy(img), torb.ORBParams(**kw))
    assert ref["valid"].sum() > 300
    np.testing.assert_array_equal(out["xy"].numpy(), ref["xy"])
    assert np.abs(out["angle"].numpy() - ref["angle"]).max() <= 1e-6
    np.testing.assert_array_equal(out["desc"].numpy().view(np.uint32), ref["desc"])


def test_orientations_conv_and_brief_patch_on_a_resized_level():
    """orientations_conv and brief_descriptors_patch on JAX's own resized
    level image and keypoints: angles within 1e-4 rad, descriptors exact."""
    world = LayeredWorld(480, 160, 400.0, x_range=(-1, 3), seed=1)
    img = jax.image.resize(jnp.asarray(np.round(world.render(0.3)).astype(np.float32)), (111, 333), "bilinear")
    score = jorb.fast_score_map(img, 7.0)
    xy, _, valid = jorb.select_keypoints(score, 300)
    ang = jorb.orientations_conv(img, xy)
    pattern = jnp.asarray(jorb.brief_pattern())
    blur = jorb.gaussian_blur7(img)
    ref_desc = np.asarray(jorb.brief_descriptors_patch(blur, xy, ang, pattern))
    ti, txy, tang = (torch.from_numpy(np.array(a)) for a in (img, xy, ang))
    v = np.asarray(valid) > 0
    assert v.sum() > 200
    assert np.abs(torb.orientations_conv(ti, txy).numpy() - np.asarray(ang))[v].max() <= 1e-4
    out = torb.brief_descriptors_patch(torch.from_numpy(np.array(blur)), txy, tang,
                                       torch.from_numpy(np.array(pattern, np.float32)))
    np.testing.assert_array_equal(out.numpy().view(np.uint32)[v], ref_desc[v])
