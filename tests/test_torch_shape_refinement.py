"""Warm-started shape refinement: tests/test_shape_refinement.py's scene (a
radius-1 sphere re-observed from 5 or 6 keyframes 0.25 m apart, each
detection with a Sim(3) init whose scale is 1.3x off, a code-8 sphere
decoder, 3 GN iterations) through the JAX package's ObjectPipeline and the
PyTorch port's (device="cpu"), with the same detections (the JAX test's
`make_detection`, its RNG reseeded before each run).

Checked: both packages make 4 refinements over 5 keyframes, and with
max_shape_refinements=2 both stop at 2; the world-radius errors per
keyframe are equal to 5 decimals and the codes agree within 1e-6.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import test_shape_refinement as jref  # noqa: E402

from dspslam_tpu_torch.models import deepsdf as tdeepsdf  # noqa: E402
from dspslam_tpu_torch.objects.detections import Detection as TDetection  # noqa: E402
from dspslam_tpu_torch.objects.pipeline import ObjectPipeline as TPipeline  # noqa: E402
from dspslam_tpu_torch.shape import gn as tgn  # noqa: E402
from dspslam_tpu_torch.slam import map as tmap  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_kf(cam_x):
    jkf = jref.make_kf(cam_x)
    f = tmap.Frame(0.0, dict(jkf.feats))
    f.T_cw = jkf.T_cw.copy()
    return tmap.KeyFrame(f)


def _run(pkg, n_kfs, max_refinements):
    jref.RNG = np.random.default_rng(11)
    if pkg == "jax":
        slam_map = jref.Map()
        pipeline = jref.make_pipeline(slam_map, max_refinements=max_refinements)
        return jref.run_sequence(pipeline, slam_map, n_kfs)
    slam_map = tmap.Map()
    pipeline = TPipeline(
        slam_map, tdeepsdf.SphereDecoder(tdeepsdf.make_sphere_params(code_len=jref.CODE_LEN, device="cpu")),
        tgn.GNConfig(code_len=jref.CODE_LEN, k4=0.0, num_iterations=3, max_grad_points=256),
        max_detections=4, max_surface_points=128, max_rays=256, extract_meshes=False,
        calibrate_scale_init=False, max_shape_refinements=max_refinements,
    )
    kf_ids, errs, obj = [], [], None
    for k in range(n_kfs):
        kf = _port_kf(k * 0.25)
        det = jref.make_detection(k * 0.25)
        kf.detections = [TDetection(**{f: getattr(det, f) for f in TDetection.__dataclass_fields__})]
        slam_map.add_keyframe(kf)
        pipeline.apply_keyframe(kf, pipeline.dispatch_keyframe(kf, kf_ids))
        kf_ids.append(kf.id)
        objs = [o for o in slam_map.objects.values() if not o.bad]
        assert len(objs) == 1
        obj = objs[0]
        errs.append(jref.world_radius_err(obj))
    return obj, errs


@pytest.mark.parametrize("n_kfs,bound,expected", [(5, 6, 4), (6, 2, 2)])
def test_refinements_match_jax(n_kfs, bound, expected):
    jobj, jerrs = _run("jax", n_kfs, bound)
    tobj, terrs = _run("torch", n_kfs, bound)
    assert tobj.n_shape_refinements == jobj.n_shape_refinements == expected
    np.testing.assert_allclose(terrs, jerrs, atol=1e-5)
    np.testing.assert_allclose(tobj.code, np.asarray(jobj.code), atol=1e-6)
    if bound == 6:
        assert terrs[0] > 0.04 and terrs[-1] < 0.5 * terrs[0] and terrs[-1] < 0.03
