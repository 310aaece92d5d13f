"""The port's Mask R-CNN trainer (dspslam_tpu_torch/detect/maskrcnn_train.py)
against dspslam_tpu/detect/maskrcnn_train.py on the CPU, at the trainer's
small config (float32 backbone) on a 96 x 160 scene with two instances. Both
packages take one numpy-seeded parameter tree (`params_from_jax`) and the
same targets.

Tolerances: anchors, RPN labels, proposal jitter, class targets and mask
targets equal; deltas within 1e-5 (relative, too, for the invalid NMS
slots whose 1e-3-wide boxes scale their deltas to ~1e2); the loss and each of its five terms
within 1e-5 relative; every parameter's gradient within 1e-4 of its largest
entry (f32 sums over a float32 backbone in other orders); RoIAlign over the
FPN levels (the port's per-box gather, JAX's one-hot einsum) gives each
feature the same gradient within 1e-6. The mask head's upsample is a
transposed convolution in the port and a resize + convolution in JAX (R12):
its kernel repeats one phase (tests/deconv_parity.py), where the two
forwards agree, and its gradient is compared as the centre tap's (the sum
over the phases). The closed loop of
tests/test_detector_closed_loop.py runs as a `slow` test, as there, and on
the card in chip_smoke.py phase 12c.
"""

import dataclasses
import importlib.util
import os

import deconv_parity
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.detect import maskrcnn as jmr
from dspslam_tpu.detect import maskrcnn_train as jmt
from dspslam_tpu_torch.detect import layers
from dspslam_tpu_torch.detect import maskrcnn as tmr
from dspslam_tpu_torch.detect import maskrcnn_train as tmt
from torch_threads import one_torch_thread  # noqa: F401

JCFG = dataclasses.replace(jmt.small_config(), rpn_pre_nms=64, rpn_post_nms=16)
TCFG = tmr.MaskRCNNConfig(**dataclasses.asdict(JCFG))
HW = (96, 160)


@pytest.fixture(scope="module")
def scene():
    return tmt.make_scene(np.random.default_rng(3), h=HW[0], w=HW[1], n_obj=2)


@pytest.fixture(scope="module")
def params():
    """He-normal weights and small biases from numpy, in both packages."""
    rng = np.random.default_rng(0)

    def fill(t):
        fan_in = t[0].numel() if t.ndim == 4 else t.shape[0]
        scale = np.sqrt(2.0 / fan_in) if t.ndim > 1 else 0.05
        return (rng.normal(size=tuple(t.shape)) * scale).astype(np.float32)

    port, jax_np = deconv_parity.split(layers.tree_map(fill, tmr.init_params(TCFG)))
    return jax.tree_util.tree_map(jnp.asarray, jax_np), port


@pytest.fixture(scope="module")
def jax_targets(scene):
    _, gt, masks = scene
    return jmt.build_targets(np.random.default_rng(5), gt, masks, HW, JCFG)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def test_scene_and_targets_match_jax(scene, jax_targets):
    img, gt, masks = scene
    j_img, j_gt, j_masks = jmt.make_scene(np.random.default_rng(3), h=HW[0], w=HW[1], n_obj=2)
    np.testing.assert_array_equal(img, j_img)
    np.testing.assert_array_equal(gt, j_gt)
    np.testing.assert_array_equal(masks, j_masks)
    anchors = tmt.all_anchors(HW, TCFG)
    np.testing.assert_array_equal(anchors, jmt.all_anchors(HW, JCFG))
    labels, deltas = tmt.rpn_targets(anchors, gt)
    j_labels, j_deltas = jmt.rpn_targets(anchors, gt)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_allclose(deltas, j_deltas, rtol=0, atol=1e-5)
    t = tmt.build_targets(np.random.default_rng(5), gt, masks, HW, TCFG, "cpu")
    j = jax_targets
    for k in ("rpn_labels", "proposals", "roi_cls", "mask_targets"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    np.testing.assert_allclose(t["roi_deltas"].numpy(), np.asarray(j["roi_deltas"]), rtol=0, atol=1e-5)
    assert t["mask_targets"].sum() > 0 and (t["roi_cls"] == tmt.CAR_LOGIT_COL).any()


def test_mined_rpn_targets_match_jax(params, scene):
    jp, np_params = params
    img, gt, masks = scene
    tp = tmr.params_from_jax(np_params)
    props, cls, deltas, mask_t = tmt.mine_rpn_targets(tp, torch.from_numpy(img), gt, masks, HW, TCFG)
    j_props, j_cls, j_deltas, j_mask = jmt.mine_rpn_targets(jp, jnp.asarray(img), gt, masks, HW, JCFG)
    np.testing.assert_allclose(props.numpy(), j_props, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(cls.numpy(), j_cls)
    np.testing.assert_allclose(deltas.numpy(), j_deltas, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mask_t.numpy(), j_mask)


def test_loss_and_gradients_match_jax(params, scene, jax_targets):
    jp, np_params = params
    img, gt, masks = scene
    j_targets = jmt.augment_with_rpn(jp, jnp.asarray(img), jax_targets, gt, masks, HW, JCFG)
    value_and_grad = jax.jit(jax.value_and_grad(jmt.loss_fn, has_aux=True), static_argnums=(3, 4))
    (j_loss, j_aux), j_grads = value_and_grad(jp, jnp.asarray(img), j_targets, HW, JCFG)
    tp = layers.trainable(tmr.params_from_jax(np_params), "cpu")
    targets = {k: torch.from_numpy(np.array(v)) for k, v in j_targets.items()}
    loss, aux = tmt.loss_fn(tp, torch.from_numpy(img), targets, HW, TCFG)
    loss.backward()
    assert _rel(j_loss, loss.item()) <= 1e-5
    for k in j_aux:
        assert _rel(j_aux[k], aux[k].item()) <= 1e-5, k
    j_leaves = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    t_leaves = jax.tree_util.tree_leaves(tp)          # the same sorted-key order
    assert len(j_leaves) == len(t_leaves) == len(layers.leaves(tp))
    for (path, jg), tg in zip(j_leaves, t_leaves):
        if deconv_parity.is_deconv(path):
            assert _rel(np.asarray(jg)[:, :, 1, 1], deconv_parity.centre_grad(tg.grad.numpy())) <= 1e-4
        else:
            assert _rel(jg, tg.grad.numpy()) <= 1e-4


def test_roi_align_fpn_gradient_matches_the_one_hot_select():
    """The port gathers each box's own FPN level where JAX multiplies a
    one-hot level mask into all four alignments: the same sums, so the same
    gradient for every feature."""
    rng = np.random.default_rng(7)
    # P2..P5 of a 512 x 896 image; one box per level
    feats_np = [rng.normal(size=(1, 4, 128 // 2**i, 224 // 2**i)).astype(np.float32) for i in range(4)]
    boxes = np.array([[2, 3, 20, 30], [30, 10, 200, 150], [10, 5, 500, 400], [0, 0, 880, 500]], np.float32)
    w = rng.normal(size=(4, 4, 7, 7)).astype(np.float32)
    j_g = jax.grad(lambda fs: jnp.sum(jmr.roi_align_fpn(fs, jnp.asarray(boxes), 7) * w))(
        [jnp.asarray(f) for f in feats_np])
    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats_np]
    torch.sum(tmr.roi_align_fpn(tf, torch.from_numpy(boxes), 7) * torch.from_numpy(w)).backward()
    assert tmr.fpn_level_of(torch.from_numpy(boxes)).tolist() == [0, 1, 2, 3]
    for jg, t in zip(j_g, tf):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def test_train_steps_run_and_detector_takes_the_result(scene):
    """Three steps of overfit_scene on the CPU: the loss terms stay finite,
    the parameters move, and Detector2D takes the trained tree."""
    params, img, gt, _ = tmt.overfit_scene(TCFG, steps=3, seed=1, refresh=2, device="cpu")
    assert not any(t.requires_grad for t in layers.leaves(params))
    fresh = tmr.init_params(TCFG, torch.Generator().manual_seed(1))
    assert not torch.equal(params["fc1"]["w"], fresh["fc1"]["w"])
    out = tmr.Detector2D(params=params, cfg=TCFG, device="cpu").make_prediction(img)
    assert out["pred_boxes"].shape[1] == 5 and gt.shape == (3, 4)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tmt.overfit_scene(TCFG, steps=1)


def test_closed_loop_tool_defaults_to_the_card():
    """tools/closed_loop_seeds.py runs the port on the card unless the CPU
    is asked for, and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "closed_loop_seeds.py")
    spec = importlib.util.spec_from_file_location("closed_loop_seeds", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["maskrcnn", "--seeds", "0"])


def test_deterministic_restores_the_mode():
    was = torch.are_deterministic_algorithms_enabled()
    with layers.deterministic():
        assert torch.are_deterministic_algorithms_enabled()
    assert torch.are_deterministic_algorithms_enabled() == was


def _scene_detections():
    _, gt, masks = tmt.make_scene(np.random.default_rng(4))
    boxes = np.concatenate([gt, np.full((len(gt), 1), 0.9, np.float32)], axis=1)
    return gt, masks, boxes, masks > 0


def test_closed_loop_report_passes_the_planted_instances():
    """The detections equal to the planted boxes and masks pass every
    check of tests/test_detector_closed_loop.py's Mask R-CNN case."""
    gt, masks, boxes, pm = _scene_detections()
    rep = tmt.closed_loop_report(boxes, pm, gt, masks)
    assert rep["ok"] and rep["detections"] == len(gt)
    np.testing.assert_allclose(rep["box_iou"] + rep["mask_iou"] + rep["overlap"], 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fault", ["spurious", "shifted", "mask", "missing", "none"])
def test_closed_loop_report_fails_as_the_closed_loop_test(fault):
    """Each way the closed-loop test fails: a detection overlapping no
    instance by more than IoU 0.3, a box at IoU 0.5 or less, a mask at IoU
    0.5 or less, an instance without a detection, no detection at all."""
    gt, masks, boxes, pm = _scene_detections()
    if fault == "spurious":
        x0, y0, x1, y1 = gt[0]
        far = np.array([[x0 + 0.8 * (x1 - x0), y0, x1 + 0.8 * (x1 - x0), y1, 0.8]], np.float32)
        boxes, pm = np.concatenate([boxes, far]), np.concatenate([pm, pm[:1]])
    elif fault == "shifted":
        boxes[1, [0, 2]] += 0.4 * (gt[1, 2] - gt[1, 0])
    elif fault == "mask":
        pm[2] = np.zeros_like(pm[2])
    elif fault == "missing":
        boxes, pm = boxes[:-1], pm[:-1]
    else:
        boxes, pm = boxes[:0], pm[:0]
    rep = tmt.closed_loop_report(boxes, pm, gt, masks)
    assert not rep["ok"]
    assert rep["clean"] == (fault != "spurious")
    assert rep["found"] == (fault == "spurious")


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 2, 3])
def test_maskrcnn_closed_loop_recovers_planted_instances(seed):
    """tests/test_detector_closed_loop.py's Mask R-CNN case with the port's
    trainer: every planted instance found with box and mask IoU > 0.5
    through the inference path, and no spurious detection. Seeds 2 and 3
    made a spurious detection (IoU 0.25 and 0.11) with the JAX trainer's
    mining refresh of 100 steps (ROADMAP R8)."""
    cfg = tmt.small_config()
    params, img, gt, gt_masks = tmt.overfit_scene(cfg, steps=600, seed=seed, device="cpu")
    out = tmr.Detector2D(params=params, cfg=cfg, device="cpu").make_prediction(img)
    rep = tmt.closed_loop_report(out["pred_boxes"], out["pred_masks"], gt, gt_masks)
    assert rep["found"], (f"{rep['detections']} detections for {len(gt)} gt; box IoU {rep['box_iou']}, "
                          f"mask IoU {rep['mask_iou']}")
    assert rep["clean"], f"spurious detection: best overlaps {rep['overlap']}"
