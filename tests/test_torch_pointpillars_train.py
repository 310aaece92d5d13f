"""The port's PointPillars trainer (dspslam_tpu_torch/detect/pointpillars_train.py)
against dspslam_tpu/detect/pointpillars_train.py on the CPU, at a small
config (a 64 x 64 BEV grid, the cap above every scene's pillars), with
numpy-seeded weights carried across by `params_from_jax` and scans from
`make_box_scene`. As in tests/test_torch_pointpillars.py, points within 1%
of a voxel edge are dropped (XLA on the CPU computes the pillar assignment
with an FMA and a reciprocal), and so are the points of BEV cell (0, 0),
where the JAX canvas lets empty pillars erase a live one (ROADMAP R7).

Tolerances: scenes, assignment, box encoding equal (the port's trainers
then give the ignored band box targets, `regress_ignored`, ROADMAP R9); the cosine schedule
within 1e-6 of the initial rate of optax's at every step (optax evaluates
it in float32); the plain trainer's loss
(through the bf16 inference forward) within 1e-2 relative, its weight
gradients within 1e-2 of each tensor's largest entry (a few bf16 steps) and
every gradient at a cosine of at least 0.98 to JAX's (a bias gradient is a
bf16 sum over every BEV cell, rounded in bf16, and may be 0.5 of its largest
entry off where the sum cancels); the BN
trainer (float32): the loss within 1e-5 relative, the batch statistics
within 1e-5 of their largest, the gradients within 1e-4 of their largest
(the conv biases before a BN, whose exact gradient is 0, within 1e-5 of the
largest entry of any gradient),
and after one step the running statistics within 1e-6 and the parameters
within 1e-6 (those conv biases within 2 lr: Adam's first step moves a
parameter by about lr times the sign of its gradient, here of noise; and
the one weight these seeds give whose gradient is a cancelling sum below
Adam's eps in both, head_box w[7, 30], where the step is lr * g / eps and
so 2e5 times the gradient's rounding: both gradients there must stay below
eps, and the step within 2 lr); `fold_bn_state` within 1e-6 of JAX's fold. The three closed
loops of tests/test_detector_closed_loop.py run as `slow` tests, as there,
and on the card in chip_smoke.py phase 12c.

SECONDFPN's deblocks are transposed convolutions (kernel = stride) in the
port and a resize + convolution in JAX (R12): their kernels repeat one
phase (tests/deconv_parity.py), where the two forwards agree; their
gradients are compared as the centre tap's (the sum over the phases), a
step's update as the phases' mean against the centre tap (within 2 lr:
Adam's first step moves each by about lr times the sign of its own
gradient), and the folded kernel as its first phase.
"""

import dataclasses

import deconv_parity

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dspslam_tpu.detect import pointpillars as jpp
from dspslam_tpu.detect import pointpillars_train as jppt
from dspslam_tpu_torch.detect import layers
from dspslam_tpu_torch.detect import pointpillars as tpp
from dspslam_tpu_torch.detect import pointpillars_train as tppt
from torch_threads import one_torch_thread  # noqa: F401

JCFG = jpp.PointPillarsConfig(
    pc_range=(0.0, -10.24, -3.0, 20.48, 10.24, 1.0), voxel_size=(0.32, 0.32, 4.0), max_pillars=4096,
    max_points_per_pillar=16, pfn_channels=16, backbone_layers=(1, 1, 1), backbone_channels=(16, 32, 32),
    fpn_channels=(16, 16, 16), nms_pre=32, max_detections=8, score_threshold=0.3,
)
TCFG = tpp.PointPillarsConfig(**dataclasses.asdict(JCFG))
ADAM_EPS = 1e-8         # optax.adam's and layers.Trainer's


def clean(scan, cfg=JCFG, margin=0.01):
    """Drop points within 1% of a voxel edge and those of BEV cell (0, 0)."""
    qx = (scan[:, 0] - cfg.pc_range[0]) / cfg.voxel_size[0]
    qy = (scan[:, 1] - cfg.pc_range[1]) / cfg.voxel_size[1]
    fx, fy = qx % 1.0, qy % 1.0
    keep = (fx > margin) & (fx < 1 - margin) & (fy > margin) & (fy < 1 - margin)
    return scan[keep & ~((qx < 1) & (qy < 1))]


@pytest.fixture(scope="module")
def scene():
    scan, gt = tppt.make_box_scene(np.random.default_rng(5), TCFG, n_boxes=2)
    scan = clean(scan)
    cq = tpp.crop_quantize_points(scan, TCFG, point_cap=16384)
    targets = tppt.assign_targets(tppt.head_anchors(TCFG), gt)
    return cq, targets, gt


@pytest.fixture(scope="module")
def params():
    np_params = layers.tree_map(lambda t: t.numpy(), tpp.init_params(TCFG, torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(4)
    np_params = layers.tree_map(lambda a: a + (rng.normal(size=a.shape) * 0.05).astype(np.float32)
                                if a.ndim == 1 else a, np_params)
    port, jax_np = deconv_parity.split(np_params)
    return jax.tree_util.tree_map(jnp.asarray, jax_np), port


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _pillars(cq):
    return (jpp.build_pillars_from_points({k: jnp.asarray(v) for k, v in cq.items()}, JCFG),
            tpp.build_pillars_from_points({k: torch.as_tensor(np.asarray(v)) for k, v in cq.items()}, TCFG))


def test_scene_assignment_and_encoding_match_jax():
    scan, gt = tppt.make_box_scene(np.random.default_rng(9), TCFG, n_boxes=3)
    j_scan, j_gt = jppt.make_box_scene(np.random.default_rng(9), JCFG, n_boxes=3)
    np.testing.assert_array_equal(scan, j_scan)
    np.testing.assert_array_equal(gt, j_gt)
    anchors = tppt.head_anchors(TCFG)
    np.testing.assert_array_equal(anchors, jpp._anchors(JCFG, (JCFG.grid_size[1] // 2, JCFG.grid_size[0] // 2)))
    t, j = tppt.assign_targets(anchors, gt), jppt.assign_targets(anchors, gt)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert (t[0] == 1).sum() >= 3 and (t[0] == -1).any() and (t[0] == 0).any()
    np.testing.assert_array_equal(tppt.encode_boxes(gt, anchors[:3]), jppt.encode_boxes(gt, anchors[:3]))


def test_regress_ignored_targets_decode_to_the_nearest_box():
    """R9: the ignored band's anchors get the box and direction targets of
    their nearest planted box (they decode onto it) and the class target
    REGRESS_ONLY; positives and negatives keep assign_targets' targets; the
    loss regresses positives and REGRESS_ONLY anchors and equals JAX's on
    assign_targets' targets alone (test_loss_and_gradients_match_jax)."""
    scan, gt = tppt.make_box_scene(np.random.default_rng(9), TCFG, n_boxes=3)
    anchors = tppt.head_anchors(TCFG)
    base = tppt.assign_targets(anchors, gt)
    cls_t, reg_t, dir_t = tppt.regress_ignored(anchors, gt, base)
    ign = base[0] < 0
    assert ign.sum() > 20 and (cls_t[ign] == tppt.REGRESS_ONLY).all()
    for new, old in zip((cls_t, reg_t, dir_t), base):
        np.testing.assert_array_equal(new[~ign], old[~ign])
    boxes = tpp.decode_boxes(torch.from_numpy(reg_t[ign]), torch.from_numpy(anchors[ign])).numpy()
    nearest = np.linalg.norm(boxes[:, None, :2] - gt[None, :, :2], axis=-1).min(axis=1)
    assert nearest.max() < 1e-4
    np.testing.assert_allclose(boxes[:, 3:6], np.broadcast_to(gt[0, 3:6], boxes[:, 3:6].shape), rtol=1e-5)
    # the loss: box terms over the regressed anchors only
    n = len(anchors)
    zeros = torch.zeros(n, 7)
    ct = torch.from_numpy(cls_t)
    loss = tppt._head_loss(torch.full((n,), -5.0), zeros, torch.zeros(n, 2), ct, torch.from_numpy(reg_t),
                           torch.from_numpy(dir_t))
    only_pos = tppt._head_loss(torch.full((n,), -5.0), zeros, torch.zeros(n, 2), torch.from_numpy(base[0]),
                               torch.from_numpy(base[1]), torch.from_numpy(base[2]))
    assert loss.item() > only_pos.item()


def test_cosine_schedule_matches_optax():
    for init, decay in ((3e-3, 512), (2e-3, 1800)):
        ours, ref = tppt.cosine_decay(init, decay), optax.cosine_decay_schedule(init, decay)
        steps = list(range(0, decay + 20, 7)) + [decay - 1, decay, decay + 1]
        np.testing.assert_allclose([ours(k) for k in steps], [float(ref(k)) for k in steps], rtol=0, atol=1e-6 * init)
        assert ours(0) == init


def test_loss_and_gradients_match_jax(params, scene):
    jp, np_params = params
    cq, targets, _ = scene
    jpil, tpil = _pillars(cq)
    j_loss, j_grads = jax.value_and_grad(jppt.loss_fn)(jp, jpil, *[jnp.asarray(t) for t in targets], JCFG)
    tp = layers.trainable(tpp.params_from_jax(np_params), "cpu")
    loss = tppt.loss_fn(tp, tpil, *[torch.from_numpy(t) for t in targets], TCFG)
    loss.backward()
    assert _rel(j_loss, loss.item()) <= 1e-2
    for (path, jg), tg in zip(jax.tree_util.tree_flatten_with_path(j_grads)[0], jax.tree_util.tree_leaves(tp)):
        a, b = np.asarray(jg, np.float64), tg.grad.numpy().astype(np.float64)
        if deconv_parity.is_deconv(path):
            a, b = a[:, :, 1, 1], deconv_parity.centre_grad(b)
        a, b = a.ravel(), b.ravel()
        assert a @ b >= 0.98 * np.linalg.norm(a) * np.linalg.norm(b)
        if tg.ndim > 1:
            assert _rel(a, b) <= 1e-2


def _bn_states(np_params):
    rng = np.random.default_rng(6)
    j_bn = jax.tree_util.tree_map(lambda a: a, jppt.init_bn_state(JCFG))
    # non-trivial scale / shift and running statistics, the same in both
    j_bn = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(np.asarray(a) + (rng.uniform(0.0, 0.3, a.shape) if path[-1].key == "var"
                                                     else rng.normal(0, 0.1, a.shape)).astype(np.float32)), j_bn)
    t_bn = layers.tree_map(lambda a: torch.from_numpy(np.array(a)), j_bn)
    return j_bn, t_bn


def _pre_bn_bias(path) -> bool:
    return path[-1].key == "b" and path[0].key in ("blocks", "deblocks")


def test_bn_trainer_matches_jax(params, scene):
    """loss_fn_bn, its batch statistics and gradients; then one
    train_step_bn: the running statistics' EMA and the Adam update."""
    jp, np_params = params
    cq, targets, _ = scene
    jpil, tpil = _pillars(cq)
    j_bn, t_bn = _bn_states(np_params)
    (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(jppt.loss_fn_bn, has_aux=True), static_argnums=5)(
        (jp, j_bn), jpil, *[jnp.asarray(t) for t in targets], JCFG)
    tp = layers.trainable(tpp.params_from_jax(np_params), "cpu")
    for t in tppt.bn_trainables(t_bn):
        t.requires_grad_(True)
    loss, stats = tppt.loss_fn_bn(tp, t_bn, tpil, *[torch.from_numpy(t) for t in targets], TCFG)
    loss.backward()
    assert _rel(j_loss, loss.item()) <= 1e-5
    for js, ts in zip(jax.tree_util.tree_leaves(j_stats), jax.tree_util.tree_leaves(stats)):
        assert _rel(js, ts.detach().numpy()) <= 1e-5
    # a conv bias that feeds a BN has an exact gradient of 0 (the batch mean
    # removes it): there both give rounding noise, held to the largest entry
    # of any gradient
    largest = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(j_grads[0]))
    below_eps = []      # (leaf, index) where both gradients are nonzero and below Adam's eps
    for (path, jg), tg in zip(jax.tree_util.tree_flatten_with_path(j_grads[0])[0], jax.tree_util.tree_leaves(tp)):
        # the PFN's bias is not in the training forward: JAX's gradient is 0
        g = torch.zeros_like(tg) if tg.grad is None else tg.grad
        if not (deconv_parity.is_deconv(path) or _pre_bn_bias(path)):
            a, b = np.asarray(jg), g.numpy()
            tiny = (np.abs(a) < ADAM_EPS) & (np.abs(b) < ADAM_EPS) & ((a != 0) | (b != 0))
            below_eps += [(jax.tree_util.keystr(path), tuple(map(int, i))) for i in np.argwhere(tiny)]
        if path[-1].key == "b" and path[0].key in ("blocks", "deblocks", "pfn"):
            assert np.abs(np.asarray(jg) - g.numpy()).max() <= 1e-5 * largest
        elif deconv_parity.is_deconv(path):
            assert _rel(np.asarray(jg)[:, :, 1, 1], deconv_parity.centre_grad(g.numpy())) <= 1e-4
        else:
            assert _rel(jg, g.numpy()) <= 1e-4
    # a cancelling sum, ~1e-11 of the largest gradient in both, where the rest
    # of its row is at least 1e-2
    assert below_eps == [("['head_box']['w']", (7, 30, 0, 0))]
    for node_j, node_t in zip([j_grads[1]["pfn"], *sum(j_grads[1]["blocks"], []), *j_grads[1]["deblocks"]],
                              [t_bn["pfn"], *sum(t_bn["blocks"], []), *t_bn["deblocks"]]):
        for k in ("gamma", "beta"):
            assert _rel(node_j[k], node_t[k].grad.numpy()) <= 1e-4

    # one step each: the EMA and the Adam update
    opt = optax.adam(2e-3)
    sp_j = {k: jnp.asarray(v) for k, v in cq.items()}
    jp = jax.tree_util.tree_map(jnp.array, jp)            # train_step_bn donates its inputs
    jp2, j_bn2, _, _ = jppt.train_step_bn(jp, j_bn, opt.init((jp, j_bn)), sp_j,
                                          tuple(jnp.asarray(t) for t in targets), JCFG, opt)
    tp, (_, t_bn) = layers.trainable(tpp.params_from_jax(np_params), "cpu"), _bn_states(np_params)
    for t in tppt.bn_trainables(t_bn):
        t.requires_grad_(True)
    trainer = layers.Trainer(layers.leaves(tp) + tppt.bn_trainables(t_bn), 2e-3)
    tppt.train_step_bn(tp, t_bn, trainer, {k: torch.as_tensor(np.asarray(v)) for k, v in cq.items()},
                       tuple(torch.from_numpy(t) for t in targets), TCFG)
    for a, b in zip(jax.tree_util.tree_leaves(j_bn2), jax.tree_util.tree_leaves(t_bn)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0, atol=1e-6)
    for (path, a), b, jg in zip(jax.tree_util.tree_flatten_with_path(jp2)[0], jax.tree_util.tree_leaves(tp),
                                jax.tree_util.tree_leaves(j_grads[0])):
        # Adam's first step moves a parameter by lr * g / (|g| + eps): where g
        # is the rounding noise of an exact 0 (a conv bias before a BN) the
        # sign is either, so those move by up to lr apart; where both |g| are
        # below eps the step is lr * g / eps, 2e5 times g's rounding
        zero_grad = _pre_bn_bias(path)
        if deconv_parity.is_deconv(path):
            np.testing.assert_allclose(b.detach().numpy().mean(axis=(2, 3)).T, np.asarray(a)[:, :, 1, 1],
                                       rtol=0, atol=2.0 * 2e-3)
            continue
        d = b.detach().numpy() - np.asarray(a)
        if not zero_grad:
            for leaf, i in below_eps:
                if leaf == jax.tree_util.keystr(path):
                    assert abs(d[i]) <= 2.0 * 2e-3
                    d[i] = 0.0
        np.testing.assert_allclose(d, 0.0, rtol=0, atol=2.0 * 2e-3 if zero_grad else 1e-6)


def test_fold_bn_state_matches_jax(params):
    jp, np_params = params
    j_bn, t_bn = _bn_states(np_params)
    j_fold = jppt.fold_bn_state(jp, j_bn)
    t_fold = tppt.fold_bn_state(tpp.params_from_jax(np_params), t_bn)
    j_leaves, t_leaves = jax.tree_util.tree_flatten_with_path(j_fold)[0], jax.tree_util.tree_leaves(t_fold)
    assert len(j_leaves) == len(t_leaves)
    for (path, a), b in zip(j_leaves, t_leaves):
        if deconv_parity.is_deconv(path):
            a, b = np.asarray(a)[:, :, 1, 1], b.numpy()[:, :, 0, 0].T
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=1e-6)


def test_trainers_run_and_detector_takes_the_result():
    """Two steps of each trainer on the CPU; Detector3D takes the result."""
    params, scan, gt = tppt.overfit_scene(TCFG, steps=2, seed=1, device="cpu")
    folded, tail = tppt.fit_synthetic_bn(TCFG, steps=2, seed=1, device="cpu")
    plain, tail2 = tppt.fit_synthetic(TCFG, steps=2, seed=1, n_scenes=1, device="cpu")
    assert len(tail) == len(tail2) == 2 and np.isfinite(tail + tail2).all()
    for p in (params, folded, plain):
        boxes = tpp.Detector3D(params=p, cfg=TCFG, device="cpu").make_prediction(scan)
        assert boxes.ndim == 2 and boxes.shape[1] == 7
    assert gt.shape == (3, 7)


def test_trainers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    for fn in (tppt.overfit_scene, tppt.fit_synthetic, tppt.fit_synthetic_bn):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(TCFG, steps=1)


@pytest.mark.parametrize("fault", ["none", "far", "off", "size", "missing"])
def test_closed_loop_report_checks_as_the_closed_loop_test(fault):
    """tests/test_detector_closed_loop.py's PointPillars checks on boxes
    made from the planted ones: all pass as planted; an extra box 3 m from
    every planted box is spurious; a box 1.2 m off is not found; a width
    0.7 m off fails the sizes; a missing box is not found."""
    cfg = tppt.small_config()
    _, gt = tppt.make_box_scene(np.random.default_rng(5), cfg, n_boxes=3)
    boxes = gt.copy()
    if fault == "far":
        extra = gt[:1].copy()
        extra[0, 1] += 3.0 if extra[0, 1] < 0 else -3.0
        boxes = np.concatenate([boxes, extra])
    elif fault == "off":
        boxes[1, 0] += 1.2
    elif fault == "size":
        boxes[2, 3] += 0.7
    elif fault == "missing":
        boxes = boxes[:2]
    rep = tppt.closed_loop_report(boxes, gt, cfg)
    assert rep["ok"] == (fault == "none")
    assert rep["clean"] == (fault != "far")
    assert rep["found"] == (fault not in ("off", "missing"))
    assert rep["sizes"] == (fault != "size")


def test_cross_scene_report_counts_recovered_boxes():
    """The BN case's recall on its 4 unseen scenes: a predictor that
    returns each scene's planted boxes recovers all 12, one that returns
    nothing none."""
    cfg = tppt.small_config()
    replay = np.random.default_rng(777)
    rep = tppt.cross_scene_report(lambda scan: tppt.make_box_scene(replay, cfg, n_boxes=3)[1], cfg)
    assert rep == {"recovered": 12, "total": 12, "need": 9, "ok": True}
    rep = tppt.cross_scene_report(lambda scan: np.zeros((0, 7), np.float32), cfg)
    assert rep["recovered"] == 0 and not rep["ok"]


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_pointpillars_closed_loop_recovers_planted_boxes(seed):
    """tests/test_detector_closed_loop.py's PointPillars case with the
    port's trainer. Without regress_ignored (ROADMAP R9) seeds 1 and 3 left
    a detection 2.85 m and 2.99 m from every planted box. 640 steps where
    that file takes 320: the port's deblocks are SECONDFPN's transposed
    convolutions (ROADMAP R12), which fit one scene more slowly
    (`overfit_scene`)."""
    cfg = tppt.small_config()
    params, scan, gt = tppt.overfit_scene(cfg, steps=640, seed=seed, device="cpu")
    boxes = tpp.Detector3D(params=params, cfg=cfg, device="cpu").make_prediction(scan)
    rep = tppt.closed_loop_report(boxes, gt, cfg)
    assert rep["found"], f"{rep['detections']} detections for {len(gt)} gt, nearest {rep['dists']} m"
    assert rep["clean"], f"spurious detection: nearest planted box {rep['far']} m"
    assert rep["sizes"], (rep["w_err"], rep["l_err"])


@pytest.mark.slow
def test_pointpillars_bn_training_generalizes_cross_scene():
    """tests/test_detector_closed_loop.py's BN case with the port's
    trainer: planted boxes found on 4 unseen scenes."""
    cfg = tppt.small_config()
    params, _ = tppt.fit_synthetic_bn(cfg, steps=600, seed=0, device="cpu")
    det = tpp.Detector3D(params=params, cfg=cfg, device="cpu")
    rep = tppt.cross_scene_report(det.make_prediction, cfg)
    assert rep["ok"], f"cross-scene recall {rep['recovered']}/{rep['total']}"
