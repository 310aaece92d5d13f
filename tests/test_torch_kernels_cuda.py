"""Kernels K1 (csrc/decoder_fused.cu) and K2 (csrc/fast_score.cu) on the
card, against their plain PyTorch versions, and the online detectors
(MaskRCNN, PointPillars; plain PyTorch but for their greedy NMS kernel,
which tests/test_torch_nms_cuda.py holds to its loop) on the card against
their CPU runs, stage by stage on identical inputs. Every test here needs a CUDA device and skips without one. The
file imports neither JAX nor the JAX package, so on a machine with a card
it runs without the JAX test harness:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances (from tests/test_pallas_kernel.py): sdf within 1e-5; gradient
99th-percentile error < 1e-4 with at most max(3, N/1000) rows above 1e-4
(a point on a ReLU boundary may take the other subgradient).
K2: exact equality, on integer-valued images and on resized pyramid levels
(the kernel and the plain version do the same IEEE operations in the same
order).
"""

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.datasets.synthetic import blob_images
from dspslam_tpu_torch.frontend import orb
from dspslam_tpu_torch.kernels import decoder_fused, fast_score
from dspslam_tpu_torch.models import deepsdf
from dspslam_tpu_torch.utils import timing


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False          # f32 convolutions, as the entry points set
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
# ragged 64-row tiles: one row, one tile less / exactly / more, the GN's sizes;
# each tile on 1 or 2 CTAs of a cluster, and the default choice
@pytest.mark.parametrize("cluster", [None, *decoder_fused.WIDTHS])
@pytest.mark.parametrize("n", [1, 7, 63, 64, 65, 300, 2048, 4000, 8192])
def test_k1_kernel_matches_plain(cuda, n, cluster):
    dec = canonical(cuda)
    x = torch.from_numpy(
        (np.random.default_rng(n).normal(size=(n, 67)) * 0.3).astype(np.float32)
    ).to(cuda)
    before = timing.totals().get("k1_launches", 0)
    if cluster is None:
        sdf, grad = dec.sdf_and_input_grad(x)
    else:
        sdf, grad = decoder_fused.sdf_and_input_grad(
            list(dec.weights), list(dec.biases), x, cluster=cluster)
    torch.cuda.synchronize()
    assert timing.totals().get("k1_launches", 0) == before + 1
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
    """A decoder K1 does not compute takes the generic path on the card (no
    K1 launch), at the tolerances above against a float64 run; only an
    unknown matmul precision raises, naming it."""
    cfg = deepsdf.DecoderConfig(code_len=8, hidden=(32,) * 4, latent_in=(2,), matmul_precision="highest")
    dec = deepsdf.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    x = torch.from_numpy((np.random.default_rng(4).normal(size=(300, 11)) * 0.3).astype(np.float32)).to(cuda)
    before = timing.totals().get("k1_launches", 0)
    sdf, grad = dec.sdf_and_input_grad(x)
    sdf64, grad64 = deepsdf.sdf_and_input_grad_generic(dec.double(), x.double())
    assert timing.totals().get("k1_launches", 0) == before
    assert (sdf.double() - sdf64).abs().max().item() <= 1e-5
    err = (grad.double() - grad64).abs().amax(dim=1).cpu().numpy()
    assert np.quantile(err, 0.99) < 1e-4 and (err > 1e-4).sum() <= 3
    with pytest.raises(ValueError, match="'medium'"):
        deepsdf.DecoderConfig(matmul_precision="medium")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 376, 1241), (1, 49, 130), (2, 105, 346)])
def test_k2_kernel_matches_plain(cuda, shape):
    img = torch.from_numpy(blob_images(*shape, seed=shape[1])).to(cuda)
    before = timing.totals().get("k2_launches", 0)
    out = torch.stack(fast_score.fast_score_maps(list(img), 7.0, 20.0, 1e4))
    torch.cuda.synchronize()
    assert timing.totals().get("k2_launches", 0) == before + 1
    ref = fast_score.fast_score_map_plain(img, 7.0, 20.0, 1e4)
    assert torch.equal(out, ref)
    assert int((ref >= 1e4).sum()) > 10


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["kitti_frame", "freiburg_mono_frame", "odd_shapes"])
def test_k2_multi_map_launch_exact(cuda, which):
    """One launch for all maps: the 16 levels of a KITTI-shaped stereo frame
    or the 8 levels of a Freiburg-shaped mono / RGB-D frame (960 x 540 down
    to 151 x 268 at scale factor 1.2; integer level 0, resized levels), or
    mixed odd shapes."""
    if which == "freiburg_mono_frame":
        shapes = orb.level_shapes(orb.ORBParams(n_features=4000), 540, 960)
        base = torch.from_numpy(blob_images(1, 540, 960, seed=2)[0]).to(cuda)
        maps = [base if l == 0 else orb.resize(base, h, w).contiguous()
                for l, (h, w) in enumerate(shapes)]
        assert len(maps) == 8 and tuple(maps[-1].shape) == (151, 268)
    elif which == "kitti_frame":
        shapes = orb.level_shapes(orb.ORBParams(), 376, 1241)
        imgs = []
        for seed in (0, 1):
            base = torch.from_numpy(blob_images(1, 376, 1241, seed=seed)[0]).to(cuda)
            imgs.append([base if l == 0 else orb.resize(base, h, w).contiguous()
                         for l, (h, w) in enumerate(shapes)])
        maps = [pyr[l] for l in range(len(shapes)) for pyr in imgs]
    else:
        shapes = [(1, 1), (17, 33), (16, 32), (15, 31), (49, 130), (3, 200), (200, 3)]
        maps = [torch.from_numpy(blob_images(1, h, w, seed=i)[0]).to(cuda)
                for i, (h, w) in enumerate(shapes)]
    before = timing.totals().get("k2_launches", 0)
    outs = fast_score.fast_score_maps(maps, 7.0, 20.0, 1e4)
    torch.cuda.synchronize()
    assert timing.totals().get("k2_launches", 0) == before + 1
    refs = fast_score.fast_score_maps_plain(maps, 7.0, 20.0, 1e4)
    for out, ref in zip(outs, refs):
        assert torch.equal(out, ref), tuple(ref.shape)
    assert sum(int((r >= 1e4).sum()) for r in refs) > 10


@pytest.mark.cuda
def test_k2_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    img = torch.zeros((20, 30), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fast_score.fast_score_maps([img.t()])
    with pytest.raises(ValueError, match="float32"):
        fast_score.fast_score_maps([img.half()])
    with pytest.raises(ValueError, match="one CUDA device"):
        fast_score.fast_score_maps([img, img.cpu()])


@pytest.mark.cuda
def test_detector2d_stages_on_the_card(cuda):
    """MaskRCNN at a small width: the f32 backbone within 1e-4 of the CPU's
    (largest value), the RPN's top-k and NMS fed the CPU's level outputs
    pick the CPU's proposals (within 1e-3 px: exp may differ in its last
    bit), the heads fed the CPU's proposals within 1e-4, the box NMS fed the
    CPU's boxes and scores equal, and one dispatch free of host syncs."""
    from dspslam_tpu_torch.detect import maskrcnn as mr

    cfg = mr.MaskRCNNConfig(num_classes=4, stage_blocks=(1, 1, 1, 1), fpn_channels=32, fc_dim=64,
                            rpn_pre_nms=64, rpn_post_nms=16, max_detections=5, backbone_dtype="float32")
    params = mr.init_params(cfg)
    on_card = mr.tree_map(lambda t: t.to(cuda), params)
    img = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (96, 128, 3)).astype(np.float32))
    hw = (96, 128)
    feats = mr.resnet_fpn(params, mr.normalize_image(img), cfg)
    feats_c = mr.resnet_fpn(on_card, mr.normalize_image(img.to(cuda)), cfg)
    for a, b in zip(feats, feats_c):
        assert (b.cpu() - a).abs().max().item() <= 1e-4 * a.abs().max().item()
    levels = mr.rpn_heads(params, feats)
    props, valid = mr.rpn_select(levels, [f.shape[-2:] for f in feats], hw, cfg)
    props_c, valid_c = mr.rpn_select([(s.to(cuda), d.to(cuda)) for s, d in levels],
                                     [f.shape[-2:] for f in feats], hw, cfg)
    assert torch.equal(valid_c.cpu(), valid) and (props_c.cpu() - props).abs().max().item() <= 1e-3
    head = mr.box_head(params, feats, props, valid, hw, cfg)
    head_c = mr.box_head(on_card, [f.to(cuda) for f in feats], props.to(cuda), valid.to(cuda), hw, cfg)
    for a, b in zip(head[:2] + head[3:], head_c[:2] + head_c[3:]):
        assert (b.cpu() - a).abs().max().item() <= 1e-4 * max(a.abs().max().item(), 1.0)
    sel = mr.select_boxes(head[0], head[1], head[2], cfg)
    sel_c = mr.select_boxes(head[0].to(cuda), head[1].to(cuda), head[2].to(cuda), cfg)
    for a, b in zip(sel, sel_c):
        assert torch.equal(b.cpu(), a)
    det = mr.Detector2D(params=params, cfg=cfg, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = det.dispatch(img.numpy())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert det.collect(handle)["pred_boxes"].shape[1] == 5


@pytest.mark.cuda
def test_detector3d_stages_on_the_card(cuda):
    """PointPillars at a small width: the device pillar build on the card
    equals the CPU's (coords, masks exactly, features within 1e-5: float
    atomics), select_detections fed the CPU's outputs picks the CPU's boxes,
    and one dispatch free of host syncs."""
    from dspslam_tpu_torch.apps.benchmark_detectors import synthetic_scan
    from dspslam_tpu_torch.detect import pointpillars as pp

    cfg = pp.PointPillarsConfig(
        pc_range=(0.0, -10.24, -3.0, 20.48, 10.24, 1.0), voxel_size=(0.32, 0.32, 4.0),
        max_pillars=1024, max_points_per_pillar=16, pfn_channels=32, backbone_layers=(2, 2, 2),
        backbone_channels=(32, 64, 128), fpn_channels=(32, 32, 32), nms_pre=64, max_detections=10)
    scan = synthetic_scan(n=20_000, seed=2)
    cpu = pp.Detector3D(cfg=cfg, device="cpu")
    card = pp.Detector3D(cfg=cfg, device=cuda)
    pil = pp.build_pillars_from_points(cpu.upload(scan), cfg)
    pil_c = pp.build_pillars_from_points(card.upload(scan), cfg)
    for k in ("coords", "mask", "pillar_mask"):
        assert torch.equal(pil_c[k].cpu(), pil[k]), k
    assert (pil_c["features"].cpu() - pil["features"]).abs().max().item() <= 1e-5
    cls, deltas, dirs = pp.forward(cpu.params, pil, cfg)
    boxes = pp.decode_boxes(deltas, cpu.anchors)
    out = pp.select_detections(cls, boxes, dirs, cfg)
    out_c = pp.select_detections(cls.to(cuda), boxes.to(cuda), dirs.to(cuda), cfg)
    assert torch.equal(out_c[2].cpu(), out[2])
    assert (out_c[0].cpu() - out[0]).abs().max().item() <= 1e-4
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = card.dispatch(scan)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert card.collect(handle).shape[1] == 7
