"""The port's PointPillars (dspslam_tpu_torch/detect/pointpillars.py) against
dspslam_tpu/detect/pointpillars.py on the CPU, at tests/test_pointpillars.py's
small config, with numpy-seeded scans and weights carried across through
`params_from_jax`.

Tolerances:
- the host pillarization (pillarize, pillarize_sparse, crop_quantize_points,
  numpy copies): equal;
- the device pillar builds: coords, masks and pillar_mask equal, features
  within 1e-5 (centroid sums in another order). Points within 1% of a voxel
  edge are dropped first: XLA on the CPU fuses `q * 0.002 - x0` into one
  FMA and divides by the voxel as a product with its reciprocal, where the
  port does the f32 operations as written, so a point on an edge can fall
  into the neighbouring pillar (tests/test_pointpillars.py defines its
  exact parity away from edges too);
- over the pillar cap with count ties: the same pillars in the same slots
  (the lower pillar key first among equal counts, lax.top_k's order);
- forward: the bf16 backbone's outputs within 2e-2 of the largest value;
  decode_boxes within 1e-5 relative; select_detections on planted ties:
  equal;
- the checkpoint loader: equal arrays.

SECONDFPN's deblocks are transposed convolutions (kernel = stride) in the
port and a resize + convolution in JAX (R12): their kernels repeat one
phase (tests/deconv_parity.py), where the two agree, and
tests/test_torch_detect_reference.py holds the general layer to the plain
reference.
"""

import dataclasses

import deconv_parity
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.detect import pointpillars as jpp
from dspslam_tpu_torch.detect import layers
from dspslam_tpu_torch.detect import pointpillars as tpp
from torch_threads import one_torch_thread  # noqa: F401

JCFG = jpp.PointPillarsConfig(
    pc_range=(0.0, -10.24, -3.0, 20.48, 10.24, 1.0), voxel_size=(0.32, 0.32, 4.0),
    max_pillars=1024, max_points_per_pillar=16, pfn_channels=32, backbone_layers=(2, 2, 2),
    backbone_channels=(32, 64, 128), fpn_channels=(32, 32, 32), nms_pre=64, max_detections=10,
)
TCFG = tpp.PointPillarsConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})


def car_scan(seed=17, centers=((8.0, 2.0), (14.0, -4.0)), n_bg=2000):
    """Car-sized point blobs over a ground plane (test_pointpillars.py's)."""
    rng = np.random.default_rng(seed)
    pts = [np.concatenate([rng.normal([cx, cy, -1.5], [1.0, 0.4, 0.3], (300, 3)), np.ones((300, 1))], -1)
           for cx, cy in centers]
    ground = np.stack([rng.uniform(0, 20, n_bg), rng.uniform(-10, 10, n_bg), np.full(n_bg, -2.0),
                       np.ones(n_bg)], -1)
    return np.concatenate(pts + [ground]).astype(np.float32)


def off_edges(scan, cfg=JCFG, margin=0.01):
    fx = (scan[:, 0] - cfg.pc_range[0]) / cfg.voxel_size[0] % 1.0
    fy = (scan[:, 1] - cfg.pc_range[1]) / cfg.voxel_size[1] % 1.0
    return scan[(fx > margin) & (fx < 1 - margin) & (fy > margin) & (fy < 1 - margin)]


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def _assert_pillars(t, j):
    for k in ("coords", "mask", "pillar_mask"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    np.testing.assert_allclose(t["features"].numpy(), np.asarray(j["features"]), atol=1e-5)


@pytest.fixture(scope="module")
def params():
    np_params = layers.tree_map(lambda t: t.numpy(), tpp.init_params(TCFG, torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(4)
    np_params = layers.tree_map(lambda a: a + (rng.normal(size=a.shape) * 0.05).astype(np.float32)
                                if a.ndim == 1 else a, np_params)
    port, jax_np = deconv_parity.split(np_params)
    return jax.tree_util.tree_map(jnp.asarray, jax_np), tpp.params_from_jax(port)


def test_host_pillarization_equals_jax():
    scan = car_scan()
    for fn in ("pillarize", "pillarize_sparse", "crop_quantize_points"):
        a, b = getattr(jpp, fn)(scan, JCFG), getattr(tpp, fn)(scan, TCFG)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{fn}.{k}")
    sp = tpp.pillarize_sparse(scan, TCFG, point_cap=64)
    assert sp["pts_q"].shape == (64, 4) and int(sp["n_pts"]) == 64


def test_build_from_points_and_device_match_jax():
    scan = off_edges(car_scan())
    cq = jpp.crop_quantize_points(scan, JCFG)
    _assert_pillars(tpp.build_pillars_from_points(_t(cq), TCFG), jpp.build_pillars_from_points(_j(cq), JCFG))
    sp = jpp.pillarize_sparse(scan, JCFG)
    _assert_pillars(tpp.build_pillars_device(_t(sp), TCFG), jpp.build_pillars_device(_j(sp), JCFG))


def test_build_over_the_cap_with_count_ties():
    # 40 pillars with counts 1..5 (eight of each): a cap of 12 keeps the
    # eight 5-point pillars and four of the 4-point ones, chosen by key
    cfg_j = dataclasses.replace(JCFG, max_pillars=12, max_points_per_pillar=4)
    cfg_t = dataclasses.replace(TCFG, max_pillars=12, max_points_per_pillar=4)
    rng = np.random.default_rng(5)
    pts = []
    for i in rng.permutation(40):
        cx, cy = 0.16 + 0.32 * (i % 20), -10.08 + 0.32 * (3 * (i // 20))
        n = 1 + i % 5
        xyz = np.stack([np.full(n, cx), np.full(n, cy), np.full(n, -1.0)], -1) + rng.uniform(-0.05, 0.05, (n, 3))
        pts.append(np.concatenate([xyz, np.ones((n, 1))], -1))
    scan = np.concatenate(pts).astype(np.float32)
    cq = jpp.crop_quantize_points(scan, cfg_j)
    t = tpp.build_pillars_from_points(_t(cq), cfg_t)
    j = jpp.build_pillars_from_points(_j(cq), cfg_j)
    _assert_pillars(t, j)
    assert int(t["pillar_mask"].sum()) == 12 and int(t["mask"].sum()) == 8 * 4 + 4 * 4


def test_forward_decode_match_jax(params):
    jp, tp = params
    cq = jpp.crop_quantize_points(off_edges(car_scan()), JCFG)
    jo = jpp.forward(jp, jpp.build_pillars_from_points(_j(cq), JCFG), JCFG)
    to = tpp.forward(tp, tpp.build_pillars_from_points(_t(cq), TCFG), TCFG)
    nx, ny = TCFG.grid_size
    assert to[0].shape == ((nx // 2) * (ny // 2) * 2,) and to[1].shape[1] == 7 and to[2].shape[1] == 2
    for a, b in zip(jo, to):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 2e-2 * np.abs(a).max()
    anchors = tpp._anchors(TCFG, (ny // 2, nx // 2))
    np.testing.assert_array_equal(anchors, jpp._anchors(JCFG, (ny // 2, nx // 2)))
    deltas = np.asarray(jo[1])
    jb = np.asarray(jpp.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors)))
    tb = tpp.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-5)


def test_live_pillar_at_cell_00_survives_the_canvas_scatter(params):
    """The JAX canvas `.at[:, y, x].set` lets every empty pillar write 0 at
    cell (0, 0) and so erases a live pillar there on the CPU (ROADMAP.md
    section 3, R7); the port accumulates onto zeros and keeps it."""
    jp, tp = params
    P, M = TCFG.max_pillars, TCFG.max_points_per_pillar
    feats = np.zeros((P, M, 10), np.float32)
    feats[0, :3] = np.random.default_rng(6).normal(size=(3, 10))
    mask = np.zeros((P, M), np.float32)
    mask[0, :3] = 1.0
    live = {"features": feats, "mask": mask, "coords": np.zeros((P, 2), np.int32),
            "pillar_mask": np.eye(1, P, dtype=np.float32)[0]}
    empty = dict(live, mask=np.zeros_like(mask), pillar_mask=np.zeros(P, np.float32))
    j_live, j_empty = (np.asarray(jpp.forward(jp, _j(d), JCFG)[0]) for d in (live, empty))
    t_live, t_empty = (tpp.forward(tp, _t(d), TCFG)[0].numpy() for d in (live, empty))
    np.testing.assert_array_equal(j_live, j_empty)          # the fault
    assert not np.array_equal(t_live, t_empty)
    np.testing.assert_allclose(t_empty, j_empty, atol=2e-2 * np.abs(j_empty).max())


def test_select_detections_planted_ties():
    A = 64
    rng = np.random.default_rng(7)
    boxes = np.zeros((A, 7), np.float32)
    boxes[:, :2] = rng.uniform(0, 20, (A, 2))
    boxes[:, 3:6] = (1.6, 3.9, 1.56)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, A)
    boxes[8:16, :2] = boxes[:8, :2] + 0.3                     # overlapping pairs
    cls = np.round(rng.normal(0, 3, A)).astype(np.float32)    # integer logits: ties
    cls[[1, 5, 9, 30, 40]] = 25.0                              # saturated: sigmoid exactly 1
    dirs = rng.normal(size=(A, 2)).astype(np.float32)
    for cfg_j in (dataclasses.replace(JCFG, nms_pre=A, max_detections=20),
                  dataclasses.replace(JCFG, nms_pre=32, max_detections=40)):
        cfg_t = tpp.PointPillarsConfig(**{f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
        j = jpp.select_detections(jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(dirs), cfg_j)
        t = tpp.select_detections(torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(dirs), cfg_t)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert int(t[2].sum()) >= 2


def _by_cell(pillars, cfg):
    live = pillars["pillar_mask"].numpy() > 0
    c = pillars["coords"].numpy()[live]
    key = c[:, 1] * cfg.grid_size[0] + c[:, 0]
    order = np.argsort(key)
    return key[order], pillars["mask"].numpy()[live][order], pillars["features"].numpy()[live][order]


def test_detector3d_paths_agree_under_the_cap(params):
    _, tp = params
    scan = off_edges(car_scan())
    cfg = dataclasses.replace(TCFG, max_pillars=4096)      # every occupied pillar kept
    dev = tpp.Detector3D(params=tp, cfg=cfg, device="cpu")
    host = tpp.Detector3D(params=tp, cfg=cfg, device_assign=False, device="cpu")
    pd = tpp.build_pillars_from_points(dev.upload(scan), cfg)
    ph = tpp.build_pillars_device(host.upload(scan), cfg)
    assert float(ph["pillar_mask"].sum()) < cfg.max_pillars
    # slot order differs (the host ranks count ties with an unstable sort),
    # the network sees the pillars by cell: compare them in cell order
    (kd, md, fd), (kh, mh, fh) = (_by_cell(p, cfg) for p in (pd, ph))
    np.testing.assert_array_equal(kd, kh)
    np.testing.assert_array_equal(md, mh)
    np.testing.assert_allclose(fd, fh, atol=1e-5)
    a, b = dev.make_prediction(scan), host.make_prediction(scan)
    assert a.ndim == 2 and a.shape[1] == 7 and a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-4)
    assert dev.dispatches == host.dispatches == 1


def _mmdet3d_state_dict(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def bn(key, c):
        sd[key + ".weight"] = torch.randn(c, generator=g)
        sd[key + ".bias"] = torch.randn(c, generator=g)
        sd[key + ".running_mean"] = torch.randn(c, generator=g)
        sd[key + ".running_var"] = torch.rand(c, generator=g) + 0.5

    sd["voxel_encoder.pfn_layers.0.linear.weight"] = torch.randn(cfg.pfn_channels, 10, generator=g)
    bn("voxel_encoder.pfn_layers.0.norm", cfg.pfn_channels)
    cin = cfg.pfn_channels
    for bi, (n, cout) in enumerate(zip(cfg.backbone_layers, cfg.backbone_channels)):
        for li in range(n + 1):
            sd[f"backbone.blocks.{bi}.{li * 3}.weight"] = torch.randn(cout, cin if li == 0 else cout, 3, 3,
                                                                      generator=g)
            bn(f"backbone.blocks.{bi}.{li * 3 + 1}", cout)
        cin = cout
    for di, (ci, co, k) in enumerate(zip(cfg.backbone_channels, cfg.fpn_channels, cfg.fpn_upsample)):
        sd[f"neck.deblocks.{di}.0.weight"] = torch.randn(ci, co, k, k, generator=g)    # ConvTranspose2d
        bn(f"neck.deblocks.{di}.1", co)
    feat = sum(cfg.fpn_channels)
    for key, cout in (("conv_cls", 2), ("conv_reg", 14), ("conv_dir_cls", 4)):
        sd[f"bbox_head.{key}.weight"] = torch.randn(cout, feat, 1, 1, generator=g)
        sd[f"bbox_head.{key}.bias"] = torch.randn(cout, generator=g)
    return sd


def test_checkpoint_loader_matches_jax(tmp_path):
    """Every leaf as JAX's loader gives it, but the deblocks' kernels: the
    port takes mmdet3d's (in, out, k, k) ConvTranspose2d kernel as it is,
    its BatchNorm folded along the output axis (JAX reshapes it for its
    resize + conv substitute, R12)."""
    path = tmp_path / "pp.pth"
    sd = _mmdet3d_state_dict(JCFG)
    torch.save({"state_dict": sd}, path)
    jl = jax.tree_util.tree_flatten_with_path(jpp.load_mmdet3d_checkpoint(str(path), JCFG))[0]
    tl = jax.tree_util.tree_leaves(layers.tree_map(lambda t: t.numpy(), tpp.load_mmdet3d_checkpoint(str(path), TCFG)))
    assert len(tl) == len(jl)
    for (path_j, a), b in zip(jl, tl):
        if deconv_parity.is_deconv(path_j):
            di = path_j[1].idx
            bn = {k: sd[f"neck.deblocks.{di}.1.{k}"].numpy() for k in ("weight", "running_var")}
            scale = bn["weight"] / np.sqrt(bn["running_var"] + 1e-3)
            want = sd[f"neck.deblocks.{di}.0.weight"].numpy() * scale[None, :, None, None]
            np.testing.assert_allclose(b, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, np.asarray(a))
    # the loaded detector runs, the deblocks as transposed convs of kernel 1, 2, 4
    det = tpp.Detector3D(params=tpp.load_mmdet3d_checkpoint(str(path), TCFG), cfg=TCFG, device="cpu")
    assert det.make_prediction(car_scan()).shape[1] == 7


def test_detector_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tpp.Detector3D(cfg=TCFG)
