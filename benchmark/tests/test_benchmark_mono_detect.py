"""The mono detect cell on the CPU: its tiny run prints the contract's line
and is correct with the detector and the mono stages checked; each planted
mono fault fails its own number and each control fails some number; a port
without the online mono path fails at once; the orbit's geometry; the new
metrics' readers on a hand-made run."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark import detflops, manifest, orbit
from benchmark.tests import tiny
from benchmark.tests.test_benchmark_span_metrics import fake_run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MONO_NUMBERS = ("mono_det_miss", "mono_seed_gap", "mono_pick_miss", "mesh_grid_gap")
READERS = ("mono_detect_ms", "mono_gn_ms", "mono_mesh_ms", "mono_det2d_mfu")

# the Freiburg camera at a quarter of its size, a small decoder, GN and
# Mask R-CNN (a 135 x 240 frame resized to 136 x 242 and padded to
# 160 x 256), a 10 x 10 px erosion cut to 3, reconstruction rounds from the
# 4th keyframe and every 2nd after it, every mono call sampled
OVERRIDES = {
    "config": {"orb": {"n_features": 800, "n_levels": 4}, "tracker": {"min_init_features": 100},
               "decoder": tiny.SMALL_DECODER,
               "optimizer": {"num_iterations": 2, "max_grad_points": 64, "num_depth_samples": 8},
               "detection": {"max_surface_points": 64, "max_rays": 64, "mask_erosion": 3, "min_mask_area": 100.0,
                             "downsample_ratio": 2.0,
                             "detector_2d": {"num_classes": 4, "stage_blocks": [1, 1, 1, 1], "stem_channels": 16,
                                             "fpn_channels": 32, "fc_dim": 64, "rpn_pre_nms": 64,
                                             "rpn_post_nms": 64, "max_detections": 10, "test_scale": [240, 136]}},
               "voxels_dim": 16},
    "mix": {"frames_per_drive": 60, "warmup_frames": 10, "decoder_fit_steps": 5, "world": {"texture_seeds": [0]},
            "objects": {"block": 0.1}, "pipeline": {"warmup_kfs": 4, "recon_every": 2},
            "check": {"ba_spacing": 1, "gn_spacing": 1, "pose_spacing": 3, "min_frames_for_ate": 5, "det_spacing": 2,
                      "mono_det_spacing": 1, "mesh_spacing": 1}},
}


def tiny_mono(trace: int = 0, variant: str | None = None, seed: int = 3_000_000_017, preload: str = ""):
    code = (f"{preload}\n"
            "import sys\n"
            "from benchmark import manifest, run\n"
            "from benchmark.tests import tiny\n"
            "from benchmark.tests.test_benchmark_mono_detect import OVERRIDES\n"
            "bench = manifest.load('.')\n"
            "cfg = manifest.config(bench, 'freiburg_001_online', '.')\n"
            "ov = {'config': dict(OVERRIDES['config'], camera=tiny.camera(cfg['camera'], 4)), 'mix': OVERRIDES['mix']}\n"
            f"sys.exit(run.main(['--workload', 'freiburg_detect', '--seed', '{seed}', '--seconds', '20', '--trace',"
            f" '{trace}', '--device', 'cpu'], ov, variant={variant!r}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)


def line_of(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", (0, 1))
def test_tiny_run_is_correct_with_the_mono_stages_checked(trace):
    proc = tiny_mono(trace)
    line = line_of(proc)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0, line["checks"]
    bench = manifest.load(ROOT)
    if trace == 0:
        assert set(line["metrics"]) == {m["name"] for m in manifest.end_to_end(bench, "freiburg_detect")}
    else:       # the CPU has no device trace and no peak: the span metrics alone
        assert set(line["metrics"]) == {"track_ms", "track_orb_ms", "track_search_ms", "track_pose_ms",
                                        "track_host_ms", "keyframe_drain_ms", "ba_dispatch_ms", "ba_pack_ms",
                                        "ba_lm_step_ms", "gn_iter_ms", "det2d_enqueue_ms", "mono_detect_ms",
                                        "mono_gn_ms", "mono_mesh_ms"}
    assert set(MONO_NUMBERS) | {"det2d_feat_gap", "det2d_select_miss", "gn_k1_gap", "gn_step_rel_median",
                                "gn_out_rel_gap"} <= set(line["checks"])
    detail = json.loads(proc.stdout.strip().splitlines()[-2])
    counts = detail["setup_breakdown"]["window_counts"]
    assert counts["detect_mono_calls"] > 0 and counts["mono_dets"] > 0 and counts["mono_gn_calls"] > 0
    assert counts["mono_gn_rows"] > counts["mono_gn_calls"]         # a first reconstruction's B = 2
    assert counts["mono_meshes"] > 0 and counts["mono_objects_born"] > 0
    # rounds enqueued: 64 RPN + 10 R-CNN per keyframe (the CPU runs the loop, no kernel)
    assert counts["det2d_nms_rounds"] == (64 + 10) * counts["detect_mono_calls"] and counts["nms_launches"] == 0
    assert "dspslam_tpu" not in proc.stderr.replace("dspslam_tpu_torch", "")


# the tiny GN runs 2 iterations, so a call's median step takes in its last,
# which gn.altered moves
@pytest.mark.parametrize("fault,numbers", [("mono.det", {"mono_det_miss"}), ("mono.seed", {"mono_seed_gap"}),
                                           ("mono.pick", {"mono_pick_miss"}), ("mono.mesh", {"mesh_grid_gap"}),
                                           ("gn.altered", {"gn_out_rel_gap", "gn_step_rel_median"})])
def test_a_planted_mono_fault_fails_its_number(fault, numbers):
    line = line_of(tiny_mono(variant=fault))
    assert line["correct"] is False
    failed = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert failed == numbers, line["checks"]


@pytest.mark.parametrize("variant,numbers", [("tf32", {"track_pose_gap", "ba_cam_gap", "mono_seed_gap"}),
                                             ("det_lowp", {"det2d_feat_gap", "det2d_head_gap"})])
def test_each_control_fails_its_numbers(variant, numbers):
    """On the CPU TF32 changes nothing in the decoder (the card's control
    also fails gn_k1_gap, gn_grid_gap and mesh_grid_gap): the references
    computed a precision lower fail the rest."""
    line = line_of(tiny_mono(variant=variant))
    failed = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert line["correct"] is False and numbers <= failed, line["checks"]


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_a_round_objects_seed_reads_no_gap_and_its_control_fails(seed):
    """The cell's parked object is round: its member points' principal
    extents are nearly equal, so rounding moves the PCA's axes far. The
    port and the reference, both in the points' float32, agree exactly;
    the PCA from the points rounded to TF32 reads over the limit."""
    from benchmark.loops import mono_detect
    from benchmark.reference import mono as ref_mono
    from benchmark.reference.precision import tf32
    from dspslam_tpu_torch.objects import cuboid

    limit = json.load(open(os.path.join(ROOT, "benchmark", "limits", "freiburg_detect.json")))["mono_seed_gap"]
    rng = np.random.default_rng(seed)
    az = rng.uniform(-2.2, -0.4, 300)
    el = rng.uniform(-0.6, 0.9, 300)
    d = np.stack([np.cos(el) * np.cos(az), -np.sin(el), np.cos(el) * np.sin(az)], -1)
    pts = ([0.0, 0.15, 5.0] + 1.5 * d + rng.normal(0.0, 0.02, (300, 3))).astype(np.float32)
    ref = ref_mono.cuboid_pca(pts)
    val = np.linalg.eigvalsh(np.cov(pts[ref["inliers"]].T))
    assert val[2] - val[1] < 0.3 * val[2]      # two nearly equal extents
    assert mono_detect.pca_gap((pts,), cuboid.compute_cuboid_pca(pts), None, {}) == 0.0
    control = ref_mono.cuboid_pca(pts, operand=tf32)
    assert mono_detect.pca_gap((pts,), {"T_wo_sim3": control["T_wo_sim3"]}, None, {}) > limit


@pytest.mark.parametrize("gap,fails", [(1e-9, False), (0.5, True)])
def test_the_box_of_a_class_tie_is_taken_either_way(gap, fails):
    """Two classes whose probabilities differ by `gap` and whose boxes
    differ: a head that takes the second class passes on a tie (within
    CLASS_BAND) and fails where the first is clearly the best."""
    import torch

    from benchmark import detcheck
    from benchmark.loops import mono_detect
    from benchmark.reference import maskrcnn as ref2d

    g = torch.Generator().manual_seed(0)
    C, D, K, N = 4, 16, 3, 5
    h = "roi_head.bbox_head."
    sd = {h + "shared_fcs.0.weight": torch.randn(D, C * 49, generator=g) * 0.1, h + "shared_fcs.0.bias": torch.zeros(D),
          h + "shared_fcs.1.weight": torch.randn(D, D, generator=g) * 0.3, h + "shared_fcs.1.bias": torch.zeros(D),
          h + "fc_cls.weight": torch.zeros(K + 1, D), h + "fc_cls.bias": torch.tensor([gap, 0.0, -5.0, -5.0]),
          h + "fc_reg.weight": torch.randn(4 * K, D, generator=g), h + "fc_reg.bias": torch.zeros(4 * K)}
    feats = [torch.randn(1, C, 64 // s, 64 // s, generator=g) for s in (4, 8, 16, 32)]
    props = torch.tensor([[4.0, 4.0, 20.0, 24.0], [10.0, 8.0, 40.0, 30.0], [0.0, 0.0, 60.0, 60.0],
                          [30.0, 30.0, 50.0, 44.0], [5.0, 35.0, 25.0, 60.0]])
    valid, hw = torch.ones(N), (64, 64)
    r_boxes, _, r_classes, r_probs = ref2d.box_head(sd, feats, props, valid, hw)
    assert (r_classes == 0).all()
    # the head under test takes the second class, with the reference's own arithmetic for its box
    x = ref2d.roi_align(feats, props, 7).flatten(1)
    for i in range(2):
        x = torch.relu(ref2d._fc(x, sd, f"{h}shared_fcs.{i}", ref2d.F32))
    d = ref2d._fc(x, sd, h + "fc_reg", ref2d.F32).reshape(N, K, 4)[:, 1] * torch.tensor(ref2d.TARGET_STDS)
    boxes = ref2d.clip(ref2d.decode(d, props), hw)
    rec = {"resnet_fpn": [(None, feats)],
           "box_head": [((None, None, props, valid, hw, None), (boxes, r_probs.amax(-1), torch.ones(N, dtype=torch.int64),
                                                                r_probs))]}
    assert detcheck.rel(boxes, r_boxes) > 1e-3        # the two classes' boxes differ
    limit = json.load(open(os.path.join(ROOT, "benchmark", "limits", "freiburg_detect.json")))["det2d_head_gap"]
    assert (mono_detect.box_gap(rec, sd) > limit) == fails


def test_a_port_without_the_online_mono_path_fails_at_once():
    preload = "import dspslam_tpu_torch.datasets.mono as m; del m.detect_online_mono"
    proc = tiny_mono(preload=preload)
    assert proc.returncode != 0 and proc.stdout == "" and "detect_online_mono" in proc.stderr


def test_the_orbit_circles_the_object_looking_at_it():
    mix = json.load(open(os.path.join(ROOT, "benchmark", "traffic", "freiburg_drive_detect.json")))
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", "freiburg_001_online.json")))
    tr = mix["trajectory"]
    traj = orbit.orbit_trajectory(tr, mix["frames_per_drive"] + 1)
    c = np.asarray(tr["center"])
    to_c = c[None] - traj[:, :3, 3]
    assert np.allclose(np.linalg.norm(to_c[:, [0, 2]], axis=1), 7.0)
    assert np.allclose(traj[:, 1, 3], 0.0)       # the camera keeps its height, 0.15 m above the centre
    view = traj[:, :3, 2]
    assert np.allclose(view[:, [0, 2]], to_c[:, [0, 2]] / 7.0)
    yaw = np.degrees(np.arctan2(view[:, 0], view[:, 2]))
    assert np.allclose(np.diff(yaw), 0.75) and np.isclose(yaw[-1] - yaw[0], 112.5)
    drive = orbit.OrbitDrive(tiny.camera(cfg["camera"], 8), dict(mix, frames_per_drive=4), 0)
    drive.render()
    for k in range(5):
        boxes, masks = drive.instances(k)
        assert len(masks) >= 1 and masks[0].sum() == (drive.labels[k] == 1).sum()
        assert masks[0].sum() == max(m.sum() for m in masks)      # the circled object is the largest
        for b, m in zip(boxes, masks):
            ys, xs = np.nonzero(m)
            assert list(b) == [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    far = [np.linalg.norm(c + np.asarray(p) - traj[mix["frames_per_drive"] // 2, :3, 3])
           for p in mix["objects"]["parked"]]
    assert all(12.0 <= d <= 16.0 for d in far)


def test_mono_readers_on_a_hand_made_run():
    spans = {"detect_mono": [(1.0, 1.05), (3.0, 3.08), (5.0, 5.04)], "mono_gn": [(1.1, 1.2), (5.1, 5.16)],
             "mono_mesh": [(1.2, 1.23), (5.2, 5.22)]}
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", "freiburg_001_online.json")))
    per = detflops.maskrcnn_flops(cfg["detection"]["detector_2d"], (540, 960))
    assert detflops.maskrcnn_input(cfg["detection"]["detector_2d"], (540, 960)) == (768, 1344)
    assert 515e9 < per < 530e9
    # the whole window untraced, then a trace that stopped at 2 s: the spans begun before it are left out
    for t1, det, gn, mesh in ((None, [0.05, 0.08, 0.04], [0.1, 0.06], [0.03, 0.02]),
                              (2.0, [0.08, 0.04], [0.06], [0.02])):
        run = fake_run(spans, t1)
        run.device, run.config = types.SimpleNamespace(type="cuda"), cfg
        assert manifest.reader("mono_detect_ms")(run) == pytest.approx(1e3 * np.mean(det))
        assert manifest.reader("mono_gn_ms")(run) == pytest.approx(1e3 * np.mean(gn))
        assert manifest.reader("mono_mesh_ms")(run) == pytest.approx(1e3 * np.mean(mesh))
        assert manifest.reader("mono_det2d_mfu")(run) == pytest.approx(100 * per * len(det) / sum(det) / 989e12)
    run = fake_run(spans)
    run.device, run.config = types.SimpleNamespace(type="cpu"), cfg
    assert manifest.reader("mono_det2d_mfu")(run) is None
    # a program without the spans (the parent of this cell): nothing to read
    run = fake_run({})
    run.device, run.config = types.SimpleNamespace(type="cuda"), cfg
    assert all(manifest.reader(m)(run) is None for m in READERS)
