"""The stereo+LiDAR CLI end to end: dspslam_tpu.apps.dsp_slam.main and the
PyTorch port's (`--device cpu`) over the checked-in mini-KITTI fixture
(tests/fixtures/mini_kitti: 3 PNG stereo pairs at 160 x 512, velodyne .bin
scans, .lbl labels of one sphere, calib.txt, times.txt).

Checked: the three map files parse (System_util.cc:109-149 formats);
Cameras.txt within 1e-3 of the JAX run's (f32 pose GN summed in another
order); the same map-point count; the object's Sim(3) row within 1e-3 and
its code within 1e-3 of JAX's; the object ~10 m ahead of the first camera.
With `--vocabulary` (a K=6, L=2 vocabulary trained on the fixture's first
frame) and `--save_state`: loop closing is attached, the checkpoint holds
the saved map, and `extract_map_objects --device cpu` re-decodes its
MapObjects.txt to the same vertex and face counts as the JAX tool, with
vertices within 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_kitti")


def _config(tmp):
    with open(os.path.join(FIXTURE, "config.template.json")) as f:
        cfg = f.read().replace("{SEQ}", FIXTURE)
    path = tmp / "config.json"
    path.write_text(cfg)
    return str(path)


def parse_map_objects(path):
    lines = [ln for ln in open(path).read().split("\n") if ln.strip()]
    out = []
    for i in range(0, len(lines), 3):
        Two = np.eye(4)
        Two[:3] = np.array(lines[i + 1].split(), float).reshape(3, 4)
        out.append((int(lines[i]), Two, np.array(lines[i + 2].split(), float)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dspslam_tpu.apps import dsp_slam as jdsp
    from dspslam_tpu_torch.apps import dsp_slam as tdsp

    tmp = tmp_path_factory.mktemp("mini_kitti_both")
    cfg = _config(tmp)
    common = ["--sequence_dir", FIXTURE, "--config", cfg, "--no_loop"]
    js = jdsp.main(common + ["--map_dir", str(tmp / "jax")])
    ts = tdsp.main(common + ["--map_dir", str(tmp / "torch"), "--device", "cpu"])
    return js, ts, str(tmp / "jax"), str(tmp / "torch")


def test_sequence_layout_loads():
    from dspslam_tpu_torch.config import DetectionConfig
    from dspslam_tpu_torch.datasets.kitti import KITTISequence

    with open(os.path.join(FIXTURE, "config.template.json")) as f:
        det = json.load(f)["detection"]
    det = {k: (v.replace("{SEQ}", FIXTURE) if isinstance(v, str) else v) for k, v in det.items()}
    seq = KITTISequence(FIXTURE, DetectionConfig(**det))
    assert seq.num_frames == 3 and seq.timestamp(1) == pytest.approx(0.1)
    l, r = seq.load_stereo_gray(0)
    assert l.shape == (160, 512) and r.shape == (160, 512)
    assert seq.K[0, 0] == pytest.approx(400.0)
    dets = seq.get_frame_detections(0, (160, 512))
    assert len(dets) == 1 and dets[0].mask is not None and len(dets[0].surface_points) >= 50
    assert np.all(np.abs(dets[0].surface_points - np.array([2.5, 0.45, 10.0])) < 1.3)
    # detect_online builds both online detectors (full-width, seeded
    # weights) on the sequence's device; tests/test_torch_detectors_online.py
    # runs them
    from dspslam_tpu_torch.detect import maskrcnn, pointpillars

    online = KITTISequence(FIXTURE, DetectionConfig(**{**det, "detect_online": True}), device="cpu")
    assert isinstance(online.detector_2d, maskrcnn.Detector2D)
    assert isinstance(online.detector_3d, pointpillars.Detector3D)
    assert online.detector_2d.cfg == maskrcnn.MaskRCNNConfig()
    assert online.detector_3d.cfg == pointpillars.PointPillarsConfig()


def test_cli_matches_jax(runs):
    js, ts, jdir, tdir = runs
    assert ts.state.name == js.state.name == "OK"
    jc = np.loadtxt(os.path.join(jdir, "Cameras.txt")).reshape(-1, 3, 4)
    tc = np.loadtxt(os.path.join(tdir, "Cameras.txt")).reshape(-1, 3, 4)
    assert tc.shape == jc.shape == (3, 3, 4)
    assert np.abs(tc - jc).max() <= 1e-3
    assert tc[-1, 0, 3] - tc[0, 0, 3] == pytest.approx(0.70, abs=0.08)    # 0.35 m/frame dolly
    jp = np.loadtxt(os.path.join(jdir, "MapPoints.txt")).reshape(-1, 3)
    tp = np.loadtxt(os.path.join(tdir, "MapPoints.txt")).reshape(-1, 3)
    assert len(tp) == len(jp) > 100 and 4.0 < np.median(tp[:, 2]) < 30.0
    jo = parse_map_objects(os.path.join(jdir, "MapObjects.txt"))
    to = parse_map_objects(os.path.join(tdir, "MapObjects.txt"))
    assert len(to) == len(jo) >= 1
    for (_, a, ca), (_, b, cb) in zip(jo, to):
        assert np.abs(a - b).max() <= 1e-3 and np.abs(ca - cb).max() <= 1e-3
        assert cb.shape == (64,)
    assert np.linalg.norm(to[0][1][:3, 3] - np.array([2.5, 0.45, 10.0])) < 1.0


@pytest.mark.parametrize("option", [["--overlay_dir"], ["--live_view_dir"], ["--live_view_dir", "--live_view_port"]])
def test_unported_options_raise(option, tmp_path):
    """The viewer options raised NotImplementedError until slice 7 ported
    the viewers; now they run over 2 mini-KITTI frames (pipelined, so the
    last frame finishes at flush): one overlay PNG per frame, the shape of
    its frame; the live view's three files (served on a free port);
    `--live_view_port` without `--live_view_dir` is a usage error."""
    from PIL import Image

    from dspslam_tpu_torch.apps import dsp_slam as tdsp

    out = tmp_path / "view"
    argv = ["--sequence_dir", FIXTURE, "--map_dir", str(tmp_path / "map"), "--frames", "2", "--no_objects",
            "--pipeline", "--device", "cpu", option[0], str(out)]
    if "--live_view_port" in option:
        argv += ["--live_view_port", "0", "--live_view_every", "1"]
    tdsp.main(argv)
    if option == ["--overlay_dir"]:
        pngs = sorted(os.listdir(out))
        assert pngs == ["000000.png", "000001.png"]
        for f in pngs:
            img = np.asarray(Image.open(out / f))
            assert img.shape == (160, 512, 3) and (img[-6:] == [0, 255, 0]).all()
    else:
        assert {"map.png", "frame.png", "index.html"} <= set(os.listdir(out))
        assert "state OK" in (out / "index.html").read_text()
    with pytest.raises(SystemExit):
        tdsp.main(["--sequence_dir", FIXTURE, "--device", "cpu", "--live_view_port", "8000"])


def test_cli_defaults_to_the_card(tmp_path):
    from dspslam_tpu_torch.apps import dsp_slam as tdsp

    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tdsp.main(["--sequence_dir", FIXTURE, "--map_dir", str(tmp_path)])


def test_vocabulary_save_state_and_mesh_export(tmp_path):
    from dspslam_tpu.apps import extract_map_objects as jextract
    from dspslam_tpu_torch.apps import dsp_slam as tdsp
    from dspslam_tpu_torch.apps import extract_map_objects as textract
    from dspslam_tpu_torch.datasets.kitti import KITTISequence
    from dspslam_tpu_torch.frontend import orb
    from dspslam_tpu_torch.place.vocabulary import Vocabulary
    from dspslam_tpu_torch.slam import state_io

    cfg = _config(tmp_path)
    img, _ = KITTISequence(FIXTURE, None).load_stereo_gray(0)
    f = orb.extract(torch.from_numpy(np.ascontiguousarray(img)), orb.ORBParams(n_features=1000, n_levels=4))
    voc = Vocabulary.train(f["desc"].numpy().view(np.uint32)[f["valid"].numpy() > 0], branching=6, levels=2)
    voc.save(str(tmp_path / "voc.npz"))
    state = str(tmp_path / "state.npz")
    ts = tdsp.main(["--sequence_dir", FIXTURE, "--config", cfg, "--map_dir", str(tmp_path / "map"),
                    "--vocabulary", str(tmp_path / "voc.npz"), "--save_state", state, "--device", "cpu"])
    assert ts.loop_closer is not None and ts.tracker.relocalizer is not None
    assert ts.loop_closer.loops_closed == 0
    assert set(ts.kf_db.vectors) == set(ts.map.keyframes)
    loaded = state_io.load_state(state)
    assert set(loaded.keyframes) == set(ts.map.keyframes) and len(loaded.objects) >= 1
    loaded.check_invariants()

    objs, meshes = textract.main(["--map_dir", str(tmp_path / "map"), "--config", cfg,
                                  "--voxels_dim", "16", "--device", "cpu",
                                  "--output_dir", str(tmp_path / "meshes_torch")])
    jobjs = jextract.main(["--map_dir", str(tmp_path / "map"), "--config", cfg, "--voxels_dim", "16",
                           "--output_dir", str(tmp_path / "meshes_jax")])
    assert [o[0] for o in objs] == [o[0] for o in jobjs] and len(objs) >= 1
    from dspslam_tpu_torch.utils import io as tio

    for obj_id, Two, _ in objs:
        jv, jf = tio.read_mesh_ply(str(tmp_path / "meshes_jax" / f"{obj_id}.ply"))
        tv, tf = meshes[obj_id]["vertices"], meshes[obj_id]["faces"]
        assert tv.shape == jv.shape and tf.shape == jf.shape and len(tv) > 0
        np.testing.assert_allclose(tv, jv, atol=1e-4)
        np.testing.assert_array_equal(np.load(str(tmp_path / "meshes_torch" / f"{obj_id}_pose.npy")), Two)


def test_vocabulary_without_loop_attaches_relocalization_only(tmp_path):
    from dspslam_tpu_torch import config as cfg_mod
    from dspslam_tpu_torch.apps import dsp_slam as tdsp
    from dspslam_tpu_torch.place.vocabulary import Vocabulary

    voc = Vocabulary.train(np.random.default_rng(0).integers(0, 2**32, (500, 8), dtype=np.uint32),
                           branching=4, levels=2)
    s = tdsp.build_system(cfg_mod.SystemConfig(), None, enable_objects=False, device="cpu",
                          vocabulary=voc, enable_loop=False)
    assert s.loop_closer is None and s.tracker.relocalizer is not None and s.kf_db is not None
