"""The port's viewers and tools on the CPU: viz/frame_drawer.py and
viz/renderer.py against the JAX package's (host numpy copies, so equal
outputs from equal inputs), the live viewer, apps/visualize_map.py and
apps/train_vocabulary.py writing their files.

Checked: `draw_frame` pixel-equal to JAX's from the same keypoints, map
point ids and detection mask, in each tracking state; `rasterize_mesh` of a
marching-tetrahedra sphere equal to JAX's (depth, ids, shade) and its
depth within 2% of the true sphere's at the centre pixel;
`render_map_objects` composites two objects nearest-first; the map snapshot,
the live view, visualize_map's PLY and PNG (static and follow mode) and a
trained vocabulary are written and read back.
"""

import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

from dspslam_tpu.viz import frame_drawer as jfd
from dspslam_tpu.viz import renderer as jrender
from dspslam_tpu_torch.apps import train_vocabulary, visualize_map
from dspslam_tpu_torch.shape import mesh as mesh_mod
from dspslam_tpu_torch.slam.map import Frame, KeyFrame, Map, MapObject, MapPoint
from dspslam_tpu_torch.utils import io as io_mod
from dspslam_tpu_torch.viz import frame_drawer, live_viewer, renderer
from torch_threads import one_torch_thread  # noqa: F401

K = np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]])


def sphere_mesh(radius=1.0, n=24):
    g = np.linspace(-1.5, 1.5, n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    verts, faces = mesh_mod.marching_tetrahedra((np.sqrt(x ** 2 + y ** 2 + z ** 2) - radius).astype(np.float32))
    return (verts * 1.5).astype(np.float32), faces                   # [-1, 1] grid -> [-1.5, 1.5] m


@pytest.mark.parametrize("state", ["OK", "LOST", "NOT_INITIALIZED"])
def test_draw_frame_equals_jax(state):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    feats = {"xy": rng.uniform(-5, 165, (300, 2)).astype(np.float32),
             "valid": (rng.uniform(size=300) > 0.2).astype(np.float32)}
    ids = np.where(rng.uniform(size=300) > 0.5, rng.integers(0, 100, 300), -1)
    mask = np.zeros((120, 160), bool)
    mask[30:70, 40:90] = True
    det = types.SimpleNamespace(mask=mask)
    out = frame_drawer.draw_frame(img, feats, ids, detections=[det, None], state=state)
    np.testing.assert_array_equal(out, jfd.draw_frame(img, feats, ids, detections=[det, None], state=state))
    assert out.shape == (120, 160, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(frame_drawer.draw_frame(img, feats), jfd.draw_frame(img, feats))


def test_rasterize_sphere_equals_jax():
    verts, faces = sphere_mesh()
    T = np.eye(4)
    T[2, 3] = 6.0
    out = renderer.rasterize_mesh(verts, faces, K, T, (120, 160), instance_id=3)
    ref = jrender.rasterize_mesh(verts, faces, K, T, (120, 160), instance_id=3)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    depth, ids, shade = out
    assert abs(depth[60, 80] - 5.0) < 0.1 and ids[60, 80] == 3 and 0.15 <= shade[60, 80] <= 1.0
    assert ids[0, 0] == 0 and np.isinf(depth[0, 0])


def _small_map():
    m = Map()
    verts, faces = sphere_mesh()
    for oid, (x, z) in enumerate(((0.0, 6.0), (0.5, 9.0))):
        obj = MapObject(np.eye(4, dtype=np.float32), np.zeros(64, np.float32), ref_kf_id=0)
        obj.T_wo[:3, 3] = (x, 0.0, z)
        obj.vertices, obj.faces = verts, faces
        m.objects[obj.id] = obj
    rng = np.random.default_rng(0)
    for _ in range(50):
        p = MapPoint(rng.normal(0, 2, 3) + [0, 0, 10], np.zeros(8, np.uint32), ref_kf_id=0)
        m.points[p.id] = p
    for k in range(3):
        frame = Frame(0.1 * k, {"xy": np.zeros((0, 2), np.float32)})
        frame.T_cw[2, 3] = -0.5 * k
        kf = KeyFrame(frame)
        m.keyframes[kf.id] = kf
    return m


def test_render_map_objects_and_snapshot(tmp_path):
    m = _small_map()
    depth, ids, _ = renderer.render_map_objects(m, K, np.eye(4), (120, 160))
    near = min(m.objects)
    assert ids[60, 80] == near + 1 and abs(depth[60, 80] - 5.0) < 0.1
    jdepth, jids, _ = jrender.render_map_objects(m, K, np.eye(4), (120, 160))
    np.testing.assert_array_equal(ids, jids)
    renderer.save_map_snapshot(m, str(tmp_path / "snap.png"))
    assert Image.open(tmp_path / "snap.png").size[0] > 100


def test_live_viewer_writes_its_page(tmp_path):
    m = _small_map()
    system = types.SimpleNamespace(map=m, state=types.SimpleNamespace(name="OK"))
    viewer = live_viewer.LiveViewer(system, str(tmp_path), every=2, serve_port=None, budget_s=0.0)
    frame = types.SimpleNamespace(feats={"xy": np.array([[10.0, 10.0]]), "valid": np.ones(1)},
                                  map_point_ids=np.array([3]))
    viewer.tick(1, frame, np.zeros((40, 60)))
    assert not os.listdir(tmp_path)                       # only every 2nd frame
    viewer.tick(2, frame, np.zeros((40, 60)))
    viewer.close()
    assert {"map.png", "frame.png", "index.html"} <= set(os.listdir(tmp_path))
    assert np.asarray(Image.open(tmp_path / "frame.png")).shape == (40, 60, 3)
    assert "frame 2 | state OK" in (tmp_path / "index.html").read_text()


def _write_map_dir(d):
    os.makedirs(d / "meshes")
    verts, faces = sphere_mesh(n=12)
    np.savetxt(d / "MapPoints.txt", np.random.default_rng(1).normal(0, 3, (40, 3)))
    np.savetxt(d / "Cameras.txt", np.tile(np.eye(4)[:3].reshape(1, 12), (3, 1)))
    with open(d / "MapObjects.txt", "w") as f:
        f.write("7\n" + " ".join(["1", "0", "0", "2", "0", "1", "0", "0", "0", "0", "1", "8"]) + "\n"
                + " ".join(["0"] * 64) + "\n")
    io_mod.write_mesh_ply(verts, faces, str(d / "meshes" / "7.ply"))
    return len(verts), len(faces)


def test_visualize_map_static_and_follow(tmp_path):
    nv, nf = _write_map_dir(tmp_path / "map")
    visualize_map.main(["--map_dir", str(tmp_path / "map")])
    verts, faces = io_mod.read_mesh_ply(str(tmp_path / "map" / "joint_map.ply"))
    n_pts = len(verts) - nv
    assert 0 < n_pts <= 40 and len(faces) == nf and faces.min() == n_pts
    # the mesh is placed by its pose: translated by (2, 0, 8)
    assert np.abs(verts[n_pts:].mean(0) - [2.0, 0.0, 8.0]).max() < 0.1
    assert os.path.exists(tmp_path / "map" / "joint_map.png")
    frames = tmp_path / "frames"
    for k in ("000001", "000002"):
        _write_map_dir(frames / k)
    assert visualize_map.main(["--follow", str(frames), "--output", str(tmp_path / "png"), "--once"]) == 2
    assert sorted(os.listdir(tmp_path / "png")) == ["000001.png", "000002.png"]


def test_train_vocabulary_cli(tmp_path):
    from dspslam_tpu_torch.place.vocabulary import Vocabulary

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    src = os.path.join(os.path.dirname(__file__), "fixtures", "mini_kitti", "image_2")
    for f in sorted(os.listdir(src))[:2]:
        Image.open(os.path.join(src, f)).save(imgs / f)
    out = str(tmp_path / "voc.npz")
    voc = train_vocabulary.main(["--image_dir", str(imgs), "--output", out, "--stride", "1", "--branching", "4",
                                 "--levels", "2", "--device", "cpu"])
    back = Vocabulary.load_any(out)
    assert back.n_words == voc.n_words == 16
    np.testing.assert_array_equal(back.word_weights, voc.word_weights)
    descs = train_vocabulary.image_descriptors(str(imgs / sorted(os.listdir(imgs))[0]),
                                               train_vocabulary.orb.ORBParams(), "cpu")
    assert descs.dtype == np.uint32 and descs.shape[1] == 8 and len(descs) > 100


def test_train_vocabulary_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        train_vocabulary.main(["--image_dir", str(tmp_path)])
