"""Place recognition: the JAX package's vocabulary, keyframe database, ORBvoc
ingest, Sim(3) RANSAC / refinement and RANSAC PnP against the PyTorch
port's, on the inputs of tests/test_place.py, test_orbvoc.py, test_pnp.py
and the KFDB cases of test_reloc_mono.py (random descriptors and points
from fixed numpy seeds).

Tolerances: trained centres, word ids and inverted-index query results
(ids and order) are exactly equal; BoW weights and idf weights within
1e-6; Horn, Sim(3) RANSAC and PnP (host numpy copies with the same seeded
RNG) exactly equal; `refine_sim3_reproj` within 1e-4 in S12 with the same
inlier set and count, and its gate within 1e-3 px^2.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.ops import lie as jlie
from dspslam_tpu.place import orbvoc as jorbvoc
from dspslam_tpu.place import sim3 as jsim3
from dspslam_tpu.place import vocabulary as jvoc
from dspslam_tpu.slam import pnp as jpnp
from dspslam_tpu_torch.place import orbvoc as torbvoc
from dspslam_tpu_torch.place import sim3 as tsim3
from dspslam_tpu_torch.place import vocabulary as tvoc
from dspslam_tpu_torch.slam import pnp as tpnp
from torch_threads import one_torch_thread  # noqa: F401


def random_descs(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def _as_port(v: jvoc.Vocabulary) -> tvoc.Vocabulary:
    return tvoc.Vocabulary(v.branching, v.levels, v.centers, v.word_weights, v.valid, v.leaf_word)


def _same_bow(a, b):
    np.testing.assert_array_equal(a.words, b.words)
    np.testing.assert_allclose(a.weights, b.weights, atol=1e-6)


# ---------------------------------------------------------------------------
# vocabulary


@pytest.fixture(scope="module")
def trained():
    descs = random_descs(3000, seed=1)
    return (descs, jvoc.Vocabulary.train(descs, branching=6, levels=2, seed=1),
            tvoc.Vocabulary.train(descs, branching=6, levels=2, seed=1))


def test_train_matches_jax(trained):
    _, jv, tv = trained
    np.testing.assert_array_equal(tv.centers, jv.centers)
    np.testing.assert_allclose(tv.word_weights, jv.word_weights, atol=1e-6)


def test_assign_words_and_bow_match_jax(trained):
    descs, jv, tv = trained
    words = tv.assign_words(descs[:500])
    np.testing.assert_array_equal(words, jv.assign_words(descs[:500]))
    # the device form: an int32 tensor descends where it lies
    t = torch.from_numpy(descs[:500].view(np.int32))
    np.testing.assert_array_equal(tv.assign_words(t), words)
    valid = (np.arange(500) % 3 > 0).astype(np.float32)
    _same_bow(tv.bow_vector(descs[:500], valid), jv.bow_vector(descs[:500], valid))


def test_similar_images_score_higher(trained):
    descs, jv, tv = trained
    img_a = descs[:400]
    flip = np.zeros_like(img_a)
    flip[:40] = 1 << 3
    va, va2, vb = (tv.bow_vector(x) for x in (img_a, img_a ^ flip, descs[1500:1900]))
    assert tvoc.Vocabulary.score(va, va2) > tvoc.Vocabulary.score(va, vb)
    assert tvoc.Vocabulary.score(va, va) == pytest.approx(1.0, abs=1e-5)
    assert tvoc.Vocabulary.score(va, vb) == pytest.approx(
        jvoc.Vocabulary.score(jv.bow_vector(img_a), jv.bow_vector(descs[1500:1900])), abs=1e-6)


def test_database_query_matches_jax():
    descs = random_descs(2000, seed=2)
    jv = jvoc.Vocabulary.train(descs, branching=6, levels=2, seed=2)
    tv = _as_port(jv)
    jdb, tdb = jvoc.KeyFrameDatabase(jv), tvoc.KeyFrameDatabase(tv)
    for i in range(6):
        d = descs[(i * 300) % 1700: (i * 300) % 1700 + 300]
        jdb.add(i, jv.bow_vector(d))
        tdb.add(i, tv.bow_vector(d))
    for lo, hi, exclude in ((600, 900, {3}), (0, 400, set()), (100, 700, {0})):
        jres = jdb.query(jv.bow_vector(descs[lo:hi]), 0.0, exclude=exclude)
        tres = tdb.query(tv.bow_vector(descs[lo:hi]), 0.0, exclude=exclude)
        assert [k for k, _ in tres] == [k for k, _ in jres]
        np.testing.assert_allclose([s for _, s in tres], [s for _, s in jres], atol=1e-6)
    res = tdb.query(tv.bow_vector(descs[600:900]), 0.1, exclude={3})
    assert res[0][0] == 2 and all(k != 3 for k, _ in res)


def _fake_bow(rng, n_words=12, vocab_size=4000):
    words = np.sort(rng.choice(vocab_size, size=n_words, replace=False))
    w = rng.random(n_words).astype(np.float32)
    return tvoc.BowVector(words=words.astype(np.int64), weights=w / w.sum())


def test_kfdb_compaction_bounded():
    """tests/test_reloc_mono.py's 10^4 insert / cull cycles."""
    rng = np.random.default_rng(0)
    db = tvoc.KeyFrameDatabase(voc=None)
    live = 200
    for i in range(10_000):
        db.add(i, _fake_bow(rng))
        if i >= live:
            db.erase(i - live)
    assert len(db.vectors) == live
    assert sum(len(s) for s in db.inverted.values()) == sum(len(v.words) for v in db.vectors.values())
    assert min(i for s in db.inverted.values() for i in s) >= 10_000 - live
    q = _fake_bow(rng)
    t0 = time.perf_counter()
    for _ in range(50):
        db.query(q, 0.0, exclude=set())
    assert (time.perf_counter() - t0) / 50 < 0.01


def test_map_erase_hook_compacts_db():
    from dspslam_tpu_torch.slam.map import Frame, KeyFrame, Map

    rng = np.random.default_rng(1)
    m = Map()
    db = tvoc.KeyFrameDatabase(voc=None)
    m.keyframe_erase_hooks.append(db.erase)
    feats = {"xy": np.zeros((2, 2), np.float32), "desc": np.zeros((2, 8), np.uint32),
             "valid": np.ones(2, np.float32)}
    for i in range(10):
        kf = KeyFrame(Frame(float(i), dict(feats)))
        db.add(kf.id, _fake_bow(rng))
        m.add_keyframe(kf)
    ids = sorted(m.keyframes)
    m.erase_keyframe(ids[3])
    m.erase_keyframe(ids[7])
    assert ids[3] not in db.vectors and ids[7] not in db.vectors
    assert all(ids[3] not in s and ids[7] not in s for s in db.inverted.values())
    m.check_invariants()


# ---------------------------------------------------------------------------
# ORBvoc ingest (tests/test_orbvoc.py's generated DBoW2 tree)


@pytest.fixture(scope="module")
def dbow2_tree():
    import sys

    sys.path.insert(0, "tests")
    from test_orbvoc import _dbow2_transform, _gen_dbow2_tree, _write_text

    return _gen_dbow2_tree(), _dbow2_transform, _write_text


def test_orbvoc_ingest_and_masked_descent(dbow2_tree, tmp_path):
    tree, dbow2_transform, write_text = dbow2_tree
    parents, is_leaf, descs, weights, K, L = tree
    write_text(tmp_path / "voc.txt", parents, is_leaf, descs, weights, K, L)
    torbvoc.save_orbvoc_binary(tree, str(tmp_path / "voc.bin"))
    vt = torbvoc.load_orbvoc_text(str(tmp_path / "voc.txt"))
    vb = tvoc.Vocabulary.load_any(str(tmp_path / "voc.bin"))
    jb = jorbvoc.load_orbvoc_binary(str(tmp_path / "voc.bin"))
    for a in (vt, jb):
        np.testing.assert_array_equal(vb.centers, a.centers)
        np.testing.assert_array_equal(vb.valid, a.valid)
        np.testing.assert_array_equal(vb.leaf_word, a.leaf_word)
        np.testing.assert_allclose(vb.word_weights, a.word_weights, rtol=1e-6)

    rng = np.random.default_rng(3)
    queries = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    q32 = np.ascontiguousarray(queries).view("<u4").reshape(-1, 8)
    got = vb.assign_words(q32)
    np.testing.assert_array_equal(got, [dbow2_transform(parents, is_leaf, descs, q) for q in queries])
    np.testing.assert_array_equal(got, jb.assign_words(q32))
    _same_bow(vb.bow_vector(q32), jb.bow_vector(q32))

    vb.save(str(tmp_path / "voc.npz"))
    back = tvoc.Vocabulary.load_any(str(tmp_path / "voc.npz"))
    np.testing.assert_array_equal(back.assign_words(q32), got)


# ---------------------------------------------------------------------------
# Sim(3)


def _rot(w):
    return np.asarray(jlie.exp_so3(jnp.asarray(w, jnp.float32)))


def test_horn_and_ransac_match_jax():
    rng = np.random.default_rng(7)
    p2 = rng.normal(size=(60, 3)) * 3
    R_true = _rot([0.0, 0.4, 0.1])
    p1 = 1.2 * (p2 @ R_true.T) + np.array([0.5, 1.0, -2.0])
    p1[:18] += rng.normal(0, 5.0, (18, 3))
    for fix in (False, True):
        for a, b in zip(tsim3.horn_sim3(p1[18:], p2[18:], fix), jsim3.horn_sim3(p1[18:], p2[18:], fix)):
            np.testing.assert_array_equal(a, b)
    T, inl = tsim3.ransac_sim3(p1, p2, fix_scale=False, seed=3)
    Tj, inlj = jsim3.ransac_sim3(p1, p2, fix_scale=False, seed=3)
    np.testing.assert_array_equal(T, Tj)
    np.testing.assert_array_equal(inl, inlj)
    assert inl[18:].mean() > 0.95 and inl[:18].mean() < 0.2
    assert np.linalg.det(T[:3, :3]) ** (1 / 3) == pytest.approx(1.2, rel=0.02)
    garbage = tsim3.ransac_sim3(rng.normal(size=(40, 3)), rng.normal(size=(40, 3)), min_inliers=20)
    assert garbage[0] is None


@pytest.mark.parametrize("fix_scale", [True, False])
def test_refine_sim3_reproj_matches_jax(fix_scale):
    """A Sim(3) between two stereo-like keyframes, 80 matches with pixel
    noise and 12 gross outliers, seeded 0.05 m / 0.02 rad off."""
    rng = np.random.default_rng(11)
    intr = np.asarray([500.0, 500.0, 320.0, 240.0], np.float32)
    x2 = np.stack([rng.uniform(-4, 4, 80), rng.uniform(-2, 2, 80), rng.uniform(5, 15, 80)], -1)
    S_true = np.eye(4)
    S_true[:3, :3] = (1.0 if fix_scale else 1.1) * _rot([0.02, -0.05, 0.01])
    S_true[:3, 3] = [0.4, -0.1, 0.3]
    x1 = x2 @ S_true[:3, :3].T + S_true[:3, 3]

    def proj(p):
        return np.stack([intr[0] * p[:, 0] / p[:, 2] + intr[2], intr[1] * p[:, 1] / p[:, 2] + intr[3]], -1)

    uv1 = proj(x1) + rng.normal(0, 0.5, (80, 2))
    uv2 = proj(x2) + rng.normal(0, 0.5, (80, 2))
    uv1[:12] += rng.uniform(-60, 60, (12, 2))
    S0 = S_true.copy()
    S0[:3, :3] = S0[:3, :3] @ _rot([0.0, 0.02, 0.0])
    S0[:3, 3] += [0.05, 0.0, -0.05]
    args = (S0.astype(np.float32), x1.astype(np.float32), x2.astype(np.float32),
            uv1.astype(np.float32), uv2.astype(np.float32))
    Sj, inj, nj, thj = jsim3.refine_sim3_reproj(*args, fix_scale=fix_scale, intrinsics=intr)
    St, int_, nt, tht = tsim3.refine_sim3_reproj(*args, fix_scale=fix_scale, intrinsics=intr)
    np.testing.assert_allclose(St, Sj, atol=1e-4)
    np.testing.assert_array_equal(int_, inj)
    assert nt == nj and 60 <= nt <= 68
    assert tht == pytest.approx(thj, abs=1e-3)
    np.testing.assert_allclose(St[:3, 3], S_true[:3, 3], atol=0.05)


# ---------------------------------------------------------------------------
# PnP (tests/test_pnp.py's scene)


def test_pnp_matches_jax():
    rng = np.random.default_rng(31)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    pts = np.stack([rng.uniform(-4, 4, 80), rng.uniform(-3, 3, 80), rng.uniform(5, 15, 80)], -1)
    T = np.asarray(jlie.exp_se3(jnp.asarray([0.5, -0.2, 0.3, 0.1, -0.15, 0.05])))
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = (pc @ K.T)[:, :2] / pc[:, 2:3]
    np.testing.assert_array_equal(tpnp.pnp_dlt(pts, uv, K), jpnp.pnp_dlt(pts, uv, K))
    uv = uv + rng.normal(0, 0.5, uv.shape)
    uv[:20] += rng.uniform(40, 100, (20, 2))     # 25% outliers
    Tt, mt = tpnp.ransac_pnp(pts, uv, K, seed=2)
    Tj, mj = jpnp.ransac_pnp(pts, uv, K, seed=2)
    np.testing.assert_array_equal(Tt, Tj)
    np.testing.assert_array_equal(mt, mj)
    assert mt[20:].mean() > 0.9 and mt[:20].mean() < 0.2
    np.testing.assert_allclose(Tt[:3, 3], T[:3, 3], atol=0.1)
    assert tpnp.pnp_dlt(pts[:5], uv[:5], K) is None
    garbage = tpnp.ransac_pnp(rng.normal(size=(40, 3)) + [0, 0, 10], rng.uniform(0, 640, (40, 2)), K,
                              min_inliers=15)
    assert garbage[0] is None
