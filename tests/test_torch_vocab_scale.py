"""Vocabulary at scale: tests/test_vocab_scale.py's self-similar street (30
places x 10 keyframes, a K=10, L=4 vocabulary of 10^4 words trained on
36,000 descriptors) and tests/test_vocab_reference_scale.py's reference
tree shape (K=10, L=6: 10^6 words, 1.11M nodes, from
tools/vocab_reference_scale.py's generator), through the JAX package and
the PyTorch port.

Tolerances: trained centres, word ids and query results (ids and order)
exactly equal; idf weights within 1e-6.
"""

import sys

import numpy as np
import pytest
import torch

from dspslam_tpu.place import orbvoc as jorbvoc
from dspslam_tpu.place import vocabulary as jvoc
from dspslam_tpu_torch.place import orbvoc as torbvoc
from dspslam_tpu_torch.place import vocabulary as tvoc

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")
import test_vocab_scale as street_mod  # noqa: E402
from vocab_reference_scale import generate_complete_dbow2  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def street():
    """test_vocab_scale's street fixture, with both packages' vocabulary
    and database built from it."""
    rng0 = np.random.default_rng(3)
    bg = street_mod._pool(street_mod.N_BG, rng0)
    places = [street_mod._pool(street_mod.N_PLACE, rng0) for _ in range(street_mod.N_PLACES)]
    n_feat, n_place, n_bg = street_mod.N_FEAT, street_mod.N_PLACE, street_mod.N_BG

    def keyframe_descs(place_idx, rng):
        nb = int(n_feat * street_mod.BG_FRACTION)
        d = np.concatenate([bg[rng.choice(n_bg, nb, replace=False)],
                            places[place_idx][rng.choice(n_place, n_feat - nb, replace=False)]])
        return street_mod._noisy(d, rng)

    train = np.concatenate(
        [keyframe_descs(p, np.random.default_rng(100 + 31 * p + r))
         for p in range(street_mod.N_PLACES) for r in range(3)]
        + [street_mod._noisy(bg, np.random.default_rng(60 + r)) for r in range(3)])
    tv = tvoc.Vocabulary.train(train, branching=10, levels=4, iters=6, seed=0)
    jv = jvoc.Vocabulary.train(train, branching=10, levels=4, iters=6, seed=0)
    tdb, jdb = tvoc.KeyFrameDatabase(tv), jvoc.KeyFrameDatabase(jv)
    kf_place = {}
    rng = np.random.default_rng(7)
    for kf_id in range(street_mod.N_PLACES * street_mod.KF_PER_PLACE):
        d = keyframe_descs(kf_id // street_mod.KF_PER_PLACE, rng)
        tdb.add(kf_id, tv.bow_vector(d))
        jdb.add(kf_id, jv.bow_vector(d))
        kf_place[kf_id] = kf_id // street_mod.KF_PER_PLACE
    return tv, jv, tdb, jdb, kf_place, keyframe_descs


def test_street_vocabulary_matches_jax(street):
    tv, jv, tdb, jdb, _, _ = street
    assert tv.n_words == 10_000
    np.testing.assert_array_equal(tv.centers, jv.centers)
    np.testing.assert_allclose(tv.word_weights, jv.word_weights, atol=1e-6)
    for k in range(0, 300, 37):
        np.testing.assert_array_equal(tdb.vectors[k].words, jdb.vectors[k].words)
        np.testing.assert_allclose(tdb.vectors[k].weights, jdb.vectors[k].weights, atol=1e-6)


def test_revisit_query_is_precise_and_matches_jax(street):
    tv, jv, tdb, jdb, kf_place, keyframe_descs = street
    d = keyframe_descs(0, np.random.default_rng(99))
    exclude = {k for k, p in kf_place.items() if p == 29}
    tc = tdb.query(tv.bow_vector(d), min_score=0.05, exclude=exclude)
    jc = jdb.query(jv.bow_vector(d), min_score=0.05, exclude=exclude)
    assert [k for k, _ in tc] == [k for k, _ in jc]
    np.testing.assert_allclose([s for _, s in tc], [s for _, s in jc], atol=1e-6)
    assert len(tc) >= 1 and all(kf_place[k] == 0 for k, _ in tc[:10])


def test_inverted_index_erase(street):
    tv, _, tdb, _, kf_place, keyframe_descs = street
    rng = np.random.default_rng(77)
    q = tv.bow_vector(keyframe_descs(3, rng))
    target = tdb.query(q, 0.05, exclude=set())[0][0]
    tdb.erase(target)
    assert all(k != target for k, _ in tdb.query(q, 0.05, exclude=set()))
    tdb.add(target, tv.bow_vector(keyframe_descs(kf_place[target], rng)))


def test_reference_shape_ingest_and_query(tmp_path):
    path = str(tmp_path / "voc.bin")
    assert generate_complete_dbow2(10, 6, path) == 1_111_110
    tv = torbvoc.load_orbvoc_binary(path)
    jv = jorbvoc.load_orbvoc_binary(path)
    assert tv.n_words == 1_000_000
    np.testing.assert_array_equal(tv.centers, jv.centers)
    q = np.random.default_rng(1).integers(0, 2**32, (2000, 8), dtype=np.uint32)
    words = tv.assign_words(q)
    np.testing.assert_array_equal(words, jv.assign_words(q))
    bt, bj = tv.bow_vector(q), jv.bow_vector(q)
    np.testing.assert_array_equal(bt.words, bj.words)
    np.testing.assert_allclose(bt.weights, bj.weights, atol=1e-6)
    # the device tree is cached: repeated queries do not re-upload it
    dev1, _ = tv._device_tree(torch.device("cpu"))
    tv.assign_words(q[:16])
    assert tv._device_tree(torch.device("cpu"))[0] is dev1
    # npz round trip keeps the masked tree
    tv.save(str(tmp_path / "voc.npz"))
    np.testing.assert_array_equal(tvoc.Vocabulary.load(str(tmp_path / "voc.npz")).assign_words(q[:256]),
                                  words[:256])
