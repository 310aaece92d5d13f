"""Perceptual aliasing: tests/test_loop_aliasing.py's corridor with two
identical storefronts (same descriptors, same local 3D layout at x=3 and
x=17) driven through the JAX package's and the PyTorch port's
LoopCloser, with test_torch_loop_closing.py's helpers (same id counters in
both packages, Map.check_invariants after each correction and GBA apply).

Expected in both packages alike: with the neighbourhood projection gate
the false loop is rejected; without it (min_total_matches=0) it closes,
which shows the fixture exercises the gate; a drifted true revisit of the
start closes on the same keyframe with the gate on.
"""

import numpy as np
import pytest

from test_torch_loop_closing import _drifted_run, _sync_ids
from torch_threads import one_torch_thread  # noqa: F401


STORE_A_X, STORE_B_X, PATCH_N = 3.0, 17.0, 18


def _alias_world():
    rng = np.random.default_rng(11)
    pos, desc = [], []
    for cell in range(25):
        for _ in range(6):
            pos.append(np.array([cell + rng.uniform(0, 1), rng.uniform(-2, 2), rng.uniform(6, 10)],
                                np.float32))
            desc.append(rng.integers(0, 2**32, 8, dtype=np.uint32))
    off = np.stack([rng.uniform(-0.6, 0.6, PATCH_N), rng.uniform(-1.5, 1.5, PATCH_N),
                    rng.uniform(7.0, 9.0, PATCH_N)], -1).astype(np.float32)
    pdesc = rng.integers(0, 2**32, (PATCH_N, 8), dtype=np.uint32)
    for x0 in (STORE_A_X, STORE_B_X):
        for k in range(PATCH_N):
            pos.append(np.array([x0, 0, 0], np.float32) + off[k])
            desc.append(pdesc[k])
    return np.stack(pos), np.stack(desc)


@pytest.mark.parametrize("gate", [True, False], ids=["gated", "ungated"])
def test_aliased_storefront(gate):
    """Gated: the repeated storefront is rejected by the neighbourhood
    projection gate (0 loops). Ungated (min_total_matches=0): the false loop
    closes, which shows the fixture exercises the gate. Both packages
    alike."""
    lmk_pos, lmk_desc = _alias_world()
    kw = {} if gate else {"min_total_matches": 0}
    xs = list(np.arange(0.0, 23.0, 1.0))
    loops = {}
    for pkg in ("jax", "torch"):
        _sync_ids()
        loops[pkg] = _drifted_run(pkg, xs, set(), lambda s: 0.0, lmk_pos, lmk_desc, online=True,
                                  n_slots=200, closer_kwargs=kw, voc_seed=2)[0].loops_closed
    assert loops["torch"] == loops["jax"]
    assert (loops["torch"] == 0) if gate else (loops["torch"] >= 1)


def test_true_revisit_closes_in_both_packages():
    """The aliasing world's control: a drifted return to the start is a
    true revisit, and it closes with the gate on."""
    lmk_pos, lmk_desc = _alias_world()
    xs = list(range(0, 12)) + list(range(10, -1, -1))
    closed = {}
    for pkg in ("jax", "torch"):
        _sync_ids()
        closed[pkg] = _drifted_run(pkg, xs, {12}, lambda s: max(0, s - 11) * 0.06, lmk_pos, lmk_desc,
                                   online=True, n_slots=200, voc_seed=2)[2]
    assert closed["torch"] == closed["jax"] and len(closed["torch"]) >= 1
