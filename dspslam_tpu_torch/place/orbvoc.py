"""DBoW2 ORBvoc ingestion: pretrained vocabulary files -> array tree.

A host numpy copy of dspslam_tpu/place/orbvoc.py that builds the port's
`place.vocabulary.Vocabulary`.

The reference boots from a pretrained 10^6-word ORB vocabulary
(reference src/System.cc:76-87: `loadFromBinaryFile` for .bin,
`loadFromTextFile` otherwise) trained on OpenCV's learned BRIEF pattern
(use frontend.orb.ORBParams(pattern="reference") for matching bits).
This module parses both on-disk formats of the modified DBoW2
(reference Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1351-1545)
and lays the (possibly non-complete) tree out in the complete-K-ary
array form that `place.vocabulary.Vocabulary` descends with batched
Hamming argmins:

* text format: header line "K L scoring weighting", then one line per
  node (ids implicit, 1-based, root omitted):
  `parent is_leaf b0..b31 weight` — 32 descriptor bytes, float weight;
* binary format: header `u32 nb_nodes, u32 size_node, i32 k, i32 L,
  i32 scoring, i32 weighting`, then nb_nodes packed 41-byte records
  `i32 parent, u8 desc[32], f32 weight, u8 is_leaf`;
* word ids follow DBoW2's convention (leaves numbered in file order;
  leaves may sit above the bottom level when a cluster had < K
  descriptors) via the Vocabulary.leaf_word indirection. Early leaves
  are extended to the bottom level through a chain of self-copy
  children so the masked descent terminates on the right word.

Descriptor bytes are packed little-endian into (8,) uint32 rows — the
same layout frontend.orb._pack_brief_bits produces, so Hamming
distances against extracted descriptors are exact.
"""

from __future__ import annotations

import numpy as np

from .vocabulary import Vocabulary


def _build_array_tree(
    K: int, L: int, parents: np.ndarray, is_leaf: np.ndarray,
    desc_u32: np.ndarray, weights: np.ndarray,
) -> Vocabulary:
    """Lay out DBoW2 nodes (1-based ids, root=0 omitted) in the
    complete-tree array form with validity masks.

    Fully vectorized: the reference vocabulary is 10^6 words / 1.1M
    nodes (System.cc:76-87), where a per-node Python loop took ~11 s;
    this level-synchronous numpy version lays the same tree out in
    <1 s (tools/vocab_reference_scale.py records the numbers)."""
    n_nodes_file = len(parents)
    node_ids = np.arange(1, n_nodes_file + 1)
    # children in file order (DBoW2 pushes back as it reads — the scan
    # order its transform() uses, which argmin tie-breaking must match):
    # rank of each node within its parent's child list
    order = np.argsort(parents, kind="stable")
    sorted_parents = parents[order]
    group_start = np.zeros(n_nodes_file, np.int64)
    if n_nodes_file > 1:
        firsts = np.nonzero(np.diff(sorted_parents))[0] + 1
        group_start[firsts] = firsts
        np.maximum.accumulate(group_start, out=group_start)
    rank = np.empty(n_nodes_file, np.int64)
    rank[order] = np.arange(n_nodes_file) - group_start
    if (rank >= K).any():
        bad = int(parents[rank >= K][0])
        raise ValueError(f"node {bad} has more than K={K} children")
    # word ids in file order of the leaves (TemplatedVocabulary.h:1421)
    word_of_node = np.full(n_nodes_file + 1, -1, np.int64)
    word_of_node[1:][is_leaf > 0] = np.arange(int(is_leaf.sum()))

    total = sum(K ** (l + 1) for l in range(L))
    centers = np.zeros((total, 8), np.uint32)
    valid = np.zeros(total, np.float32)
    leaf_word = np.full(K**L, -1, np.int32)
    level_offset = np.concatenate(
        [[0], np.cumsum([K ** (l + 1) for l in range(L)])]
    )

    # level-synchronous BFS: slot within level; root = virtual slot 0
    slot = np.full(n_nodes_file + 1, -1, np.int64)
    level_of = np.full(n_nodes_file + 1, -1, np.int64)
    slot[0] = 0
    in_frontier = np.zeros(n_nodes_file + 1, bool)
    in_frontier[0] = True
    placed = 0
    for lvl in range(L):
        mask = in_frontier[parents]            # children of current frontier
        children = node_ids[mask]
        if len(children) == 0:
            break
        s = slot[parents[mask]] * K + rank[mask]
        level_of[children] = lvl
        slot[children] = s
        rows = level_offset[lvl] + s
        centers[rows] = desc_u32[mask]
        valid[rows] = 1.0
        placed += len(children)
        in_frontier[:] = False
        in_frontier[children] = True
    if placed != n_nodes_file:
        raise ValueError(f"tree deeper than L={L}")

    # extend early leaves (words above the bottom level) to the bottom
    # via self-copy chains, one vectorized scatter per (level, depth)
    leaf_nodes = node_ids[is_leaf > 0]
    leaf_lvl = level_of[leaf_nodes]
    for lvl in range(L):
        at = leaf_nodes[leaf_lvl == lvl]
        if len(at) == 0:
            continue
        ss = slot[at]
        for deeper in range(lvl + 1, L):
            ss = ss * K
            rr = level_offset[deeper] + ss
            centers[rr] = desc_u32[at - 1]
            valid[rr] = 1.0
        leaf_word[ss] = word_of_node[at]

    n_words = int(is_leaf.sum())
    word_weights = np.zeros(n_words, np.float32)
    leaf_rows = np.nonzero(is_leaf)[0]
    word_weights[word_of_node[leaf_rows + 1]] = weights[leaf_rows]
    return Vocabulary(
        K, L, centers, word_weights, valid=valid, leaf_word=leaf_word
    )


def _bytes_to_u32(desc_bytes: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 8) uint32, little-endian (orb.py packing)."""
    return (
        np.ascontiguousarray(desc_bytes.astype(np.uint8))
        .view("<u4")
        .reshape(-1, 8)
    )


def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse a DBoW2 saveToTextFile vocabulary (e.g. ORBvoc.txt)."""
    with open(path) as f:
        header = f.readline().split()
        K, L = int(header[0]), int(header[1])
        body = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if body.shape[1] != 35:
        raise ValueError(
            f"expected 35 columns (parent is_leaf 32-bytes weight), "
            f"got {body.shape[1]}"
        )
    parents = body[:, 0].astype(np.int64)
    is_leaf = body[:, 1].astype(np.int64)
    desc_u32 = _bytes_to_u32(body[:, 2:34])
    weights = body[:, 34].astype(np.float32)
    return _build_array_tree(K, L, parents, is_leaf, desc_u32, weights)


_BIN_NODE = np.dtype(
    [("parent", "<i4"), ("desc", "u1", 32), ("weight", "<f4"),
     ("is_leaf", "u1")]
)


def load_orbvoc_binary(path: str) -> Vocabulary:
    """Parse a DBoW2 saveToBinaryFile vocabulary (e.g. ORBvoc.bin)."""
    with open(path, "rb") as f:
        head = f.read(24)
        nb_nodes = int(np.frombuffer(head[0:4], "<u4")[0])
        size_node = int(np.frombuffer(head[4:8], "<u4")[0])
        K = int(np.frombuffer(head[8:12], "<i4")[0])
        L = int(np.frombuffer(head[12:16], "<i4")[0])
        if size_node != _BIN_NODE.itemsize:
            raise ValueError(f"unexpected node record size {size_node}")
        recs = np.frombuffer(f.read(nb_nodes * size_node), dtype=_BIN_NODE)
    return _build_array_tree(
        K, L,
        recs["parent"].astype(np.int64),
        recs["is_leaf"].astype(np.int64),
        _bytes_to_u32(recs["desc"]),
        recs["weight"].astype(np.float32),
    )


def load_orbvoc(path: str) -> Vocabulary:
    """Load ORBvoc.bin or ORBvoc.txt by extension (System.cc:76-87)."""
    if path.endswith(".bin"):
        return load_orbvoc_binary(path)
    return load_orbvoc_text(path)


def save_orbvoc_binary(voc_nodes, path: str):
    """Write a DBoW2 binary vocabulary from raw node rows
    (parents, is_leaf, desc_bytes (N, 32), weights) — the test fixture
    writer for round-tripping synthetic vocabularies."""
    parents, is_leaf, desc_bytes, weights, K, L = voc_nodes
    n = len(parents)
    recs = np.zeros(n, _BIN_NODE)
    recs["parent"] = parents
    recs["desc"] = desc_bytes
    recs["weight"] = weights
    recs["is_leaf"] = is_leaf
    with open(path, "wb") as f:
        f.write(np.asarray([n, _BIN_NODE.itemsize], "<u4").tobytes())
        f.write(np.asarray([K, L, 0, 0], "<i4").tobytes())
        f.write(recs.tobytes())
