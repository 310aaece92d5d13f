"""Bag-of-binary-words vocabulary and the keyframe database.

Port of dspslam_tpu/place/vocabulary.py (DBoW2's TemplatedVocabulary and
KeyFrameDatabase of the reference). Training (k-medians over bits,
seeded), the file formats, the sparse BoW vectors, the DBoW2 L1 score and
the inverted-file `KeyFrameDatabase` are host numpy, copied unchanged.

Word assignment descends the K-ary tree on the device, one (n, K)
distance block per level for all descriptors at once. The JAX package
takes Hamming distances as XOR + population count; torch has no popcount,
so each block is built on the descriptor bits, |a| + |c| - 2 a.c, the
form of `frontend.matcher.hamming_matrix`, with the children's centres
gathered per node. The entries are integers <= 256, exact in f32, and
`torch.argmin` returns the first minimum as `jnp.argmin` does, so word
ids equal the JAX package's bit for bit. On a non-complete (ingested
DBoW2) tree invalid child slots take a +1024 penalty, and ties break to
the lowest slot: DBoW2's first-child-wins scan order.

BoW vectors are sparse (sorted word ids + L1-normalised tf-idf weights);
the DBoW2 L1 score 1 - 0.5 |a - b|_1 is sum_i min(a_i, b_i) over the
shared words. Use K=10, L>=4 for street-scale loop closure: small
vocabularies flood detection with false candidates on self-similar
scenes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..frontend.matcher import _bits

_POP8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(1).astype(np.uint16)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) uint32 -> (N, M) int popcount distances, host.
    Byte-table popcount: 4x less transient memory than unpackbits."""
    x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
    return _POP8[x].sum(-1, dtype=np.int32)


def _bit_median(descs: np.ndarray) -> np.ndarray:
    """Majority-vote binary median of (N, 8) uint32 descriptors."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)      # (N, 256)
    med = (bits.mean(axis=0) >= 0.5).astype(np.uint8)
    return np.packbits(med).view(np.uint32)


def _descend(descs: torch.Tensor, centers: torch.Tensor, valid, branching: int,
             levels: int) -> torch.Tensor:
    """Batched tree descent: (n, 8) int32 descriptors over the packed
    (n_nodes, 8) int32 centres -> (n,) bottom-level slots. `valid` (n_nodes,)
    f32 or None (complete tree)."""
    K = branching
    n = descs.shape[0]
    a = _bits(descs)                                            # (n, 256)
    a_pop = a.sum(-1, keepdim=True)
    node = torch.zeros(n, dtype=torch.int64, device=descs.device)
    ar = torch.arange(K, device=descs.device)
    offset = 0
    for level in range(levels):
        idx = (offset + node * K)[:, None] + ar[None, :]         # (n, K)
        c = _bits(centers[idx])                                 # (n, K, 256)
        d = a_pop + c.sum(-1) - 2.0 * torch.einsum("nb,nkb->nk", a, c)
        if valid is not None:
            d = d + 1024.0 * (1.0 - valid[idx])
        node = node * K + torch.argmin(d, dim=-1)
        offset += K ** (level + 1)
    return node


@dataclasses.dataclass
class Vocabulary:
    branching: int
    levels: int
    centers: np.ndarray       # (n_internal_nodes_padded, 8) packed by level
    word_weights: np.ndarray  # (n_words,) idf
    # Non-complete trees (ingested DBoW2 vocabularies, place/orbvoc.py):
    # `valid` masks the complete-array slots that hold a real node, and
    # `leaf_word` maps bottom-level slots to DBoW2 word ids. None for
    # self-trained vocabularies, whose trees are complete by construction.
    valid: np.ndarray | None = None       # (n_nodes,) float32/bool
    leaf_word: np.ndarray | None = None   # (K**L,) int32, -1 = no word

    @property
    def n_words(self) -> int:
        return len(self.word_weights)

    # ------------------------------------------------------------------
    @staticmethod
    def train(
        descriptors: np.ndarray, branching: int = 8, levels: int = 3,
        iters: int = 8, seed: int = 0, device="cpu",
    ) -> "Vocabulary":
        """Hierarchical k-medians over binary descriptors (host); the idf
        weights come from the training set's words, assigned on `device`."""
        rng = np.random.default_rng(seed)
        K, L = branching, levels
        n_nodes = sum(K ** (l + 1) for l in range(L))
        centers = np.zeros((n_nodes, 8), np.uint32)

        def kmedians(data):
            if len(data) == 0:
                return np.zeros((K, 8), np.uint32), [np.empty(0, np.int64)] * K
            init = data[rng.choice(len(data), min(K, len(data)), replace=False)]
            cents = np.zeros((K, 8), np.uint32)
            cents[: len(init)] = init
            for _ in range(iters):
                d = _hamming_np(data, cents)
                assign = d.argmin(axis=1)
                for k in range(K):
                    members = data[assign == k]
                    if len(members):
                        cents[k] = _bit_median(members)
            d = _hamming_np(data, cents)
            assign = d.argmin(axis=1)
            groups = [np.nonzero(assign == k)[0] for k in range(K)]
            return cents, groups

        # breadth-first training
        offset = 0
        frontier = [descriptors]
        for level in range(L):
            next_frontier = []
            for node_data in frontier:
                cents, groups = kmedians(node_data)
                centers[offset : offset + K] = cents
                offset += K
                next_frontier.extend(
                    node_data[g] if len(node_data) else node_data for g in groups
                )
            frontier = next_frontier

        voc = Vocabulary(K, L, centers, np.ones(K**L, np.float32))
        # idf weights from the training set
        words = voc.assign_words(descriptors, device)
        counts = np.bincount(words, minlength=voc.n_words).astype(np.float32)
        n = max(len(descriptors), 1)
        voc.word_weights = np.log(n / np.maximum(counts, 1.0)).astype(np.float32)
        return voc

    def save(self, path: str):
        extras = {}
        if self.valid is not None:
            extras["valid"] = self.valid
            extras["leaf_word"] = self.leaf_word
        np.savez_compressed(
            path, branching=self.branching, levels=self.levels,
            centers=self.centers, word_weights=self.word_weights, **extras,
        )

    @staticmethod
    def load(path: str) -> "Vocabulary":
        data = np.load(path)
        return Vocabulary(
            int(data["branching"]), int(data["levels"]),
            np.asarray(data["centers"]), np.asarray(data["word_weights"]),
            np.asarray(data["valid"]) if "valid" in data else None,
            np.asarray(data["leaf_word"]) if "leaf_word" in data else None,
        )

    @staticmethod
    def load_any(path: str) -> "Vocabulary":
        """Load a vocabulary by extension: .npz (this framework's trained
        format) or DBoW2 ORBvoc .bin/.txt (the reference's pretrained
        vocabulary, System.cc:76-87; requires ORBParams(pattern="reference")
        for matching descriptor bits)."""
        if path.endswith(".bin") or path.endswith(".txt"):
            from .orbvoc import load_orbvoc

            return load_orbvoc(path)
        return Vocabulary.load(path)

    # ------------------------------------------------------------------
    def _device_tree(self, device: torch.device):
        """Device-resident centres / valid mask, cached across queries: the
        reference-scale tree is ~36 MB (10^6 words), which a per-keyframe
        upload would pay again and again. Keyed on the numpy array's
        identity (centres never mutate after construction; word_weights
        may) and on the device."""
        cache = getattr(self, "_dev", None)
        if cache is None or cache[0] is not self.centers or cache[1] != device:
            cents = torch.from_numpy(np.ascontiguousarray(self.centers).view(np.int32)).to(device)
            val = (
                torch.from_numpy(np.asarray(self.valid, np.float32)).to(device)
                if self.valid is not None else None
            )
            cache = (self.centers, device, cents, val)
            self._dev = cache
        return cache[2], cache[3]

    def assign_words(self, descriptors, device=None) -> np.ndarray:
        """(N, 8) descriptors -> (N,) word ids. `descriptors` is a uint32
        array (descended on `device`, default the CPU) or an int32 tensor
        (descended where it lies)."""
        if not isinstance(descriptors, torch.Tensor):
            d = np.ascontiguousarray(descriptors, np.uint32).view(np.int32)
            descriptors = torch.from_numpy(d).to(torch.device("cpu" if device is None else device))
        cents, val = self._device_tree(descriptors.device)
        leaves = _descend(descriptors, cents, val, self.branching, self.levels).cpu().numpy()
        if self.valid is None:
            return leaves.astype(np.int32)
        return self.leaf_word[leaves]

    def bow_vector(self, descriptors, valid=None, device=None) -> "BowVector":
        """Sparse tf-idf BoW vector, L1-normalised."""
        words = self.assign_words(descriptors, device)
        if valid is not None:
            words = words[np.asarray(valid) > 0]
        uniq, counts = np.unique(words, return_counts=True)
        w = counts.astype(np.float32) * self.word_weights[uniq]
        s = w.sum()
        if s > 0:
            w /= s
        return BowVector(uniq.astype(np.int64), w)

    @staticmethod
    def score(a, b) -> float:
        """DBoW2 L1 score in [0, 1]: 1 - 0.5*||a - b||_1 =
        sum min(a_i, b_i) for L1-normalised vectors."""
        if isinstance(a, BowVector):
            common, ia, ib = np.intersect1d(
                a.words, b.words, assume_unique=True, return_indices=True
            )
            if len(common) == 0:
                return 0.0
            return float(np.minimum(a.weights[ia], b.weights[ib]).sum())
        return float(1.0 - 0.5 * np.abs(a - b).sum())


@dataclasses.dataclass
class BowVector:
    """Sparse L1-normalised tf-idf image signature."""
    words: np.ndarray     # (K,) sorted unique word ids
    weights: np.ndarray   # (K,) float32, sums to 1


class KeyFrameDatabase:
    """Inverted-file loop / relocalization candidate store (reference
    KeyFrameDatabase.cc): a word -> keyframes index prunes candidates to
    those sharing vocabulary with the query, then the reference's
    common-word gate (>= 0.8 * max shared words, DetectLoopCandidates)
    bounds the scoring set. Ties in score keep the order in which the
    shared-word dict was filled, as in the JAX package."""

    def __init__(self, voc: Vocabulary):
        self.voc = voc
        self.vectors: dict[int, BowVector] = {}
        self.inverted: dict[int, set[int]] = {}     # word -> kf ids

    def add(self, kf_id: int, bow: BowVector):
        self.vectors[kf_id] = bow
        for w in bow.words:
            self.inverted.setdefault(int(w), set()).add(kf_id)

    def erase(self, kf_id: int):
        bow = self.vectors.pop(kf_id, None)
        if bow is not None:
            for w in bow.words:
                s = self.inverted.get(int(w))
                if s is not None:
                    s.discard(kf_id)

    def query(
        self, bow: BowVector, min_score: float, exclude: set[int]
    ) -> list[tuple[int, float]]:
        """(kf_id, score) candidates above min_score, best first."""
        shared: dict[int, int] = {}
        for w in bow.words:
            for kf_id in self.inverted.get(int(w), ()):
                if kf_id not in exclude:
                    shared[kf_id] = shared.get(kf_id, 0) + 1
        if not shared:
            return []
        min_common = 0.8 * max(shared.values())
        out = []
        for kf_id, n in shared.items():
            if n < min_common:
                continue
            s = Vocabulary.score(bow, self.vectors[kf_id])
            if s >= min_score:
                out.append((kf_id, s))
        out.sort(key=lambda t: -t[1])
        return out
