"""The detectors' transposed convolutions against the JAX package's
substitute for them, for the JAX-parity tests.

The port runs mmdet's layer: a transposed convolution whose kernel equals
its stride k, with mmdet's (in, out, k, k) weights. The JAX package runs a
nearest k-x resize followed by a SAME convolution with an (out, in, 3, 3)
kernel (ROADMAP R12). The two agree where the transposed kernel is the same
at every phase (each input pixel then writes one value to its whole k x k
block: a nearest resize and a 1x1 convolution) and the substitute's kernel
is that 1x1 kernel at the centre of its 3x3 with zeros around it. The
parity tests hold JAX on every other layer through such weights, and the
tests of tests/test_torch_detect_reference.py hold the general layer to the
plain reference.
"""

from __future__ import annotations

import copy

import numpy as np

DECONV_KEYS = ("mask_deconv", "deblocks")


def _nodes(tree):
    """The {"w", "b"} nodes of the transposed convolutions in a tree."""
    for key in DECONV_KEYS:
        if key in tree:
            node = tree[key]
            yield from (node if isinstance(node, list) else [node])


def phase_constant(np_params: dict) -> dict:
    """A copy of a numpy parameter tree whose transposed kernels repeat
    their first phase at every phase."""
    out = copy.deepcopy(np_params)
    for node in _nodes(out):
        w = node["w"]
        node["w"] = np.ascontiguousarray(np.broadcast_to(w[:, :, :1, :1], w.shape))
    return out


def centre_kernel(w: np.ndarray) -> np.ndarray:
    """A phase-constant (in, out, k, k) kernel as the substitute's (out, in, 3, 3)."""
    out = np.zeros((w.shape[1], w.shape[0], 3, 3), w.dtype)
    out[:, :, 1, 1] = w[:, :, 0, 0].T
    return out


def jax_tree(np_params: dict) -> dict:
    """The JAX package's tree for a phase-constant port tree: each
    transposed kernel as the substitute's centre kernel."""
    out = copy.deepcopy(np_params)
    for node in _nodes(out):
        node["w"] = centre_kernel(node["w"])
    return out


def split(np_params: dict) -> tuple[dict, dict]:
    """(the port's phase-constant numpy tree, the JAX package's tree)."""
    port = phase_constant(np_params)
    return port, jax_tree(port)


def is_deconv(path) -> bool:
    """Whether a tree path (jax.tree_util keys) ends at a transposed kernel."""
    keys = [getattr(k, "key", None) for k in path]
    return keys[-1] == "w" and any(k in DECONV_KEYS for k in keys)


def centre_grad(g: np.ndarray) -> np.ndarray:
    """The port's gradient of a transposed kernel (in, out, k, k) as the
    gradient of the substitute's centre tap (out, in): the sum over the
    phases that share it."""
    return np.asarray(g).sum(axis=(2, 3)).T
