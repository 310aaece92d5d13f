"""Shape-code -> triangle mesh extraction.

Port of dspslam_tpu/shape/mesh.py: decode the DeepSDF field on a voxel
grid on the decoder's device (chunked forward passes) and extract the
zero isosurface on the host with marching tetrahedra (host numpy, copied
from the JAX package): each grid cube is split into 6 tetrahedra around
the 0-6 diagonal, per-tet sign cases come from a 16-case table, vertices
are linearly interpolated on cut edges, windings are oriented by the SDF
gradient so normals point outward, and vertices are welded.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Voxel grid decode


def create_voxel_grid(vol_dim: int = 64) -> np.ndarray:
    """(vol_dim^3, 3) query points on [-1, 1]^3, x slowest / z fastest:
    reshape(D, D, D) yields axes (x, y, z)."""
    lin = np.linspace(-1.0, 1.0, vol_dim, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.stack([x, y, z], axis=-1).reshape(-1, 3)


def decode_sdf_grid(decoder, code: torch.Tensor, vol_dim: int,
                    chunk: int = 64**3) -> torch.Tensor:
    """SDF on a vol_dim^3 grid -> (vol_dim, vol_dim, vol_dim), decoded in
    chunks of at most `chunk` points on the code's device."""
    pts = torch.from_numpy(create_voxel_grid(vol_dim)).to(code.device)
    L = code.shape[0]
    out = []
    for start in range(0, pts.shape[0], chunk):
        p = pts[start:start + chunk]
        out.append(decoder(torch.cat([code.expand(p.shape[0], L), p], dim=-1)))
    return torch.cat(out).reshape(vol_dim, vol_dim, vol_dim)


# ---------------------------------------------------------------------------
# Host-side marching tetrahedra

# 6-tet decomposition of a cube around the 0-6 diagonal. Cube corners are
# indexed by binary (x, y, z) offsets: corner k = (k>>2 & 1, k>>1 & 1, k & 1).
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.int64
)
# corners 0 and 7 are the main diagonal (000 -> 111)
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
     [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], dtype=np.int64
)
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)


def _build_tet_table() -> np.ndarray:
    """(16, 2, 3) triangle table: per sign-case, up to two triangles given
    as indices into _TET_EDGES; -1 padding."""
    edge_id = {frozenset(map(int, e)): i for i, e in enumerate(_TET_EDGES)}
    table = np.full((16, 2, 3), -1, dtype=np.int64)
    for case in range(1, 15):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if not case >> i & 1]
        if len(inside) == 1:
            v = inside[0]
            table[case, 0] = [edge_id[frozenset((v, o))] for o in outside]
        elif len(inside) == 3:
            v = outside[0]
            table[case, 0] = [edge_id[frozenset((v, i))] for i in inside]
        else:
            a, b = inside
            c, d = outside
            e_ac, e_ad = edge_id[frozenset((a, c))], edge_id[frozenset((a, d))]
            e_bc, e_bd = edge_id[frozenset((b, c))], edge_id[frozenset((b, d))]
            # quad perimeter AC -> AD -> BD -> BC, fanned from AC
            table[case, 0] = [e_ac, e_ad, e_bd]
            table[case, 1] = [e_ac, e_bd, e_bc]
    return table


_TET_TABLE = _build_tet_table()


def marching_tetrahedra(sdf: np.ndarray, level: float = 0.0):
    """Extract the `level` isosurface of a (D, D, D) scalar field.

    Returns (vertices (V, 3) float32 in [-1, 1]^3 grid coordinates,
    faces (F, 3) int32) with outward-oriented normals (toward sdf > level).
    """
    sdf = np.asarray(sdf, np.float32)
    D = sdf.shape[0]
    spacing = 2.0 / (D - 1)

    # all cube base indices
    base = np.stack(
        np.meshgrid(*([np.arange(D - 1)] * 3), indexing="ij"), axis=-1
    ).reshape(-1, 3)                                             # (C, 3)
    corner_idx = base[:, None, :] + _CUBE_CORNERS[None, :, :]     # (C, 8, 3)
    corner_val = sdf[
        corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]
    ]                                                             # (C, 8)

    verts_out = []
    for tet in _TETS:
        vals = corner_val[:, tet]                                 # (C, 4)
        pos = corner_idx[:, tet, :].astype(np.float32)            # (C, 4, 3)
        case = ((vals < level) << np.arange(4)).sum(axis=-1)      # (C,)
        active = (case > 0) & (case < 15)
        if not active.any():
            continue
        vals_a, pos_a, case_a = vals[active], pos[active], case[active]
        tris = _TET_TABLE[case_a]                                 # (A, 2, 3)
        for t in range(2):
            edge_ids = tris[:, t, :]                              # (A, 3)
            has_tri = edge_ids[:, 0] >= 0
            if not has_tri.any():
                continue
            e = edge_ids[has_tri]                                 # (M, 3)
            v4, p4 = vals_a[has_tri], pos_a[has_tri]
            ends = _TET_EDGES[e]                                  # (M, 3, 2)
            va = np.take_along_axis(v4, ends[..., 0], axis=1)     # (M, 3)
            vb = np.take_along_axis(v4, ends[..., 1], axis=1)
            ta = (level - va) / np.where(vb - va == 0, 1e-12, vb - va)
            ta = np.clip(ta, 0.0, 1.0)[..., None]
            pa = np.take_along_axis(p4, ends[..., 0][..., None], axis=1)
            pb = np.take_along_axis(p4, ends[..., 1][..., None], axis=1)
            verts_out.append(pa + ta * (pb - pa))                 # (M, 3, 3)

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    tri_verts = np.concatenate(verts_out, axis=0)                 # (T, 3, 3)

    # orient windings by the field gradient at the triangle centroid
    grad = np.stack(np.gradient(sdf), axis=-1)                    # (D, D, D, 3)
    centroid = tri_verts.mean(axis=1)
    ci = np.clip(np.round(centroid).astype(np.int64), 0, D - 1)
    g = grad[ci[:, 0], ci[:, 1], ci[:, 2]]                        # (T, 3)
    n = np.cross(
        tri_verts[:, 1] - tri_verts[:, 0], tri_verts[:, 2] - tri_verts[:, 0]
    )
    flip = (n * g).sum(-1) < 0
    tri_verts[flip] = tri_verts[flip][:, ::-1, :]

    # weld vertices
    flat = tri_verts.reshape(-1, 3)
    keys = np.round(flat / spacing * 1024.0).astype(np.int64)
    _, first, inv = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    vertices = flat[first]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces produced by welding
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # grid index space -> object coordinates in [-1, 1]^3
    vertices = vertices * spacing - 1.0
    return vertices.astype(np.float32), faces


class MeshExtractor:
    """Code -> mesh, mirroring the reference MeshExtractor API."""

    def __init__(self, decoder, code_len: int = 64, voxels_dim: int = 64,
                 device=None):
        self.decoder = decoder
        self.code_len = code_len
        self.voxels_dim = voxels_dim
        self.device = device

    def extract_mesh_from_code(self, code):
        code = torch.as_tensor(code, dtype=torch.float32, device=self.device)
        sdf = decode_sdf_grid(self.decoder, code[: self.code_len], self.voxels_dim)
        vertices, faces = marching_tetrahedra(sdf.cpu().numpy(), 0.0)
        return {"vertices": vertices, "faces": faces}
