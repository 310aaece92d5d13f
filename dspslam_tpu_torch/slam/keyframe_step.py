"""Per-keyframe device program: triangulation + duplicate fusion.

Port of dspslam_tpu/slam/keyframe_step.py, the keyframe path of the
reference's LocalMapping thread (LocalMapping.cc:55-140): descriptor
matching against up to two covisible neighbours, batched two-view DLT
triangulation with cheirality and reprojection gates, and duplicate fusion
by projecting the neighbours' map points into the new keyframe, all as one
sequence of tensor ops with no host sync; the host only mints MapPoint
objects from the pre-validated slots.

The DLT needs the eigenvector of the smallest eigenvalue of each (4, 4)
AᵀA. `torch.linalg.eigh` checks its solver's status on the host (a sync),
so the eigenvectors come from a fixed number of cyclic Jacobi sweeps in
plain tensor ops instead. X[:3] / w does not depend on the vector's sign.
AᵀA squares the rows' pixel-scale condition: in float32 the point moves by
up to ~6e-3 of its distance (the JAX package's f32 eigh, ROADMAP §3), so
the projection matrices, rows, product and sweeps run in float64 and only
the point returns in f32.
"""

from __future__ import annotations

import torch

from ..frontend import matcher

FUSE_CAP = 2048
MAX_NEIGHBORS = 2
JACOBI_SWEEPS = 8
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _projection_matrix(intrinsics, T_cw):
    """K @ T_cw[:3] from [fx, fy, cx, cy, ...] without host copies."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([
        torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]), torch.stack([zero, zero, one]),
    ])
    return K @ T_cw[:3, :]


def smallest_eigenvector(A: torch.Tensor, sweeps: int = JACOBI_SWEEPS) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of each symmetric (N, 4, 4)
    matrix, by `sweeps` cyclic Jacobi sweeps (Golub & Van Loan 8.5)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    # J = I + (c - 1) (e_p e_p' + e_q e_q') + s (e_p e_q' - e_q e_p'), built
    # from rows of the identity on the device (a scalar written into a CUDA
    # tensor would be a host-to-device copy, which synchronises)
    planes = []
    for p, q in _PAIRS:
        ep, eq = eye[p], eye[q]
        planes.append((p, q, torch.outer(ep, ep) + torch.outer(eq, eq),
                       torch.outer(ep, eq) - torch.outer(eq, ep)))
    V = eye.expand_as(A).clone()
    for _ in range(sweeps):
        for p, q, cos_part, sin_part in planes:
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
            nz = apq != 0
            tau = (aqq - app) / (2.0 * torch.where(nz, apq, torch.ones_like(apq)))
            sgn = torch.where(tau >= 0, 1.0, -1.0)
            t = torch.where(nz, sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau)), 0.0)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            J = eye + (c - 1.0)[:, None, None] * cos_part + (t * c)[:, None, None] * sin_part
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    k = torch.argmin(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
    return torch.gather(V, 2, k[:, None, None].expand(-1, n, 1))[..., 0]


def _triangulate_batch(P1, P2, x1, x2):
    """Batched two-view DLT (Initializer.cc triangulation): rows u*P3-P1,
    v*P3-P2 per view; X = the smallest right singular vector of A. P1 / P2
    are float64 (3, 4) projection matrices shared by all N pairs."""
    def rows(P, x):
        return torch.stack([x[:, 0:1] * P[2][None, :] - P[0][None, :],
                            x[:, 1:2] * P[2][None, :] - P[1][None, :]], dim=1)

    A = torch.cat([rows(P1, x1.double()), rows(P2, x2.double())], dim=1)   # (N, 4, 4)
    X = smallest_eigenvector(torch.einsum("nij,nik->njk", A, A))
    w = X[:, 3]
    ok_w = torch.abs(w) > 1e-8
    X3 = X[:, :3] / torch.where(ok_w, w, torch.ones_like(w))[:, None]
    return X3.to(x1.dtype), ok_w


def keyframe_matching(kf_feats: dict, kf_T_cw, kf_has_pt, kf_depth_pos, nb_feats_list,
                      nb_T_cw, nb_has_pt, nb_ok, fuse_pos, fuse_valid, fuse_desc, fuse_level,
                      intrinsics, fuse_radius: float = 3.0) -> dict:
    """Per-neighbour triangulation proposals + fusion matches.

    kf_feats: the new keyframe's features (N slots); kf_T_cw (4, 4);
    kf_has_pt / kf_depth_pos (N,) 1.0 where the keypoint already has a map
    point / stereo depth; nb_feats_list: MAX_NEIGHBORS feature dicts (empty
    slots carry the keyframe's own, masked by nb_ok = 0); nb_T_cw (M, 4, 4);
    nb_has_pt (M, N); nb_ok (M,); fuse_pos / fuse_valid / fuse_desc /
    fuse_level: (C, ...) neighbour map points to fuse; intrinsics (5,).
    Returns dict(tri_idx (M, N), tri_X (M, N, 3), tri_ok (M, N), fuse_idx
    (C,), fuse_dist (C,)).
    """
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    width, height = 2.0 * cx, 2.0 * cy
    intr64 = intrinsics.double()
    P_kf = _projection_matrix(intr64, kf_T_cw.double())

    def reproj_ok(T, X, xy):
        pc = X @ T[:3, :3].T + T[:3, 3]
        z = torch.clamp(pc[:, 2], min=1e-6)
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        err2 = (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2
        return (pc[:, 2] > 0.05) & (err2 < 5.991 * 2.0)

    tri_idx, tri_X, tri_ok = [], [], []
    for i, nb_f in enumerate(nb_feats_list):
        nb_T = nb_T_cw[i]
        idx, _ = matcher.match_features(kf_feats, nb_f, max_dist=50)
        safe = torch.clamp(idx, min=0).to(torch.int64)
        cand = (idx >= 0) & (kf_has_pt < 0.5) & (kf_depth_pos < 0.5) & (nb_has_pt[i][safe] < 0.5)
        nb_xy = nb_f["xy"][safe]
        X, ok_w = _triangulate_batch(P_kf, _projection_matrix(intr64, nb_T.double()), kf_feats["xy"], nb_xy)
        good = (cand & ok_w & reproj_ok(kf_T_cw, X, kf_feats["xy"]) & reproj_ok(nb_T, X, nb_xy)
                & (nb_ok[i] > 0.5))
        tri_idx.append(idx)
        tri_X.append(X)
        tri_ok.append(good)

    # duplicate fusion: project neighbour points into the new keyframe
    pc = fuse_pos @ kf_T_cw[:3, :3].T + kf_T_cw[:3, 3]
    z = torch.clamp(pc[:, 2], min=1e-6)
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    in_img = (pc[:, 2] > 0.1) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    fuse_idx, fuse_dist = matcher.match_by_projection(
        torch.stack([u, v], dim=-1), fuse_valid * in_img, fuse_desc, torch.zeros_like(fuse_level),
        kf_feats, radius=fuse_radius, max_dist=matcher.TH_LOW, ratio=None,
    )
    return {"tri_idx": torch.stack(tri_idx), "tri_X": torch.stack(tri_X), "tri_ok": torch.stack(tri_ok),
            "fuse_idx": fuse_idx, "fuse_dist": fuse_dist}
