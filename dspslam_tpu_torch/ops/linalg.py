"""Small dense solves in elementwise ops only, for CUDA graphs.

cuSOLVER's small solves (`solve_ex`, `cholesky_ex` + `cholesky_solve`,
`inv_ex`) capture in a CUDA graph, but on an H100 a replay holding one held
the host for most of the replay. These take the same answers from
elementwise ops and products, which a graph holds without a host wait.
Eagerly they cost more host time than the library's, so the CPU and eager
callers keep the library's.
"""

from __future__ import annotations

import torch


def cholesky_solve_spd(H, b):
    """x = H^-1 b for a symmetric positive definite (n, n) H, in elementwise
    ops only: a right-looking Cholesky of the bordered matrix [H; b^T],
    whose n columns come out as [L; y^T] with L L^T = H and L y = b, then
    L^T x = y backwards. No library solver and no host sync: on an H100,
    cuSOLVER's 6 x 6 solves (`solve_ex`, `cholesky_ex` + `cholesky_solve`)
    inside a CUDA graph held the host for the whole replay."""
    n = H.shape[-1]
    M = torch.cat([H, b[None]], 0)                                   # (n + 1, n)
    lower = torch.ones(n + 1, n, dtype=torch.bool, device=H.device).tril()
    cols = []
    for k in range(n):
        col = M[:, k] * (lower[:, k] * torch.rsqrt(M[k, k]))
        M = torch.addr(M, col, col[:n], alpha=-1)
        cols.append(col)
    L = torch.stack(cols, 1)
    r, xs = L[n], [None] * n
    for k in reversed(range(n)):
        xs[k] = r[k] / L[k, k]
        r = r - L[k] * xs[k]
    return torch.stack(xs)


def inv3(A):
    """Inverse of each symmetric positive definite (..., 3, 3) block by a
    closed-form Cholesky, elementwise over the batch: A = L L^T, M = L^-1
    from L's entries, A^-1 = M^T M. Backward stable as `inv_ex`'s pivoted
    LU is (the adjugate over the determinant is not: its cofactors cancel).
    Each pivot is floored at eps times its diagonal entry, the rounding
    level of its subtraction: a block singular to the dtype (in BA, a point
    seen along a single ray at the LM's smallest damping) stays finite and
    positive, where `inv_ex` returns rounding noise; no other block moves."""
    eps = torch.finfo(A.dtype).eps
    a00, a10, a11, a20, a21, a22 = (A[..., i, j] for i, j in ((0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2)))
    l00 = torch.sqrt(a00)
    l10, l20 = a10 / l00, a20 / l00
    l11 = torch.sqrt(torch.maximum(a11 - l10 * l10, eps * a11))
    l21 = (a21 - l20 * l10) / l11
    l22 = torch.sqrt(torch.maximum(a22 - l20 * l20 - l21 * l21, eps * a22))
    m00, m11, m22 = 1.0 / l00, 1.0 / l11, 1.0 / l22
    m10 = -l10 * m00 * m11
    m21 = -l21 * m11 * m22
    m20 = -(l20 * m00 + l21 * m10) * m22
    zero = torch.zeros_like(m00)
    M = torch.stack([m00, zero, zero, m10, m11, zero, m20, m21, m22], -1).reshape(A.shape)
    return M.transpose(-1, -2) @ M
