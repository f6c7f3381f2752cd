"""Batched 2x2/3x3 symmetric eigendecomposition and SVD.

Counterpart of ``hot_tpu.ops.svd`` with the same algorithm and conventions,
so both packages take the same rotations:

  * eigh_sym: cyclic Jacobi (one rotation for 2x2, ``sweeps`` sweeps for
    3x3) with the atan2 rotation angle, eigenvalues sorted descending
    (stable), det(Q) = +1 by flipping the last column.
  * svd: V from eigh_sym(A^T A), then Givens QR of A V; A = U diag(sigma) V^T,
    det(U) = det(V) = +1, sigma descending with sigma[-1] < 0 iff det(A) < 0.
  * polar: A = R S from the SVD, R = U V^T.

Every function takes a leading batch: (..., d, d).
"""

from __future__ import annotations

import torch


def _eye_like(S):
    d = S.shape[-1]
    return torch.eye(d, dtype=S.dtype, device=S.device).expand(S.shape).clone()


def _jacobi_rotation(app, aqq, apq):
    """(c, s) diagonalising [[app, apq], [apq, aqq]]; identity when apq ~ 0."""
    tiny = 1e-30 if apq.dtype == torch.float64 else 1e-20
    small = apq.abs() < tiny
    one = torch.ones_like(apq)
    apq_safe = torch.where(small, one, apq)
    diff_safe = torch.where(small, one, app - aqq)
    theta = torch.where(small, torch.zeros_like(apq),
                        0.5 * torch.atan2(2.0 * apq_safe, diff_safe))
    return torch.cos(theta), torch.sin(theta)


def _apply_jacobi(S, V, p, q):
    c, s = _jacobi_rotation(S[..., p, p], S[..., q, q], S[..., p, q])
    G = _eye_like(S)
    G[..., p, p] = c
    G[..., q, q] = c
    G[..., p, q] = -s
    G[..., q, p] = s
    return G.transpose(-1, -2) @ S @ G, V @ G


def eigh_sym(S, sweeps: int = 6):
    """S = Q diag(w) Q^T for symmetric (..., d, d), d in {2, 3}.

    Returns (w (..., d) descending, Q (..., d, d) with det(Q) = +1).
    """
    d = S.shape[-1]
    V = _eye_like(S)
    if d == 2:
        S, V = _apply_jacobi(S, V, 0, 1)
    elif d == 3:
        for _ in range(sweeps):
            for p, q in ((0, 1), (0, 2), (1, 2)):
                S, V = _apply_jacobi(S, V, p, q)
    else:
        raise ValueError(f"eigh_sym supports d in (2, 3); got {d}")
    w = torch.diagonal(S, dim1=-2, dim2=-1)
    perm = torch.argsort(-w, dim=-1, stable=True)
    w = torch.gather(w, -1, perm)
    Q = torch.gather(V, -1, perm.unsqueeze(-2).expand(V.shape))
    parity = _perm_parity(perm, d).to(S.dtype)
    Q[..., :, d - 1] = Q[..., :, d - 1] * parity.unsqueeze(-1)
    return w, Q


def _perm_parity(perm, d):
    """+1 / -1 parity of permutations given as index rows (..., d)."""
    if d == 2:
        return torch.where(perm[..., 0] == 0, 1, -1)
    i, j, k = perm[..., 0], perm[..., 1], perm[..., 2]
    return torch.sign((j - i) * (k - i) * (k - j))


def _givens_cs(a, b):
    """(c, s) with [c -s; s c]^T [a; b] = [r; 0]; identity when both tiny."""
    r2 = a * a + b * b
    tiny = 1e-38 if a.dtype == torch.float64 else 1e-30
    small = r2 < tiny
    inv = torch.where(small, torch.zeros_like(r2),
                      torch.rsqrt(torch.where(small, torch.ones_like(r2), r2)))
    c = torch.where(small, torch.ones_like(a), a * inv)
    s = torch.where(small, torch.zeros_like(b), b * inv)
    return c, s


def _givens_qr(B):
    """B = Q R by Givens rotations, det(Q) = +1."""
    d = B.shape[-1]
    Q = _eye_like(B)
    R = B
    pairs = [(1, 0)] if d == 2 else [(1, 0), (2, 0), (2, 1)]
    for i, j in pairs:
        c, s = _givens_cs(R[..., j, j], R[..., i, j])
        G = _eye_like(B)
        G[..., j, j] = c
        G[..., j, i] = s
        G[..., i, j] = -s
        G[..., i, i] = c
        R = G @ R
        Q = Q @ G.transpose(-1, -2)
    return Q, R


def svd(A):
    """(U, sigma, V) of (..., d, d): A = U diag(sigma) V^T (see module doc)."""
    d = A.shape[-1]
    _, V = eigh_sym(A.transpose(-1, -2) @ A)
    U, R = _givens_qr(A @ V)
    sigma = torch.diagonal(R, dim1=-2, dim2=-1)
    signs = torch.where(sigma >= 0, 1.0, -1.0).to(A.dtype)
    total = torch.prod(signs, dim=-1)
    col_signs = signs.clone()
    col_signs[..., d - 1] = signs[..., d - 1] * total
    return U * col_signs.unsqueeze(-2), sigma * col_signs, V


def polar(A):
    """Polar decomposition A = R S of (..., d, d): R = U V^T a proper
    rotation, S = V diag(sigma) V^T symmetric. With the signed-sigma SVD, S
    is indefinite for inverted A (det(A) < 0)."""
    U, sigma, V = svd(A)
    Vt = V.transpose(-1, -2)
    return U @ Vt, V @ (sigma.unsqueeze(-1) * Vt)
