"""Small SPD solves, batched over leading axes (port of ``ops/linalg.py``).

The dynamics solve one small SPD system per env: the 6x6 base block of the
ABA step, the nv x nv joint-space matrix of the CRBA engine.  The unrolled
factorization works column by column on ``[...]`` tensors, one elementwise op
per entry, with its sums in index order: the same order as the base lane of
the CUDA kernel (``csrc/physics_step.cu``), whose plain version calls it.
"""
from __future__ import annotations

import torch


def _factor(A: torch.Tensor):
    """Lower Cholesky factor of ``A`` [..., n, n] as a list of rows of
    ``[...]`` tensors (pivots floored at 1e-12 before the square root)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        acc = A[..., j, j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(acc.clamp(min=1e-12))
        for i in range(j + 1, n):
            acc = A[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc / L[j][j]
    return L


def _lower(L, b: torch.Tensor):
    """Forward substitution on factor rows ``L``: the list of y_i."""
    y = []
    for i in range(len(L)):
        acc = b[..., i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y.append(acc / L[i][i])
    return y


def _upper_T(L, y):
    """Back substitution L^T x = y on factor rows ``L``: the list of x_i."""
    n = len(L)
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return x


def _rows(L: torch.Tensor):
    n = L.shape[-1]
    return [[L[..., i, j] for j in range(n)] for i in range(n)]


def cholesky_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of SPD matrices ``A`` [..., n, n]."""
    n = A.shape[-1]
    L = _factor(A)
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(n)], -1)
                        for i in range(n)], -2)


def solve_tri_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L y = b for ``L`` [..., n, n], ``b`` [..., n]."""
    return torch.stack(_lower(_rows(L), b), -1)


def solve_tri_upper_T(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Back substitution L^T x = y."""
    return torch.stack(_upper_T(_rows(L), list(y.unbind(-1))), -1)


def cho_solve_unrolled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD ``A`` [..., n, n] by the unrolled Cholesky."""
    L = _factor(A)
    return torch.stack(_upper_T(L, _lower(L, b)), -1)


def spd_solve(A: torch.Tensor, b: torch.Tensor, method: str = "unrolled") -> torch.Tensor:
    """SPD solve by the unrolled Cholesky, or (any other ``method``) by
    ``torch.linalg``'s factorization."""
    if method == "unrolled":
        return cho_solve_unrolled(A, b)
    return torch.cholesky_solve(b[..., None], torch.linalg.cholesky(A))[..., 0]
