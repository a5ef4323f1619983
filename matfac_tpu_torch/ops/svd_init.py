"""Truncated SVD factor initialization (port of matfac_tpu/ops/svd_init.py).

The reference's SVDLIBC Lanczos wrapper (svdFrmSvdlibCSREig,
svdFrmsvdlib.cpp:69-134, and the binary-pattern variant
svdFrmSvdlibCSRSparsityEig, :202-262) becomes a randomized
subspace-iteration SVD: the sparse products are COO segment sums
(``index_add_``), the rest dense QR and SVD on the matrix's device. JAX
computes the same with XLA; there is no Pallas kernel here.

Returns (u_fac, i_fac, singular_vals) as host arrays; ``pure_svd=True``
scales the item factors by the singular values (the reference's pureSVD
mode), ``sparsity_only=True`` factorizes the 0/1 pattern. Singular vectors
are defined up to sign: torch and JAX may return opposite signs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from matfac_tpu_torch.data.csr import RatingMatrix


def randomized_svd_coo(rows: torch.Tensor, cols: torch.Tensor,
                       vals: torch.Tensor, omega: torch.Tensor,
                       n_rows: int, n_cols: int, n_iter: int):
    """Randomized range-finder SVD of the sparse A given as COO:
    A X = segment sum over rows of vals * X[cols], A^T Y = segment sum
    over cols of vals * Y[rows]. Returns (U, S, V) with A ~ U S V^T."""
    r = omega.shape[1]

    def a_mm(x):        # [n_cols, r] -> [n_rows, r]
        out = torch.zeros(n_rows, r, dtype=x.dtype, device=x.device)
        return out.index_add_(0, rows, vals[:, None] * x[cols])

    def at_mm(y):       # [n_rows, r] -> [n_cols, r]
        out = torch.zeros(n_cols, r, dtype=y.dtype, device=y.device)
        return out.index_add_(0, cols, vals[:, None] * y[rows])

    y = a_mm(omega)
    for _ in range(n_iter):
        y = torch.linalg.qr(y).Q
        z = torch.linalg.qr(at_mm(y)).Q
        y = a_mm(z)
    q = torch.linalg.qr(y).Q                     # [n_rows, r]
    b = at_mm(q)                                 # [n_cols, r] = (Q^T A)^T
    ub, s, vt = torch.linalg.svd(b.t(), full_matrices=False)
    return q @ ub, s, vt.t()


def svd_init(mat: RatingMatrix, rank: int, pure_svd: bool = False,
             sparsity_only: bool = False, seed: int = 0, n_iter: int = 6,
             oversample: int = 8, omega: Optional[np.ndarray] = None,
             device="cuda") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rank-``rank`` truncated SVD of the rating matrix: (u_fac [nrows,
    rank], i_fac [ncols, rank], singular_vals [rank]) as f32 host arrays,
    uFac = left singular vectors, iFac = right ones (times S if
    ``pure_svd``). ``omega`` [ncols, min(rank + oversample, nrows, ncols)]
    is the random test matrix; None draws it from a generator on
    ``device`` seeded by ``seed``."""
    dev = torch.device(device)
    r, c, v = mat.to_coo()
    if sparsity_only:
        v = np.ones_like(v)
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(
        a.astype(dt))).to(dev)
    rr = min(rank + oversample, min(mat.nrows, mat.ncols))
    if omega is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        omega_t = torch.randn(mat.ncols, rr, generator=gen, device=dev)
    else:
        omega_t = as_t(np.asarray(omega), np.float32)
    u, s, vmat = randomized_svd_coo(as_t(r, np.int64), as_t(c, np.int64),
                                    as_t(v, np.float32), omega_t, mat.nrows,
                                    mat.ncols, n_iter)
    u = u[:, :rank].cpu().numpy()
    s = s[:rank].cpu().numpy()
    vmat = vmat[:, :rank].cpu().numpy()
    if pure_svd:
        vmat = vmat * s[None, :]
    return (u.astype(np.float32), vmat.astype(np.float32),
            s.astype(np.float32))
