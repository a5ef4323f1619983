"""Synthetic rating matrices: the generators of matfac_tpu/data/synthetic.py
that the port calls, copied (tests/test_torch_data.py holds them to the
originals on the same seeds).

The reference's ground-truth workflow (python/genLatFacs.py:16-35 —
SVD-orthogonalized scaled random factors used as a known low-rank model)
plus a power-law rating-matrix sampler for tests and benchmarks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from matfac_tpu_torch.data.csr import RatingMatrix


def gen_latent_factors(n: int, k: int, scale: float, seed: int) -> np.ndarray:
    """genLatFacs.py analog: orthonormal columns (via SVD of a Gaussian
    matrix) scaled by ``scale``."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, k))
    u, _, _ = np.linalg.svd(g, full_matrices=False)
    return (u * scale).astype(np.float32)


def low_rank_ratings(n_users: int, n_items: int, k: int, density: float,
                     seed: int, noise: float = 0.0,
                     scale: float = 3.0,
                     power_law: float = 0.0,
                     nonneg: bool = False,
                     stars: bool = False
                     ) -> Tuple[RatingMatrix, np.ndarray, np.ndarray]:
    """Sample observed entries of a known low-rank matrix.

    ``power_law > 0`` skews item popularity ~ Zipf(power_law) to reproduce
    the long-tail regime the WWW'19 models target. ``nonneg`` makes the
    factors (hence ratings) positive — the MovieLens-like regime the
    reference ALS path assumes (its rating>0 gate, modelMF.cpp:820).
    ``stars`` quantile-quantizes values to 1-5 stars with MovieLens'
    approximate star histogram (5.6/10.7/26.1/34.9/22.6%).
    Returns (mat, uFac, iFac) with mat values = uFac @ iFac.T + noise.
    """
    rng = np.random.default_rng(seed)
    u_fac = gen_latent_factors(n_users, k, np.sqrt(scale), seed)
    i_fac = gen_latent_factors(n_items, k, np.sqrt(scale) * n_items /
                               max(n_users, 1) ** 0.5, seed + 1)
    if nonneg:
        u_fac = np.abs(u_fac)
        i_fac = np.abs(i_fac)
    # rescale so typical |rating| ~ scale
    norm = np.abs(u_fac @ i_fac[: min(128, n_items)].T).mean() + 1e-9
    i_fac *= scale / norm

    nnz = int(density * n_users * n_items)
    if power_law > 0:
        w = 1.0 / np.arange(1, n_items + 1) ** power_law
        w /= w.sum()
        cols = rng.choice(n_items, size=nnz, p=w)
    else:
        cols = rng.integers(0, n_items, size=nnz)
    rows = rng.integers(0, n_users, size=nnz)
    # dedupe (u, i) pairs
    key = rows.astype(np.int64) * n_items + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    vals = np.einsum("ek,ek->e", u_fac[rows], i_fac[cols])
    if noise > 0:
        vals = vals + noise * rng.standard_normal(len(vals))
    if stars:
        # quantile map to 1..5 with the ML-like star mass
        hist = np.array([0.056, 0.107, 0.261, 0.349, 0.226])
        edges = np.quantile(vals, np.cumsum(hist)[:-1])
        vals = (np.digitize(vals, edges) + 1).astype(np.float64)
    mat = RatingMatrix.from_coo(rows, cols, vals.astype(np.float32),
                                n_users, n_items)
    return mat, u_fac, i_fac
