"""Synthetic datasets: matfac_tpu/data/synthetic.py's generators, copied
with JAX's draw order (tests/test_torch_data.py holds them to the
originals bit for bit on the same seeds).

The reference's ground-truth workflow (python/genLatFacs.py:16-35 —
SVD-orthogonalized scaled random factors used as a known low-rank model)
plus a power-law rating-matrix sampler for tests and benchmarks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.data.dataset import Data
from matfac_tpu_torch.data.io import split_train_test_val


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


def synthetic_data(n_users: int = 200, n_items: int = 150, k: int = 5,
                   density: float = 0.2, seed: int = 7, noise: float = 0.05,
                   test_pc: float = 0.1, val_pc: float = 0.1,
                   power_law: float = 0.0, fac_dim: Optional[int] = None,
                   nonneg: bool = False, stars: bool = False
                   ) -> Tuple[Data, np.ndarray, np.ndarray]:
    """Complete Data bundle from a synthetic low-rank model."""
    mat, u_fac, i_fac = low_rank_ratings(
        n_users, n_items, k, density, seed, noise, power_law=power_law,
        nonneg=nonneg, stars=stars)
    train, test, val = split_train_test_val(mat, test_pc, val_pc, seed)
    data = Data(train_mat=train, test_mat=test, val_mat=val,
                orig_u_fac=u_fac, orig_i_fac=i_fac)
    data.fac_dim = fac_dim if fac_dim is not None else k
    return data, u_fac, i_fac


def tail_lowrank_data(n_users: int = 943, n_items: int = 1682,
                      k: int = 16, tail_rank: int = 3,
                      head_pc: float = 0.25, density: float = 0.06,
                      power_law: float = 1.1, noise: float = 0.4,
                      seed: int = 0, test_pc: float = 0.15,
                      val_pc: float = 0.15, spectrum_pow: float = 0.5,
                      tail_boost: float = 1.0
                      ) -> Tuple[Data, np.ndarray]:
    """Long-tail generator whose TAIL entities carry genuinely
    lower-rank signal — the WWW'19 premise the adaptive models exist
    for (modelDropoutSigmoid.cpp:158-191's purpose: rarely-seen
    entities cannot support full-rank estimates, so truncate them).

    Construction: item popularity ~ Zipf(power_law). The most popular
    ``head_pc`` of items get full-rank ground-truth factors; the rest
    (the tail) get factors confined to the span of the TOP
    ``tail_rank`` spectrum dims (z_i @ B with B a rotation within
    those dims) — low-rank but strong signal, shared across the whole
    tail, and CO-LOCATED with the head data's dominant directions.
    The co-location matters: suffix-truncation models (TMF's
    adapDotProd semantics) can only exploit tail structure that lives
    in the model's early/dominant dims, and the head data pins those
    to the spectrum top; a tail subspace in random orientation would
    be unrepresentable under truncation no matter how adaptive the
    rank (measured: MF wins on that variant too). Users are full-rank
    with uniform degrees, so the less-frequent entity of a pair (the
    one that sets the reference's adapDotProd rank) is effectively the
    item.
    Plain MF must spread each tail item's few ratings over all k dims;
    a frequency-adaptive model can concentrate them in the subspace.
    Returns (Data bundle, is_tail_item bool mask).
    """
    rng = np.random.default_rng(seed)
    # decaying spectrum: strong early dims, weak late dims. The decay
    # steepness (spectrum_pow) controls how strongly the head data
    # orders the learned dims — the alignment pressure truncation
    # models need (see above)
    spectrum = (1.0 / np.arange(1, k + 1) ** spectrum_pow
                ).astype(np.float32)
    u_fac = (rng.standard_normal((n_users, k)) * spectrum
             ).astype(np.float32)
    n_head = max(int(head_pc * n_items), 1)
    i_fac = np.zeros((n_items, k), np.float32)
    i_fac[:n_head] = rng.standard_normal((n_head, k)) * spectrum
    basis, _ = np.linalg.qr(rng.standard_normal((tail_rank, tail_rank)))
    z = rng.standard_normal((n_items - n_head, tail_rank))
    i_fac[n_head:, :tail_rank] = (z @ basis) * spectrum[:tail_rank]
    # rescale tail rows so tail ratings carry the same variance as head
    # ratings (signal strength is not the handicap — SAMPLE COUNT is)
    head_var = float(np.mean((u_fac[:256] @ i_fac[:n_head].T) ** 2))
    tail_var = float(np.mean((u_fac[:256] @ i_fac[n_head:].T) ** 2))
    # tail_boost > 1: tail items carry STRONGER (more polarized)
    # preferences than head — the regime where the per-entity optimal
    # ridge lambda is frequency-dependent (lambda* = sigma^2/tau^2) and
    # one flat lambda must compromise
    i_fac[n_head:] *= tail_boost * np.sqrt(head_var / max(tail_var,
                                                          1e-12))

    # Zipf popularity aligned with the head/tail split: item j's
    # sampling weight ~ 1/(j+1)^a, so tail items land in the bottom
    # frequency quartiles
    w = 1.0 / np.arange(1, n_items + 1) ** power_law
    w /= w.sum()
    nnz = int(density * n_users * n_items)
    cols = rng.choice(n_items, size=nnz, p=w)
    rows = rng.integers(0, n_users, size=nnz)
    key = rows.astype(np.int64) * n_items + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    vals = np.einsum("ek,ek->e", u_fac[rows], i_fac[cols])
    vals = (vals + noise * rng.standard_normal(len(vals))
            ).astype(np.float32)
    mat = RatingMatrix.from_coo(rows, cols, vals, n_users, n_items)

    train, test, val = split_train_test_val(mat, test_pc, val_pc, seed)
    data = Data(train_mat=train, test_mat=test, val_mat=val,
                orig_u_fac=u_fac, orig_i_fac=i_fac)
    data.fac_dim = k
    is_tail = np.zeros(n_items, bool)
    is_tail[n_head:] = True
    return data, is_tail


def leave_one_out_data(n_users: int = 100, n_items: int = 80, k: int = 5,
                       per_user: int = 12, seed: int = 3,
                       structured: bool = False, temp: float = 0.3
                       ) -> Data:
    """Implicit-feedback bundle for BPR/HR tests: each user gets
    ``per_user`` positive items; one held out to test, one to val
    (the leave-one-out protocol hitRate expects, model.cpp:1158-1211).

    ``structured=True`` draws each user's positives from a softmax over a
    latent low-rank preference model instead of uniformly — the regime
    where pairwise ranking actually has signal to recover."""
    rng = np.random.default_rng(seed)
    prefs = None
    if structured:
        uf = rng.standard_normal((n_users, k))
        vf = rng.standard_normal((n_items, k))
        prefs = uf @ vf.T
    rows_tr, cols_tr = [], []
    rows_te, cols_te = [], []
    rows_va, cols_va = [], []
    for u in range(n_users):
        if prefs is None:
            items = rng.choice(n_items, size=min(per_user, n_items),
                               replace=False)
        else:
            p = np.exp(prefs[u] / temp - prefs[u].max() / temp)
            p /= p.sum()
            items = rng.choice(n_items, size=min(per_user, n_items),
                               replace=False, p=p)
        rows_te.append(u)
        cols_te.append(items[0])
        rows_va.append(u)
        cols_va.append(items[1])
        for i in items[2:]:
            rows_tr.append(u)
            cols_tr.append(i)
    ones = lambda n: np.ones(n, dtype=np.float32)
    train = RatingMatrix.from_coo(np.array(rows_tr), np.array(cols_tr),
                                  ones(len(rows_tr)), n_users, n_items)
    test = RatingMatrix.from_coo(np.array(rows_te), np.array(cols_te),
                                 ones(len(rows_te)), n_users, n_items)
    val = RatingMatrix.from_coo(np.array(rows_va), np.array(cols_va),
                                ones(len(rows_va)), n_users, n_items)
    return Data(train_mat=train, test_mat=test, val_mat=val)
