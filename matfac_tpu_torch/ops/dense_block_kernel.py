"""Dense stripe SGD math in plain PyTorch (port of
matfac_tpu/ops/dense_block_kernel.py, row layout only).

One stripe step is a full-batch masked-residual GD step on a dense
[bu, ni_pad] tile of ratings R and validity/weights W:

    P  = U I^T                    E  = W * (R - P)
    gu = -2 E I   + 2 u_reg cnt_u U
    gi = -2 E^T U + 2 i_reg cnt_i I
    U -= lr gu / max(cnt_u, 1);   I -= lr gi / max(cnt_i, 1)

(modelMF.cpp:83-105 per-occurrence regularized SGD at batch = stripe,
README deviation #1; counts come from validity, never from weights).
These functions are the plain versions the CUDA kernel in
``csrc/dense_rows.cu`` is held to, and the route a CPU tensor takes.

Rank-masked models (TMF, TMF+Dropout) ride 0/1 masks Mu [bu, k] / Mi
[bi, k]: the pair mask factorizes, dim d is live iff d < min(r_u, r_i)
iff Mu[u, d] Mi[i, d] (models/base.py), so the products take U o Mu and
I o Mi, and the per-occurrence regularization counts become
cntm_u = (vm @ Mi) o Mu and cntm_i = (vm^T @ Mu) o Mi. TMF+Dropout's
ranks are drawn per stripe visit t from a table of Poisson quantiles,
Q[t, lam - 1] = clip(#{m : C[lam - 1, m] < U_t}, 1, k)
(``visit_quantiles``), and an entity's rank is Q[t, L_e - 1] of its
lambda L_e. The diag cell grid (``dense_sweep_diag``) is not ported: the
solver's default is the row layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _mm_operand(x: torch.Tensor, mm_bf16: bool) -> torch.Tensor:
    """A matmul operand: rounded to bf16 and widened back to f32 when
    ``mm_bf16``, so the product accumulates in f32 — the semantics of
    JAX's ``jnp.dot(a.astype(bf16), ..., preferred_element_type=f32)``.
    (``torch.matmul`` in bf16 would round its output.)"""
    if mm_bf16:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def cell_dense_update(U: torch.Tensor, I: torch.Tensor, R: torch.Tensor,
                      W: Optional[torch.Tensor], lr, u_reg: float,
                      i_reg: float, collision_norm: bool, mm_bf16: bool,
                      Mu: Optional[torch.Tensor] = None,
                      Mi: Optional[torch.Tensor] = None,
                      r_scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GD step on one stripe. U [bu, k], I [bi, k] f32; R [bu, bi]
    ratings (f32/bf16) with W [bu, bi] weights (f32/bf16/int8), or
    ``W=None`` with int8 rating CODES in R: rating = code * r_scale and
    validity = code != 0. ``Mu`` / ``Mi``: [bu, k] / [bi, k] 0/1 f32 rank
    masks, or None for full rank. Collision normalization divides by the
    unmasked counts. Returns new (U, I)."""
    if W is None:
        vm = (R != 0).to(torch.float32)
        Wf = vm
        Rf = R.to(torch.float32) * torch.tensor(r_scale, dtype=torch.float32)
    else:
        Wf = W.to(torch.float32)
        Rf = R.to(torch.float32)
        vm = (Wf > 0).to(torch.float32)
    Ue = U if Mu is None else U * Mu
    Ie = I if Mi is None else I * Mi
    Um = _mm_operand(Ue, mm_bf16)
    Im = _mm_operand(Ie, mm_bf16)
    P = Um @ Im.T
    E = Wf * (Rf - P)
    cnt_u = vm.sum(dim=1)
    cnt_i = vm.sum(dim=0)
    Em = _mm_operand(E, mm_bf16)
    gu_data = -2.0 * (Em @ Im)
    gi_data = -2.0 * (Em.T @ Um)
    if Mu is None:
        gu = gu_data + (2.0 * u_reg) * cnt_u[:, None] * U
        gi = gi_data + (2.0 * i_reg) * cnt_i[:, None] * I
    else:
        # 0/1 operands: the counts are exact integers in f32
        cntm_u = (vm @ Mi) * Mu
        cntm_i = (vm.T @ Mu) * Mi
        gu = gu_data * Mu + (2.0 * u_reg) * cntm_u * U
        gi = gi_data * Mi + (2.0 * i_reg) * cntm_i * I
    if collision_norm:
        gu = gu / torch.clamp(cnt_u, min=1.0)[:, None]
        gi = gi / torch.clamp(cnt_i, min=1.0)[:, None]
    return U - lr * gu, I - lr * gi


def visit_quantiles(pois_cdf: torch.Tensor, round_u: torch.Tensor
                    ) -> torch.Tensor:
    """[NU, k] int32 per-visit rank table of the Poisson CRN draw: row t
    holds q_t[lam - 1] = clip(#{m : C[lam - 1, m] < U_t}, 1, k) for
    lam = 1..k (C = ``pois_cdf`` [k, k], U_t = ``round_u[t]``)."""
    k = pois_cdf.shape[0]
    below = pois_cdf[None, :, :] < round_u.to(pois_cdf.device)[:, None, None]
    return below.sum(dim=2).clamp(1, k).to(torch.int32)


def identity_quantiles(n_visits: int, k: int, device="cpu") -> torch.Tensor:
    """[n_visits, k] int32 rows 1..k: static ranks (TMF), where an entity's
    table value is its rank."""
    row = torch.arange(1, k + 1, dtype=torch.int32, device=device)
    return row.expand(n_visits, k).contiguous()


def rank_masks(L: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[..., k] 0/1 f32 masks of dims below rank q[L - 1] for int lambda /
    rank tables ``L`` and one visit's quantile row ``q`` [k]."""
    k = q.shape[0]
    r = q[L.long() - 1]
    iota = torch.arange(k, device=q.device)
    return (iota < r[..., None]).to(torch.float32)


def dense_sweep_rows(u3: torch.Tensor, i_tab: torch.Tensor,
                     row_order: torch.Tensor, lr,
                     R_rows: torch.Tensor, W_rows: Optional[torch.Tensor],
                     u_reg: float, i_reg: float, collision_norm: bool,
                     mm_bf16: bool = True, Mu3: Optional[torch.Tensor] = None,
                     Mi: Optional[torch.Tensor] = None,
                     r_scale: Optional[float] = None,
                     Lu3: Optional[torch.Tensor] = None,
                     Li: Optional[torch.Tensor] = None,
                     pois_cdf: Optional[torch.Tensor] = None,
                     round_u: Optional[torch.Tensor] = None,
                     Q: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-stripe dense epoch: for each stripe ``s`` of ``row_order`` in
    turn, one ``cell_dense_update`` against the full catalog.

    u3 [NU, bu, k] f32, i_tab [ni_pad, k] f32, R_rows/W_rows
    [NU, bu, ni_pad], row_order a permutation of range(NU). Masks, as in
    JAX: static ``Mu3`` [NU, bu, k] / ``Mi`` [ni_pad, k] (TMF), or int
    lambda tables ``Lu3`` [NU, bu] / ``Li`` [ni_pad] with ``pois_cdf``
    [k, k] and ``round_u`` [NU] (TMF+Dropout: visit t masks at
    ``visit_quantiles``' row t). ``Q`` [NU, k] in place of ``pois_cdf`` /
    ``round_u``: any per-visit rank table (the stripe kernel's form;
    ``identity_quantiles`` makes Lu3 / Li plain ranks). Updates ``u3``
    and ``i_tab`` IN PLACE (the resident tables are the only copy the
    solver keeps) and returns them."""
    lr = float(lr)
    if pois_cdf is not None:
        Q = visit_quantiles(pois_cdf, round_u)
    for t, s in enumerate(row_order.tolist()):
        W = None if W_rows is None else W_rows[s]
        if Q is not None:
            Mu, Mi_t = rank_masks(Lu3[s], Q[t]), rank_masks(Li, Q[t])
        else:
            Mu, Mi_t = (None if Mu3 is None else Mu3[s]), Mi
        U, I = cell_dense_update(u3[s], i_tab, R_rows[s], W, lr, u_reg,
                                 i_reg, collision_norm, mm_bf16, Mu=Mu,
                                 Mi=Mi_t, r_scale=r_scale)
        u3[s] = U
        i_tab.copy_(I)
    return u3, i_tab


def densify_rows(cell: np.ndarray, u_loc: np.ndarray, i_loc: np.ndarray,
                 vals: np.ndarray, n_cells_pad: int, bu: int, bi: int,
                 dtype: torch.dtype, device="cuda",
                 chunk_elems: int = 1 << 28) -> torch.Tensor:
    """Scatter a COO stream into the dense [n_cells_pad, bu, bi] grid.

    Duplicate (row, col) entries SUM, in ``dtype``, as XLA's ``.at[].add``
    does in ``densify_rows_host``. The scatter runs over row ranges of at
    most ``chunk_elems`` slots, so each flat index fits in int32-sized
    kernels and the temporaries stay bounded; the indices are int64."""
    rows = cell.astype(np.int64) * bu + u_loc.astype(np.int64)
    n_rows = n_cells_pad * bu
    buf = torch.zeros((n_rows, bi), dtype=dtype, device=device)
    max_rows = max(min((2**31 - 1) // bi, chunk_elems // bi), 1)
    order = np.argsort(rows, kind="stable")
    rows_s = rows[order]
    cols_s = i_loc.astype(np.int64)[order]
    vals_t = torch.from_numpy(np.ascontiguousarray(vals[order]))
    for r0 in range(0, n_rows, max_rows):
        r1 = min(r0 + max_rows, n_rows)
        lo = int(np.searchsorted(rows_s, r0, "left"))
        hi = int(np.searchsorted(rows_s, r1, "left"))
        if lo == hi:
            continue
        idx = torch.from_numpy((rows_s[lo:hi] - r0) * bi + cols_s[lo:hi])
        buf[r0:r1].view(-1).index_put_(
            (idx.to(device),), vals_t[lo:hi].to(device=device, dtype=dtype),
            accumulate=True)
    return buf.view(n_cells_pad, bu, bi)
