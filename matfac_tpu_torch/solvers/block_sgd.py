"""Row-dense stripe SGD solver (port of matfac_tpu/solvers/block_sgd.py,
``engine="dense"`` with the row layout only).

Staging, as in the JAX solver: users and items are relabeled round-robin
over descending train frequency (``_balance_perm``); the train matrix is
densified into [NU, bu, ni_pad] stripe tiles by the ladder of
``_stage_dense`` (int8 rating codes when the ratings are exactly
code * scale, else int8 validity with f32/bf16 ratings, else float
weights); the factor tables stay resident in the relabeled layout across
epochs. Each epoch visits the stripes in a random order, one full-catalog
masked-residual GD step per stripe (ops/dense_row_kernel.dense_rows_epoch:
the CUDA kernel on a CUDA device, plain PyTorch on the CPU).

Left out of the port, as TPU workarounds: the dummy stripe row NU (it fed
the diag layout's pad lanes), the panel-major relayout (a DMA fix),
``pad_k`` (MXU lane filling) and the VMEM guards. ``dense_budget_bytes``
and the auto-codes threshold keep the JAX values, so the port stages the
same tiles; re-deriving them for an 80 GB card is ROADMAP queue 1,
item 3.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matfac_tpu.config import Params
from matfac_tpu_torch.models.base import MFState
from matfac_tpu_torch.ops.dense_block_kernel import densify_rows
from matfac_tpu_torch.ops.dense_row_kernel import dense_rows_epoch


def _cdiv(a, b):
    return -(-a // b)


def rating_code_scale(vals: np.ndarray) -> Optional[float]:
    """Exact int8 rating-code scale for ``vals``, or None (copy of the
    numpy helper in matfac_tpu/solvers/block_sgd.py, which imports jax).

    Returns g such that every rating equals code * g EXACTLY in f32 with
    integer code, 1 <= |code| <= 127 (code 0 means "unrated", so a zero
    rating disqualifies the mode). Candidates: the smallest |rating| and
    the smallest gap between distinct |rating|s."""
    v = np.asarray(vals, np.float32)
    if len(v) == 0 or np.any(v == 0) or not np.all(np.isfinite(v)):
        return None
    mags = np.unique(np.abs(v)).astype(np.float64)
    cands = {float(mags[0])}
    if len(mags) > 1:
        cands.add(float(np.diff(mags).min()))
    for g in sorted(cands, reverse=True):
        if g <= 0:
            continue
        codes = np.round(v.astype(np.float64) / g)
        if np.abs(codes).max() > 127 or np.abs(codes).min() < 1:
            continue
        if np.array_equal(
                (codes.astype(np.float32) * np.float32(g)), v):
            return g
    return None


def _balance_perm(freq: np.ndarray, n: int, n_blocks: int,
                  block: int) -> np.ndarray:
    """old id -> new id; round-robin blocks over descending frequency,
    snake order (copy of the JAX solver's numpy helper)."""
    order = np.argsort(-freq, kind="stable")
    perm = np.empty(n, np.int64)
    pos_in_block = np.arange(n) // n_blocks
    blk = np.arange(n) % n_blocks
    snake = np.where(pos_in_block % 2 == 1, n_blocks - 1 - blk, blk)
    perm[order] = snake * block + pos_in_block
    return perm


class BlockSGDSolver:
    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 bu: Optional[int] = None, bi: Optional[int] = None,
                 collision_norm: Optional[bool] = None,
                 mm_bf16: bool = True, engine: str = "dense",
                 dense_budget_bytes: int = 8 << 30,
                 dense_codes: str = "auto", device="cuda"):
        """``bu``/``bi`` None = auto (``bi`` = the padded catalog width,
        the row layout; ``bu`` from the JAX solver's sizing rule).
        ``dense_codes``: "auto" (codes only when float tiles miss the
        budget or the grid holds >= 1.5e9 slots), "codes" (force; error
        when not representable), "off" (float tiles), "lossy" (127 signed
        levels of max|r|/127, near-zero ratings clamped to +/-1 code)."""
        if engine != "dense":
            raise NotImplementedError(
                f"engine={engine!r}: only the row-dense engine is ported; "
                "the one-hot block engine is ROADMAP queue 1, item 9")
        if model.use_bias or not model.use_factors:
            raise ValueError("BlockSGDSolver is factor-only")
        if dense_codes not in ("auto", "codes", "off", "lossy"):
            raise ValueError(f"unknown dense_codes {dense_codes!r}")
        self.model = model
        self.params = params
        self.device = torch.device(device)
        self.mm_bf16 = mm_bf16
        self.collision_norm = (params.sgd_collision_norm
                               if collision_norm is None
                               else collision_norm)
        self.dense_codes = dense_codes
        n_users, n_items = model.n_users, model.n_items
        if bi is None:
            bi = _cdiv(n_items, 128) * 128
        if _cdiv(n_items, bi) != 1:
            raise NotImplementedError(
                "only the row layout (bi=None, one full-catalog item "
                "block) is ported; the diag cell grid is ROADMAP queue 1, "
                "item 2")
        if bu is None:
            # >= 8 stripes keeps the epoch SGD-like; 2560 caps a stripe's
            # [bu, ni_pad] f32 intermediates of the plain version. A
            # 256-row quantum, falling to 8 rows when 256 would leave
            # fewer than 8 stripes (same rule as the JAX solver)
            target = _cdiv(n_users, 8)
            bu = min(2560, max(_cdiv(target, 256) * 256, 256))
            if _cdiv(n_users, bu) < 8:
                bu = min(2560, max(_cdiv(target, 8) * 8, 8))
        self.bu, self.bi = bu, bi
        self.NU = _cdiv(n_users, bu)
        self.n_users_pad = self.NU * bu
        self.n_items_pad = bi
        self.r_scale = None

        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        self.nnz = len(r)

        # frequency-balanced relabeling of both axes
        u_freq = np.bincount(r, minlength=n_users)
        i_freq = np.bincount(c, minlength=n_items)
        self.u_perm = _balance_perm(u_freq, n_users, self.NU, bu)
        self.i_perm = _balance_perm(i_freq, n_items, 1, bi)
        # inverse over the padded label space; rows outside the perm's
        # image are dead padding (all-invalid tiles) and read row 0
        u_inv = np.zeros(self.n_users_pad, np.int64)
        u_inv[self.u_perm] = np.arange(n_users)
        i_inv = np.zeros(self.n_items_pad, np.int64)
        i_inv[self.i_perm] = np.arange(n_items)
        dev = self.device
        self.u_perm_dev = torch.from_numpy(self.u_perm).to(dev)
        self.i_perm_dev = torch.from_numpy(self.i_perm).to(dev)
        self.u_perm_inv_dev = torch.from_numpy(u_inv).to(dev)
        self.i_perm_inv_dev = torch.from_numpy(i_inv).to(dev)

        w = model.example_weight(torch.from_numpy(r.astype(np.int64)),
                                 torch.from_numpy(c.astype(np.int64)))
        w = w.cpu().numpy().astype(np.float32)
        r = self.u_perm[r]
        c = self.i_perm[c]
        self._stage_dense(r // bu, (r % bu).astype(np.int32),
                          c.astype(np.int32), v.astype(np.float32), w,
                          self.NU, dense_budget_bytes)
        self._order_gen = torch.Generator().manual_seed(params.seed + 41)
        self._resident = None
        self._last_u_view = None
        self._last_i_view = None

    # ------------------------------------------------------------------
    def _stage_dense(self, cell, u_loc, i_loc, vals, wts, n_cells, budget):
        """Dense [bu, ni_pad] tiles per stripe. Ladder, best first: int8
        rating CODES (validity = code != 0; exact for star-grid data,
        lossy on request) when the weights are uniform 0/1; else int8
        validity W with f32/bf16 R; else f32/bf16 W by budget (IFWMF).
        ``slots`` counts one dummy stripe, as the JAX solver's layout
        does, so both packages pick the same dtypes at a budget edge."""
        uniform01 = bool(np.all((wts == 0.0) | (wts == 1.0)))
        slots = (n_cells + 1) * self.bu * self.bi
        use_codes = uniform01 and self.dense_codes != "off"
        if use_codes and self.dense_codes == "auto":
            # codes only for traffic-bound grids or over-budget floats
            if slots < int(1.5e9) and slots * 3 <= budget:
                use_codes = False
        stage = lambda v, dtype: densify_rows(
            cell, u_loc, i_loc, v, n_cells_pad=n_cells, bu=self.bu,
            bi=self.bi, dtype=dtype, device=self.device)
        if use_codes:
            g = rating_code_scale(vals)
            codes = None
            if g is not None:
                codes = np.round(vals.astype(np.float64) / g)
            elif self.dense_codes == "lossy":
                finite = vals[np.isfinite(vals)]
                mx = float(np.abs(finite).max()) if len(finite) else 0.0
                if mx > 0:
                    g = mx / 127.0
                    codes = np.clip(np.round(vals / g), -127, 127)
                    # would-be code 0 (incl. exact 0.0) clamps to +/-1:
                    # code 0 means "unrated", so no rating may land there
                    zero = codes == 0
                    sgn = np.sign(vals[zero])
                    codes[zero] = np.where(sgn == 0, 1.0, sgn)
            if codes is None and self.dense_codes == "codes":
                raise ValueError(
                    "dense_codes='codes' requires exactly star-grid-"
                    "representable ratings (rating_code_scale); use "
                    "'lossy' or 'auto'")
            if codes is not None:
                if slots > budget:
                    raise ValueError(
                        f"dense code tiles need {slots / 2**30:.1f} GiB > "
                        f"dense_budget {budget / 2**30:.1f} GiB")
                self.r_scale = float(g)
                self.R_rows = stage(codes.astype(np.int8), torch.int8)
                self.W_rows = None
                return
        if uniform01:
            wdtype, wbytes = torch.int8, 1
        elif slots * 8 <= budget:
            wdtype, wbytes = torch.float32, 4
        else:
            wdtype, wbytes = torch.bfloat16, 2
        if slots * (4 + wbytes) <= budget:
            vdtype = torch.float32
        elif slots * (2 + wbytes) <= budget:
            vdtype = torch.bfloat16
        else:
            raise ValueError(
                f"dense tiles need {slots * (2 + wbytes) / 2**30:.1f} GiB "
                f"> dense_budget {budget / 2**30:.1f} GiB")
        self.R_rows = stage(vals, vdtype)
        self.W_rows = stage(wts.astype(np.float32), wdtype)

    # ------------------------------------------------------------------
    def _stripe_order(self) -> torch.Tensor:
        """This epoch's stripe visiting order: a CPU int64 permutation of
        range(NU) from the solver's own generator (seed + 41)."""
        return torch.randperm(self.NU, generator=self._order_gen)

    def internal_state(self) -> dict:
        """What an exact resume needs besides the factor tables."""
        return {"order_gen": self._order_gen.get_state().numpy()}

    def set_internal_state(self, st: dict) -> None:
        if "order_gen" in st:
            self._order_gen.set_state(
                torch.from_numpy(np.asarray(st["order_gen"], np.uint8)))

    def stage_factors(self, state: MFState):
        """Fresh (u3 [NU, bu, k], i_tab [ni_pad, k]) f32 tables in the
        relabeled, padded layout: staged[new] = logical[inv[new]]."""
        k = state.u_fac.shape[1]
        u = state.u_fac[self.u_perm_inv_dev].to(torch.float32)
        i = state.i_fac[self.i_perm_inv_dev].to(torch.float32)
        return u.reshape(self.NU, self.bu, k).contiguous(), i.contiguous()

    def epoch(self, state: MFState, lr: float) -> MFState:
        if (self._resident is not None
                and state.u_fac is self._last_u_view
                and state.i_fac is self._last_i_view):
            u3, i_tab = self._resident
        else:
            u3, i_tab = self.stage_factors(state)
        dense_rows_epoch(u3, i_tab, self._stripe_order(), lr, self.R_rows,
                         self.W_rows, self.r_scale,
                         float(self.params.u_reg), float(self.params.i_reg),
                         self.collision_norm, self.mm_bf16)
        self._resident = (u3, i_tab)
        k = u3.shape[2]
        # logical[old] = staged[perm[old]]
        u_view = u3.view(self.n_users_pad, k)[self.u_perm_dev]
        i_view = i_tab[self.i_perm_dev]
        # keep the POST-cast tensors: the identity check above must see
        # exactly what the state holds
        u_ret = u_view.to(state.u_fac.dtype)
        i_ret = i_view.to(state.i_fac.dtype)
        self._last_u_view, self._last_i_view = u_ret, i_ret
        return state._replace(u_fac=u_ret, i_fac=i_ret)
