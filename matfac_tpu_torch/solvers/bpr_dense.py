"""Dense-stripe BPR: pairwise ranking on full-catalog score panels (port of
matfac_tpu/solvers/bpr_dense.py, ``bpr_engine="dense"`` in stream mode).

The engine restructures the stream BPR epoch (solvers/bpr.py) as the
row-dense SGD engine does: users are relabeled so every stripe of ``bu``
users carries an even share of the positives, and per stripe one dense
score panel serves every positive of the stripe:

  P2 = U @ I^T - BIG * W          [bu, ni_pad] (bf16 operands, f32 sums;
                                   W = the stripe's 0/1 rated / invalid /
                                   padding mask)
  s+ = P2[ul, ip] + BIG           (ip is rated, so the -BIG cancels)
  s- = P2[ul, j],  j ~ U[0, n_items)   (a rated or invalid j scores
                                   raw - BIG, so its coefficient is ~0:
                                   the draw's rejection folded into the
                                   score)
  c  = w * (-1 / (T (1 + exp(s+ - s-))))
  C  = +c at (ul, ip), -c at (ul, j)        (duplicates add up)
  gU = C @ I + 2 u_reg cnt_u U;  gI = C^T @ U + 2 i_reg cnt_i I

so U - lr gU is the stream engine's per-triple update summed over the
stripe (modelMFBPR.cpp:501-521, batch = stripe), the negative side's
regularization counted by the EXPECTED draws per item, and T > 1 draws a
positive averaged. ``panel_q`` = Q takes instead, for each sub-batch of
~4k positives, the Q columns of one random tile of the padded catalog as
every positive's negatives, at weight 1 / Q. ``collision_norm`` divides
each row's gradient by its count in the stripe. Rank-masked models stay on
the stream engine: per-pair masks do not factor through C (the
constructor raises ValueError, and ``train_model`` falls back).

Plain PyTorch on the tables' device, as JAX computes it with XLA (no
Pallas kernel): the score product through ``mm_f32`` (bf16 operands, f32
output on the card), so that the -60 fold keeps f32 precision; the two
routing products in f32. Colliding (ul, j) entries add up: the per-draw
epoch scatters with ``index_put_(accumulate=True)`` (sort-based on the
card: two runs of an epoch were bit-identical on an H100), the panel epoch
with ``index_add_`` (atomics on the card: two runs differ there, and the
bf16 rounding of the next stripe's scores carries the difference on).
Each epoch's draws, the stripe order ``row_of`` [NU] and the negatives
``js`` [NU, T, S] (``tiles`` [NU, nb] in panel mode), come from the
solver's own ``torch.Generator`` (``draw``); ``epoch_with`` takes them as
given. The epoch updates the resident relabeled tables in place and hands
back fresh views.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import MFState
from matfac_tpu_torch.solvers.als import mm_f32
from matfac_tpu_torch.solvers.block_sgd import _balance_perm, _cdiv

_BIG = 60.0   # sigmoid(-60) ~ 9e-27: rated-negative pairs self-cancel


class DenseBPRSolver:
    """Drop-in BPRSolver alternative (stream-mode semantics only)."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 bu: Optional[int] = None, n_negs: int = 1,
                 collision_norm: bool = False,
                 dense_budget_bytes: int = 8 << 30,
                 panel_q: Optional[int] = None, device="cuda", **_):
        """The JAX constructor's signature and defaults.
        ``collision_norm=False`` sums the stripe's per-pair gradients (the
        stream engine's semantics at the same learn_rate); True takes the
        within-stripe mean. ``dense_budget_bytes`` bounds the int8 mask
        (JAX's v5e value; ROADMAP queue 1, item 3)."""
        z = torch.zeros(1, dtype=torch.int64)
        if model.triple_rank_mask(z, z, z) is not None:
            raise ValueError(
                "DenseBPRSolver shares one C matrix across the stripe; "
                f"{model.name} needs per-pair rank masks — use BPRSolver")
        self.model = model
        self.params = params
        self.device = torch.device(device)
        dev = self.device
        self.n_negs = int(n_negs)
        self.panel_q = None if panel_q is None else int(panel_q)
        self.collision_norm = collision_norm
        n_users, n_items = model.n_users, model.n_items

        r, c, v = train_mat.to_coo()
        keep = (v > 0) & ~invalid_users[r] & ~invalid_items[c]
        pr, pc = r[keep].astype(np.int64), c[keep].astype(np.int64)
        self.n_pos = len(pr)

        self.ni_pad = _cdiv(n_items, 128) * 128
        if self.panel_q is not None and self.ni_pad % self.panel_q:
            raise ValueError(
                f"panel_q={self.panel_q} must divide the padded catalog "
                f"width {self.ni_pad}")
        if bu is None:
            bu = min(2560, max(_cdiv(_cdiv(n_users, 8), 256) * 256, 256))
        self.bu = bu
        self.NU = _cdiv(n_users, bu)
        self.n_users_pad = self.NU * bu
        slots = self.NU * bu * self.ni_pad
        if slots > dense_budget_bytes:   # int8 mask
            raise ValueError(
                f"dense BPR mask needs {slots / 2**30:.1f} GiB > budget "
                f"{dense_budget_bytes / 2**30:.1f} GiB; use BPRSolver")

        # frequency-balanced user relabel, as the stripe SGD engine's
        u_freq = np.bincount(pr, minlength=n_users)
        self.u_perm = _balance_perm(u_freq, n_users, self.NU, bu)
        u_inv = np.zeros(self.n_users_pad, np.int64)
        u_inv[self.u_perm] = np.arange(n_users)
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        self.u_perm_dev = as_t(self.u_perm)
        self.u_perm_inv_dev = as_t(u_inv)

        r2 = self.u_perm[pr]
        stripe = r2 // bu
        counts = np.bincount(stripe, minlength=self.NU)
        S = max(int(counts.max()), 1)
        self.nb = 1
        if self.panel_q is not None:
            # sub-batches of ~4k positives, each with its own tile
            self.nb = max(1, -(-S // 4096))
            S = -(-S // self.nb) * self.nb
        self.S = S
        self.pad_frac = self.NU * S / max(self.n_pos, 1)

        u_loc = np.zeros((self.NU, S), np.int64)
        ipos = np.zeros((self.NU, S), np.int64)
        wpos = np.zeros((self.NU, S), np.float32)
        order = np.argsort(stripe, kind="stable")
        r2s, pcs, stripes = r2[order], pc[order], stripe[order]
        locs = r2s % bu
        pos = np.arange(len(r2s)) - np.searchsorted(stripes, stripes, "left")
        u_loc[stripes, pos] = locs
        ipos[stripes, pos] = pcs
        wpos[stripes, pos] = 1.0
        self.u_locs, self.ipos, self.wpos = as_t(u_loc), as_t(ipos), \
            as_t(wpos)

        # static per-stripe occurrence counts (regularization, collisions);
        # negatives are uniform over the catalog: the expected draws per
        # item and stripe, times the 1/T weight (T-independent)
        cnt_u = np.zeros((self.NU, bu), np.float32)
        np.add.at(cnt_u, (stripes, locs), 1.0)
        cnt_ip = np.zeros((self.NU, self.ni_pad), np.float32)
        np.add.at(cnt_ip, (stripes, pcs), 1.0)
        cnt_neg = counts.astype(np.float32) / max(self.ni_pad, 1)
        self.cnt_u = as_t(cnt_u)
        self.cnt_i = as_t(cnt_ip + cnt_neg[:, None])
        self.cnt_neg = as_t(cnt_neg)
        # the panel epoch's collision divisors add the realized panel
        # counts to the rated ones
        self.cnt_ip = as_t(cnt_ip) if self.panel_q is not None else None

        # the stripe rows' int8 mask: 1 = positively rated, never-rated or
        # invalid item, or padded column; built once on the device
        mask0 = np.zeros(self.ni_pad, np.int8)
        mask0[n_items:] = 1
        deg_i = train_mat.col_degrees()
        never = np.ones(n_items, bool)
        never[: len(deg_i)] &= deg_i[:n_items] == 0
        mask0[:n_items][never | invalid_items[:n_items]] = 1
        self.W_rows = as_t(mask0).expand(self.NU, bu, self.ni_pad
                                         ).contiguous()
        self.W_rows[as_t(stripes), as_t(locs), as_t(pcs)] = 1
        self.n_items_real = n_items
        self.generator = torch.Generator(device=dev).manual_seed(params.seed)
        self._resident = None
        self._last_u_view = None
        self._last_i_view = None
        self.last_loss = torch.zeros((), device=dev)
        self.last_inversions = torch.zeros((), dtype=torch.int64, device=dev)

    # ------------------------------------------------------------------
    def draw(self):
        """This epoch's (row_of [NU], js [NU, T, S]) or, in panel mode,
        (row_of, tiles [NU, nb]) from the solver's generator: JAX's shapes
        and ranges (negatives over the real catalog, tiles over the padded
        one)."""
        g, dev = self.generator, self.device
        row_of = torch.randperm(self.NU, generator=g, device=dev)
        if self.panel_q is not None:
            return row_of, torch.randint(
                0, self.ni_pad // self.panel_q, (self.NU, self.nb),
                generator=g, device=dev)
        return row_of, torch.randint(
            0, self.n_items_real, (self.NU, self.n_negs, self.S),
            generator=g, device=dev)

    def internal_state(self) -> dict:
        """What an exact resume needs besides the factor tables."""
        return {"gen": self.generator.get_state().cpu().numpy()}

    def set_internal_state(self, st: dict) -> None:
        if "gen" in st:
            self.generator.set_state(
                torch.from_numpy(np.asarray(st["gen"], np.uint8)))

    # ------------------------------------------------------------------
    def stage_factors(self, state: MFState):
        """Fresh f32 tables (u3 [NU, bu, k], i_tab [ni_pad, k]) in the
        relabeled, padded layout; padding rows of u3 hold user 0's row
        and padding items zeros, as in JAX (neither is ever updated)."""
        k = state.u_fac.shape[1]
        u3 = state.u_fac[self.u_perm_inv_dev].to(torch.float32)
        i_tab = torch.zeros(self.ni_pad, k, dtype=torch.float32,
                            device=self.device)
        i_tab[: state.i_fac.shape[0]] = state.i_fac
        return u3.reshape(self.NU, self.bu, k).contiguous(), i_tab

    def _tables(self, state: MFState):
        if (self._resident is not None
                and state.u_fac is self._last_u_view
                and state.i_fac is self._last_i_view):
            return self._resident
        return self.stage_factors(state)

    def _views(self, state: MFState, u3, i_tab) -> MFState:
        self._resident = (u3, i_tab)
        k = u3.shape[-1]
        u_view = u3.reshape(self.n_users_pad, k)[self.u_perm_dev]
        # a copy: the resident table is updated in place next epoch
        i_view = i_tab[: self.model.n_items].clone()
        # keep the POST-cast tensors for the identity check in _tables
        u_ret = u_view.to(state.u_fac.dtype)
        i_ret = i_view.to(state.i_fac.dtype)
        self._last_u_view, self._last_i_view = u_ret, i_ret
        return state._replace(u_fac=u_ret, i_fac=i_ret)

    def _apply(self, u3, I, U, ub: int, C, lr: float, div_i=None):
        """U - lr gU into the resident stripe and I - lr gI in place, from
        the routing matrix C."""
        p = self.params
        cnt_u = self.cnt_u[ub]
        gU = C @ I + (2.0 * float(p.u_reg)) * cnt_u[:, None] * U
        gI = C.t() @ U + (2.0 * float(p.i_reg)) * self.cnt_i[ub][:, None] * I
        if self.collision_norm:
            gU = gU / torch.clamp(cnt_u, min=1.0)[:, None]
            div = self.cnt_i[ub] if div_i is None else div_i
            gI = gI / torch.clamp(div, min=1.0)[:, None]
        u3[ub] = U - lr * gU
        I.sub_(lr * gI)

    def epoch_with(self, state: MFState, lr: float, row_of, draws
                   ) -> MFState:
        """One epoch on the given draws (``draw``'s form), in the order of
        ``row_of`` (a prefix of it runs a partial epoch)."""
        u3, I = self._tables(state)
        lr = float(lr)
        dev = self.device
        C = torch.empty(self.bu, self.ni_pad, dtype=torch.float32,
                        device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        inv = torch.zeros((), dtype=torch.int64, device=dev)
        eps = float(self.params.eps)
        draws = draws.to(dev)
        panel = self.panel_q is not None
        T = self.panel_q if panel else self.n_negs
        for t, ub in enumerate(torch.as_tensor(row_of).tolist()):
            U = u3[ub]
            # the folded score panel P2 = U I^T - BIG W [bu, ni_pad]
            P2 = mm_f32(U.to(torch.bfloat16), I.to(torch.bfloat16).t()
                        ).sub_(self.W_rows[ub], alpha=_BIG)
            ul, ip, w = self.u_locs[ub], self.ipos[ub], self.wpos[ub]
            splus = P2[ul, ip] + _BIG                        # [S]
            if panel:
                Q, nb = self.panel_q, self.nb
                sb = torch.arange(self.S, device=dev) // (self.S // nb)
                cols = (draws[t][:, None] * Q + torch.arange(
                    Q, device=dev)[None, :]).reshape(-1)     # [nb Q]
                # [bu, nb, Q] as rows ul * nb + sb: the positive's tile
                Sn = P2[:, cols].reshape(self.bu * nb, Q)[ul * nb + sb]
                r = splus[:, None] - Sn                      # [S, Q]
                wr = w[:, None]
            else:
                j = draws[t]                                 # [T, S]
                r = splus[None, :] - P2[ul[None, :], j]      # [T, S]
                wr = w[None, :]
            c = wr * (-1.0 / (T * (1.0 + torch.exp(r))))
            # per-draw means: the stream engine's loss scale at any T
            loss += (wr * torch.logaddexp(torch.zeros_like(r), -r)
                     ).sum() / T
            inv += ((-r > eps) & (wr > 0)).sum()
            C.zero_()
            div_i = None
            if panel:
                C.index_put_((ul, ip), c.sum(dim=1), accumulate=True)
                Cn = torch.zeros(self.bu * nb, Q, device=dev)
                Cn.index_add_(0, ul * nb + sb, -c)
                C.index_add_(1, cols, Cn.reshape(self.bu, nb * Q))
                if self.collision_norm:
                    # realized per-tile counts on top of the rated ones
                    nv_sb = torch.zeros(nb, device=dev).index_add_(
                        0, sb, (w > 0).to(torch.float32))
                    div_i = self.cnt_ip[ub].clone().index_add_(
                        0, cols, (nv_sb / Q).repeat_interleave(Q))
            else:
                C.index_put_((ul, ip), c.sum(dim=0), accumulate=True)
                C.index_put_((ul.expand_as(j).reshape(-1), j.reshape(-1)),
                             -c.reshape(-1), accumulate=True)
            self._apply(u3, I, U, ub, C, lr, div_i)
        self.last_loss = loss
        # the inversion count on the per-draw scale, rounded as JAX does
        self.last_inversions = torch.round(inv.to(torch.float64) / T
                                           ).to(torch.int64)
        return self._views(state, u3, I)

    def epoch(self, state: MFState, lr: float) -> MFState:
        return self.epoch_with(state, lr, *self.draw())
