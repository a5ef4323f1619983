"""Cell-blocked SGD solver (port of matfac_tpu/solvers/block_sgd.py): the
one-hot cell engines and the row-dense stripe engine.

Staging shared by both, as in the JAX solver: users and items are
relabeled round-robin over descending train frequency (``_balance_perm``),
so the power-law mass spreads evenly over the blocks; the factor tables
stay resident in the relabeled layout across epochs, and the views handed
back keep the post-cast identity the resident check relies on.

One-hot engines (``engine="xla"`` or ``"pallas"``): the ratings of each
(user block x item block) cell are staged as a stream of S slots
(``_stage_cells``) carrying ids, ratings, IFWMF weights, static TMF ranks
and host-staged collision counts. The row schedule sweeps user-block rows
(ops/block_sgd_kernel.block_sgd_epoch); the diag schedule runs DSGD rounds
of cells disjoint in both axes (block_sgd_diag_epoch). Both run the CUDA
kernel ``csrc/block_sgd.cu`` on a CUDA device and the plain PyTorch
version on the CPU. Poisson-sampled ranks, bias models and per-side gates
are refused, as in JAX.

Dense engine (``engine="dense"``, the row layout only): the train matrix
is densified into [NU, bu, ni_pad] stripe tiles by the ladder of
``_stage_dense`` (int8 rating codes when the ratings are exactly
code * scale, else int8 validity with f32/bf16 ratings, else float
weights); each epoch visits the stripes in a random order, one
full-catalog masked-residual GD step per stripe
(ops/dense_row_kernel.dense_rows_epoch).

Left out of the port, as TPU workarounds: the dummy factor block NU (the
diag schedule's pad lanes are skipped), the panel-major relayout (a DMA
fix), ``pad_k`` (MXU lane filling; accepted, not applied) and the VMEM
guards. ``dense_budget_bytes`` and the auto-codes threshold keep the JAX
values, so the port stages the same tiles; re-deriving them for an 80 GB
card is ROADMAP queue 1, item 3.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import MFState, ModelMF
from matfac_tpu_torch.ops.block_sgd_kernel import (block_sgd_diag_epoch,
                                                   block_sgd_epoch,
                                                   diag_schedule)
from matfac_tpu_torch.ops.dense_block_kernel import densify_rows
from matfac_tpu_torch.ops.dense_row_kernel import (dense_rows_epoch,
                                                   stripe_counts)


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


def auto_batch_size(s0: int, lanes: int, target_ratings: int = 65536,
                    quantum: int = 256) -> int:
    """Minibatch size for ``batch_size=None`` (copy of the JAX numpy
    helper): ~``target_ratings`` per sequential step across ``lanes``
    parallel cells, per lane clamped to [1024, 8192], fitted to the
    largest cell ``s0`` and rounded up to ``quantum``."""
    per_lane = min(max(target_ratings // max(lanes, 1), 1024), 8192)
    n_steps = max(_cdiv(s0, per_lane), 1)
    return _cdiv(_cdiv(s0, n_steps), quantum) * quantum


def stage_batch_collision_counts(wts: np.ndarray, loc: np.ndarray,
                                 bs: int, width: int) -> np.ndarray:
    """max(valid same-entity entries within the static batch slice, 1)
    for each slot of a staged stream [n_cells, S] (copy of the JAX numpy
    helper). Batch contents are static slices of each cell (only their
    order is random), so the counts are staged on the host."""
    n_cells, S = wts.shape
    valid = (wts > 0).ravel().astype(np.float64)
    batch_id = np.arange(n_cells * S, dtype=np.int64) // bs
    key = batch_id * np.int64(width) + loc.ravel()
    _, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv, weights=valid)[inv]
    return np.maximum(cnt, 1.0).astype(np.float32).reshape(n_cells, S)


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
                 batch_size: Optional[int] = 256,
                 bu: Optional[int] = 1024, bi: Optional[int] = 1024,
                 collision_norm: Optional[bool] = None,
                 mm_bf16: bool = True, interpret: bool = False,
                 engine: str = "xla", schedule: str = "row",
                 pad_k: int = 0, dense_budget_bytes: int = 8 << 30,
                 dense_codes: str = "auto", device="cuda"):
        """The JAX constructor's signature and defaults (less its TPU
        kernel selectors ``dense_kernel`` / ``dense_panel``).

        ``engine``: "xla" or "pallas" (both the one-hot cell engine: the
        CUDA kernel on a CUDA device, the plain version on the CPU) or
        "dense" (the row-dense stripe engine; pass ``bu=None, bi=None`` for
        its auto sizing, as ``train_model`` does). ``schedule`` (one-hot
        engines): "row" (user-block rows in a random order, each sweeping
        its cells in a random order) or "diag" (DSGD rounds of cells
        disjoint in both axes; engine "xla" only, as in JAX).
        ``batch_size=None`` sizes the minibatch from the largest cell
        (``auto_batch_size``), which changes which ratings share a step.
        ``pad_k`` is accepted and checked but not applied: zero columns
        are an exact no-op that only filled the TPU's matrix lanes.
        ``interpret`` must stay False: there is no interpret mode; a CPU
        tensor runs the plain version. Dense options: ``dense_codes``
        "auto" (codes only when float tiles miss the budget or the grid
        holds >= 1.5e9 slots), "codes" (force; error when not
        representable), "off" (float tiles), "lossy" (127 signed levels of
        max|r|/127, near-zero ratings clamped to +/-1 code)."""
        if interpret:
            raise ValueError("no interpret mode: the plain PyTorch version "
                             "runs on a CPU device")
        if engine not in ("xla", "pallas", "dense"):
            raise ValueError(f"unknown engine {engine!r}")
        if schedule not in ("row", "diag"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if engine == "dense":
            schedule = "row"   # the ported dense layout: one item block
        elif schedule == "diag" and engine != "xla":
            raise ValueError("schedule='diag' requires engine='xla'")
        self.schedule = schedule
        self.engine = engine
        if model.use_bias or not model.use_factors:
            raise ValueError("BlockSGDSolver is factor-only")
        if type(model).update_side_masks is not ModelMF.update_side_masks:
            # per-side gates of the user / item updates; these engines
            # apply one pair mask to both sides
            raise ValueError("per-side update gates need SGDSolver")
        if hasattr(model, "pair_lambda") or getattr(
                model, "stochastic_rank", False):
            if engine == "dense":
                raise NotImplementedError(
                    "the dense engine's per-stripe Poisson rank resampling "
                    "is ROADMAP queue 1, item 7")
            raise ValueError(
                "block-SGD stages static per-pair ranks; "
                f"{model.name} needs per-update sampled ranks — use "
                "the sgd engine (or DSGD, which samples in-kernel), "
                "or the dense row engine (per-stripe-visit CRN "
                "resampling)")
        if engine == "dense" and hasattr(model, "pair_rank"):
            raise NotImplementedError(
                "rank-masked models on the dense engine (the Mu / Mi mask "
                "tables) are ROADMAP queue 1, item 7; use the one-hot "
                "engine (engine='xla')")
        self.model = model
        self.params = params
        self.device = torch.device(device)
        self.mm_bf16 = mm_bf16
        self.pad_k = max(int(pad_k), 0)
        if self.pad_k and self.pad_k < model.k:
            raise ValueError("pad_k must be >= fac_dim")
        self.collision_norm = (params.sgd_collision_norm
                               if collision_norm is None
                               else collision_norm)
        n_users, n_items = model.n_users, model.n_items
        if engine == "dense":
            if dense_codes not in ("auto", "codes", "off", "lossy"):
                raise ValueError(f"unknown dense_codes {dense_codes!r}")
            if bi is None:
                bi = _cdiv(n_items, 128) * 128
            if _cdiv(n_items, bi) != 1:
                raise NotImplementedError(
                    "only the row layout (bi=None, one full-catalog item "
                    "block) is ported; the diag cell grid is ROADMAP queue "
                    "1, item 2")
            if bu is None:
                # >= 8 stripes keeps the epoch SGD-like; 2560 caps a
                # stripe's [bu, ni_pad] f32 intermediates of the plain
                # version. A 256-row quantum, falling to 8 rows when 256
                # would leave fewer than 8 stripes (the JAX rule)
                target = _cdiv(n_users, 8)
                bu = min(2560, max(_cdiv(target, 256) * 256, 256))
                if _cdiv(n_users, bu) < 8:
                    bu = min(2560, max(_cdiv(target, 8) * 8, 8))
        else:
            bu = 1024 if bu is None else bu
            bi = 1024 if bi is None else bi
        self.dense_codes = dense_codes
        self.bu, self.bi = bu, bi
        self.NU = _cdiv(n_users, bu)
        self.NI = _cdiv(n_items, bi)
        self.n_users_pad = self.NU * bu
        self.n_items_pad = self.NI * bi
        self.r_scale = None

        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        self.nnz = len(r)

        # frequency-balanced relabeling of both axes
        u_freq = np.bincount(r, minlength=n_users)
        i_freq = np.bincount(c, minlength=n_items)
        self.u_perm = _balance_perm(u_freq, n_users, self.NU, bu)
        self.i_perm = _balance_perm(i_freq, n_items, self.NI, bi)
        # inverse over the padded label space; rows outside the perm's
        # image are dead padding (no rating addresses them) and read row 0
        u_inv = np.zeros(self.n_users_pad, np.int64)
        u_inv[self.u_perm] = np.arange(n_users)
        i_inv = np.zeros(self.n_items_pad, np.int64)
        i_inv[self.i_perm] = np.arange(n_items)
        dev = self.device
        self.u_perm_dev = torch.from_numpy(self.u_perm).to(dev)
        self.i_perm_dev = torch.from_numpy(self.i_perm).to(dev)
        self.u_perm_inv_dev = torch.from_numpy(u_inv).to(dev)
        self.i_perm_inv_dev = torch.from_numpy(i_inv).to(dev)

        # model hooks before relabeling (their tables are in old ids)
        rt = torch.from_numpy(r.astype(np.int64))
        ct = torch.from_numpy(c.astype(np.int64))
        w = model.example_weight(rt, ct).cpu().numpy().astype(np.float32)
        self.use_mask = hasattr(model, "pair_rank")
        lam = (model.pair_rank(rt, ct).cpu().numpy().astype(np.int32)
               if self.use_mask else np.full(len(r), model.k, np.int32))
        r = self.u_perm[r]
        c = self.i_perm[c]
        self._resident = None
        self._last_u_view = None
        self._last_i_view = None
        if engine == "dense":
            self._stage_dense(r // bu, (r % bu).astype(np.int32),
                              c.astype(np.int32), v.astype(np.float32), w,
                              self.NU, dense_budget_bytes)
            # the tiles' validity counts, which the stripe kernel reads
            self.counts = stripe_counts(self.R_rows, self.W_rows)
            self._order_gen = torch.Generator().manual_seed(params.seed + 41)
            return
        self._stage_cells(r, c, v.astype(np.float32), w, lam, batch_size)
        self._sched_rng = np.random.default_rng(params.seed + 41)

    # ------------------------------------------------------------------
    def _stage_cells(self, r, c, v, w, lam, batch_size):
        """The one-hot engines' streams (the JAX staging, :467-541):
        ratings sorted by cell, each cell's entries shuffled by
        default_rng(seed * 999983 + cell), padded to S slots (w = 0,
        ids 0, lam 1); collision counts per static batch slice; the row
        layout [NU, NI*S] or the diag layout [n_cells + 1, S], whose last
        row is an all-invalid dummy cell."""
        bu, bi, NU, NI = self.bu, self.bi, self.NU, self.NI
        cell = (r // bu) * NI + c // bi
        n_cells = NU * NI
        counts = np.bincount(cell, minlength=n_cells)
        S0 = max(int(counts.max()) if len(counts) else 1, 1)
        if batch_size is None:
            # ~64k ratings per sequential step over the diag schedule's
            # G = NI lanes (row schedule: 1 lane)
            batch_size = auto_batch_size(
                S0, NI if self.schedule == "diag" else 1)
        S = _cdiv(S0, batch_size) * batch_size
        self.S = S
        self.bs = min(batch_size, S)
        self.pad_frac = n_cells * S / max(self.nnz, 1)

        u_loc = np.zeros((n_cells, S), np.int32)
        i_loc = np.zeros((n_cells, S), np.int32)
        vals = np.zeros((n_cells, S), np.float32)
        wts = np.zeros((n_cells, S), np.float32)
        lams = np.ones((n_cells, S), np.int32)
        order = np.argsort(cell, kind="stable")
        r, c, v, w, lam = r[order], c[order], v[order], w[order], lam[order]
        cell = cell[order]
        pos = np.arange(len(r)) - np.searchsorted(cell, cell, "left")
        u_loc[cell, pos] = (r % bu).astype(np.int32)
        i_loc[cell, pos] = (c % bi).astype(np.int32)
        vals[cell, pos] = v
        wts[cell, pos] = w
        lams[cell, pos] = lam
        # static per-cell shuffle (the stream is row-sorted)
        for cc in np.nonzero(counts > 1)[0]:
            rng = np.random.default_rng(self.params.seed * 999983 + int(cc))
            p = rng.permutation(int(counts[cc]))
            for arr in (u_loc, i_loc, vals, wts, lams):
                arr[cc, : len(p)] = arr[cc, : len(p)][p]
        cnu = cni = None
        if self.collision_norm:
            cnu = stage_batch_collision_counts(wts, u_loc, self.bs, bu)
            cni = stage_batch_collision_counts(wts, i_loc, self.bs, bi)

        if self.schedule == "diag":
            def lay(a, fill):
                return np.concatenate([a, np.full((1, S), fill, a.dtype)])
        else:
            def lay(a, fill):
                return a.reshape(NU, NI * S)
        dev = lambda a, fill: (None if a is None else torch.from_numpy(
            lay(a, fill)).to(self.device))
        self.u_loc, self.i_loc = dev(u_loc, 0), dev(i_loc, 0)
        self.vals, self.wts = dev(vals, 0), dev(wts, 0)
        self.lams = dev(lams, 1)
        self.cnu, self.cni = dev(cnu, 1.0), dev(cni, 1.0)

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
        """This epoch's stripe visiting order (dense engine): a CPU int64
        permutation of range(NU) from the solver's own generator."""
        return torch.randperm(self.NU, generator=self._order_gen)

    def _build_schedule(self):
        """Row schedule (the JAX numpy draws, bit for bit): a random
        user-row order, a random cell order within each row, a random
        batch offset within each cell."""
        rng = self._sched_rng
        row_of = rng.permutation(self.NU).astype(np.int32)
        ib_seq = np.stack([rng.permutation(self.NI)
                           for _ in range(self.NU)]).astype(np.int32)
        boff = rng.integers(0, max(self.S // self.bs, 1),
                            size=(self.NU, self.NI)).astype(np.int32)
        return row_of, ib_seq, boff

    def draw_schedule(self):
        """This epoch's schedule for ``epoch_with``: (row_of, ib_seq, boff)
        or, for the diag schedule, (ub_idx, ib_idx, boff) from a
        ``torch.Generator`` seeded by one draw of the numpy schedule rng,
        the draw the JAX solver makes for its PRNG key."""
        if self.schedule == "diag":
            seed = int(self._sched_rng.integers(2**31))
            return diag_schedule(torch.Generator().manual_seed(seed),
                                 self.NU, self.NI, self.S // self.bs)
        return self._build_schedule()

    def internal_state(self) -> dict:
        """What an exact resume needs besides the factor tables."""
        if self.engine == "dense":
            return {"order_gen": self._order_gen.get_state().numpy()}
        return {"sched_rng": np.asarray(json.dumps(
            self._sched_rng.bit_generator.state))}

    def set_internal_state(self, st: dict) -> None:
        if "order_gen" in st:
            self._order_gen.set_state(
                torch.from_numpy(np.asarray(st["order_gen"], np.uint8)))
        if "sched_rng" in st:
            self._sched_rng.bit_generator.state = json.loads(
                str(st["sched_rng"]))

    def stage_factors(self, state: MFState):
        """Fresh f32 tables in the relabeled, padded layout,
        staged[new] = logical[inv[new]]: (u3 [NU, bu, k], i_tab
        [ni_pad, k]) for the dense engine, (u_tab [NU*bu, k], i_tab
        [NI*bi, k]) for the one-hot engines."""
        k = state.u_fac.shape[1]
        u = state.u_fac[self.u_perm_inv_dev].to(torch.float32)
        i = state.i_fac[self.i_perm_inv_dev].to(torch.float32)
        if self.engine == "dense":
            u = u.reshape(self.NU, self.bu, k)
        return u.contiguous(), i.contiguous()

    def _tables(self, state: MFState):
        if (self._resident is not None
                and state.u_fac is self._last_u_view
                and state.i_fac is self._last_i_view):
            return self._resident
        return self.stage_factors(state)

    def _views(self, state: MFState, u_tab, i_tab) -> MFState:
        self._resident = (u_tab, i_tab)
        k = u_tab.shape[-1]
        # logical[old] = staged[perm[old]]
        u_view = u_tab.reshape(self.n_users_pad, k)[self.u_perm_dev]
        i_view = i_tab[self.i_perm_dev]
        # keep the POST-cast tensors: the identity check in _tables must
        # see exactly what the state holds
        u_ret = u_view.to(state.u_fac.dtype)
        i_ret = i_view.to(state.i_fac.dtype)
        self._last_u_view, self._last_i_view = u_ret, i_ret
        return state._replace(u_fac=u_ret, i_fac=i_ret)

    @property
    def streams(self):
        """The one-hot engines' staged streams, in the kernel's order."""
        return (self.u_loc, self.i_loc, self.vals, self.wts, self.cnu,
                self.cni, self.lams if self.use_mask else None)

    def sweep_kwargs(self) -> dict:
        return dict(bs=self.bs, bu=self.bu, bi=self.bi, NI=self.NI,
                    u_reg=float(self.params.u_reg),
                    i_reg=float(self.params.i_reg),
                    collision_norm=self.collision_norm,
                    use_mask=self.use_mask, mm_bf16=self.mm_bf16)

    def epoch(self, state: MFState, lr: float) -> MFState:
        if self.engine != "dense":
            return self.epoch_with(state, lr, self.draw_schedule())
        u3, i_tab = self._tables(state)
        dense_rows_epoch(u3, i_tab, self._stripe_order(), lr, self.R_rows,
                         self.W_rows, self.r_scale,
                         float(self.params.u_reg), float(self.params.i_reg),
                         self.collision_norm, self.mm_bf16,
                         counts=self.counts)
        return self._views(state, u3, i_tab)

    def epoch_with(self, state: MFState, lr: float, schedule) -> MFState:
        """One one-hot epoch on the given schedule (``draw_schedule``'s
        form; the tests pass the JAX solver's own)."""
        if self.engine == "dense":
            raise ValueError("epoch_with takes the one-hot engines' "
                             "schedules")
        u_tab, i_tab = self._tables(state)
        sweep = (block_sgd_diag_epoch if self.schedule == "diag"
                 else block_sgd_epoch)
        sweep(u_tab, i_tab, *schedule, lr, *self.streams,
              **self.sweep_kwargs())
        return self._views(state, u_tab, i_tab)
