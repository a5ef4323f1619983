"""CCD++ and per-entity CCD: coordinate descent by segment sums (port of
matfac_tpu/solvers/ccd.py).

ModelMF::trainCCDPP (modelMF.cpp:931-1169), trainCCDPPFreqAdap
(modelMF.cpp:1172-1423) and trainCCD (modelMF.cpp:1426-1653). The residual
is one COO value vector, carried across epochs; both the user- and the
item-side closed-form 1-D updates are segment sums over it:

    u_k(u) = sum_i res_ui v_k(i) / (uReg + sum_i v_k(i)^2)

CCD++ (Yu et al.'s rank-1 sweeps): for each latent dim, in a shuffled
order, add the dim's contribution back to the residual, run 5 inner
user / item alternations, subtract the new contribution. With
``group_dims`` g > 1 a sweep updates g dims together by per-entity g x g
solves. The freq-adaptive variant zeroes v_k (k > 0) for items below a
frequency threshold (hard rank truncation, modelMF.cpp:1336-1343).
Per-entity CCD: one user sweep over all dims (add-back folded into the
numerator), then one item sweep.

Plain PyTorch on the device of the staged stream: JAX computes these with
XLA segment sums, not a Pallas kernel. The stream is staged once, sorted
by user, with the permutation to the item-sorted view; every segment sum
is a contiguous reduction over one of the two views
(``torch.segment_reduce`` of one float64 column at a time, rounded to f32
once), so an epoch involves no atomics and repeats bit for bit on the
card. JAX's TPU-only machinery (``nnz_chunk`` passes, ``sweep_mode``,
``dim_chunk``, sentinel padding, the TwoSum-compensated f32 scan) is not
carried over; its constructors' arguments for it are accepted and
ignored. Draws (the dims' order) come from the solver's own generator
(``draw``); ``epoch_with`` takes them, e.g. JAX's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import MFState


def segment_sums(cols: Sequence[torch.Tensor],
                 bounds: torch.Tensor) -> torch.Tensor:
    """Sums of the W columns ``cols`` (each [n]) over the contiguous
    segments that start at ``bounds`` [n_seg + 1] (int64, bounds[-1] = n):
    [n_seg, W] f32, each column reduced in float64 and rounded once. One
    1-D column a call: a 2-D input would take PyTorch's per-segment loop
    instead of CUB's segmented reduction."""
    return torch.stack(
        [torch.segment_reduce(c.double(), "sum", offsets=bounds, unsafe=True)
         for c in cols], dim=1).float()


def _chol_solve_unrolled(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve [n, g, g] SPD systems by an unrolled Cholesky-Crout and two
    triangular solves, each step an elementwise op over [n] vectors (JAX's
    ``_chol_solve_unrolled``, with its max(s, 1e-30) pivot floor)."""
    g = b.shape[1]
    L = [[None] * g for _ in range(g)]
    for j in range(g):
        s = G[:, j, j] - sum((L[j][p] ** 2 for p in range(j)), 0.0)
        L[j][j] = torch.sqrt(torch.clamp_min(s, 1e-30))
        for i2 in range(j + 1, g):
            s2 = G[:, i2, j] - sum((L[i2][p] * L[j][p] for p in range(j)),
                                   0.0)
            L[i2][j] = s2 / L[j][j]
    y = [None] * g
    for i2 in range(g):
        y[i2] = (b[:, i2] - sum((L[i2][p] * y[p] for p in range(i2)),
                                0.0)) / L[i2][i2]
    x = [None] * g
    for i2 in reversed(range(g)):
        x[i2] = (y[i2] - sum((L[p][i2] * x[p] for p in range(i2 + 1, g)),
                             0.0)) / L[i2][i2]
    return torch.stack(x, dim=1)


class CCDPPSolver:
    """Rank-1 (or rank-g) coordinate-descent sweeps. Carries the residual
    across epochs (the reference carries ``res`` too)."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 n_inner: int = 5, freq_adaptive: bool = False,
                 freq_thresh: float = 75.0, item_freq=None,
                 engine: str = "sorted", group_dims: int = 1,
                 device="cuda", **_):
        """``engine``: JAX's "sorted" (contiguous segment reductions over
        the user- and item-sorted views) or "scatter" (``segment_sum``).
        In the port both reduce in sorted order: the argument keeps JAX's
        values and guard and selects nothing else.

        ``group_dims`` (sorted engine only): g dims a sweep as one rank-g
        block update with per-entity g x g solves; fac_dim must be
        divisible by g.

        ``freq_adaptive``: dims > 0 of items whose frequency
        (``item_freq``, default the train column degrees) is below
        ``freq_thresh`` stay 0; dim 0 is always allowed."""
        self.model = model
        self.params = params
        self.device = torch.device(device)
        self.n_users = int(model.n_users)
        self.n_items = int(model.n_items)
        self.n_inner = n_inner
        if engine not in ("sorted", "scatter"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.g = max(int(group_dims), 1)
        if self.g > 1:
            if engine != "sorted":
                raise ValueError("group_dims > 1 needs engine='sorted'")
            if model.k % self.g:
                raise ValueError(f"fac_dim={model.k} not divisible by "
                                 f"group_dims={self.g}")
        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        # user-sorted stream (to_coo of a CSR already is), then the
        # permutation to the item-sorted view
        order = np.argsort(r, kind="stable")
        r, c, v = r[order], c[order], v[order]
        col_order = np.argsort(c, kind="stable")
        t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(
            self.device)
        self.rows, self.cols = t(r), t(c)
        self.vals = torch.from_numpy(v.astype(np.float32)).to(self.device)
        self.col_order = t(col_order)
        self.rows_cs, self.cols_cs = t(r[col_order]), t(c[col_order])
        self.row_bounds = t(np.searchsorted(r, np.arange(self.n_users + 1)))
        self.col_bounds = t(np.searchsorted(c[col_order],
                                            np.arange(self.n_items + 1)))
        self.res: Optional[torch.Tensor] = None
        if freq_adaptive:
            if item_freq is None:
                item_freq = train_mat.col_degrees().astype(np.float64)
            fa = np.zeros(self.n_items, np.float32)
            fa[: len(item_freq)] = (item_freq >= freq_thresh)
            self.item_dim_ok = torch.from_numpy(fa).to(self.device)
        else:
            self.item_dim_ok = None
        if self.g > 1:
            # packed slot of (a, b), row-major over the upper triangle
            iu, il = np.triu_indices(self.g)
            pos = np.zeros((self.g, self.g), np.int64)
            pos[iu, il] = np.arange(len(iu))
            pos[il, iu] = pos[iu, il]
            self._unpack = t(pos.reshape(-1))
        self._gen = torch.Generator().manual_seed(params.seed + 59)
        self._initialized = False

    # -- draws, resume, rollback ---------------------------------------
    def draw(self) -> torch.Tensor:
        """This epoch's order of the dims: a permutation of range(k) from
        the solver's generator."""
        return torch.randperm(self.model.k, generator=self._gen)

    def reset(self) -> None:
        """Start again from u = 0 and the residual = the ratings (the
        train loop's NaN rollback)."""
        self._initialized = False
        self.res = None

    def internal_state(self) -> dict:
        """What an exact resume needs besides the tables: the generator,
        and the residual once an epoch has run."""
        st = {"gen": self._gen.get_state().numpy()}
        if self._initialized:
            st["res"] = self.res.cpu()
        return st

    def set_internal_state(self, d: dict) -> None:
        """Loads a residual of another staged length too (JAX's is padded
        with zeros to its ``seg_block`` multiple): padded or cropped."""
        if "gen" in d:
            self._gen.set_state(torch.from_numpy(np.asarray(d["gen"],
                                                            np.uint8)))
        if "res" in d:
            res = torch.from_numpy(np.array(d["res"], np.float32))
            n = int(self.vals.shape[0])
            if res.shape[0] < n:
                res = torch.cat([res, res.new_zeros(n - res.shape[0])])
            self.res = res[:n].to(self.device)
            self._initialized = True

    # -- epochs ---------------------------------------------------------
    def epoch(self, state: MFState, lr: float) -> MFState:
        return self.epoch_with(state, lr, self.draw())

    def _start(self, state: MFState):
        """The tables this epoch updates (copies) and the residual; at the
        first epoch u = 0 (modelMF.cpp:1020), so the residual is the
        ratings."""
        if not self._initialized:
            state = state._replace(u_fac=torch.zeros_like(state.u_fac))
            self.res = self.vals.clone()
            self._initialized = True
        return state, state.u_fac.clone(), state.i_fac.clone()

    def epoch_with(self, state: MFState, lr: float,
                   dims: Sequence[int]) -> MFState:
        """One epoch with the dims in the order ``dims`` (a permutation of
        range(k); taken g at a time when group_dims = g > 1)."""
        del lr
        state, u_fac, i_fac = self._start(state)
        res = self.res
        for dg in np.asarray(dims, np.int64).reshape(-1, self.g).tolist():
            if self.g > 1:
                res = self._group_sweep(u_fac, i_fac, res, dg)
            else:
                res = self._dim_sweep(u_fac, i_fac, res, dg[0])
        self.res = res
        return state._replace(u_fac=u_fac, i_fac=i_fac)

    def _dim_sweep(self, u_fac, i_fac, res, kk: int) -> torch.Tensor:
        """One rank-1 sweep of dim kk (in place on the tables); returns
        the new residual."""
        u_reg, i_reg = float(self.params.u_reg), float(self.params.i_reg)
        u_k, v_k = u_fac[:, kk].float(), i_fac[:, kk].float()
        # the dim-removed residual, in both views (a no-op add at the first
        # epoch, where u = 0: the iter > 0 gate of modelMF.cpp:1036)
        resn = res + u_k[self.rows] * v_k[self.cols]
        resn_cs = resn[self.col_order]
        for _ in range(self.n_inner):
            vg = v_k[self.cols]
            su = segment_sums((resn * vg, vg * vg), self.row_bounds)
            u_k = su[:, 0] / (u_reg + su[:, 1])
            ug = u_k[self.rows_cs]
            si = segment_sums((resn_cs * ug, ug * ug), self.col_bounds)
            v_k = si[:, 0] / (i_reg + si[:, 1])
        if self.item_dim_ok is not None and kk != 0:
            v_k = v_k * self.item_dim_ok
        u_fac[:, kk] = u_k.to(u_fac.dtype)
        i_fac[:, kk] = v_k.to(i_fac.dtype)
        return resn - u_k[self.rows] * v_k[self.cols]

    def _solve(self, su: torch.Tensor, reg: float,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """su [n_seg, P + g] (packed Gram | b) -> [n_seg, g] solutions of
        (Gram + reg I) x = b; ``mask`` [n_seg, g] removes truncated
        (entity, dim) slots (their rows / columns masked, unit diagonal)."""
        g, P = self.g, su.shape[1] - self.g
        eye = torch.eye(g, dtype=torch.float32, device=su.device)
        G = su[:, :P].index_select(1, self._unpack) + reg * eye.reshape(1, -1)
        G = G.reshape(-1, g, g)
        b = su[:, P:]
        if mask is not None:
            mm = mask[:, :, None] * mask[:, None, :]
            G = G * mm + (1.0 - mm) * eye[None]
            b = b * mask
        x = _chol_solve_unrolled(G, b)
        return x if mask is None else x * mask

    def _gather(self, tab, idx):
        """The g columns of tab[idx], each gathered on its own: one [n, g]
        row gather of 16-byte rows took 4.8 ms at 7.9M entries, a 1-D gather
        ~0.06 ms (H100 80GB HBM3, 700 W)."""
        return [tab[:, a][idx] for a in range(self.g)]

    def _integrand(self, resv, tab, idx):
        """The P + g columns of the packed t (x) t | resv * t, t = tab[idx]:
        the grouped Gram / b integrand."""
        t = self._gather(tab, idx)
        g = self.g
        return ([t[a] * t[b] for a in range(g) for b in range(a, g)]
                + [resv * t[a] for a in range(g)])

    def _pred(self, U, V):
        """sum_a U[rows, a] V[cols, a]: the group's part of each rating."""
        return sum(u * v for u, v in zip(self._gather(U, self.rows),
                                          self._gather(V, self.cols)))

    def _group_sweep(self, u_fac, i_fac, res, dims_g) -> torch.Tensor:
        """One rank-g block sweep of the dims ``dims_g`` (in place on the
        tables); returns the new residual."""
        u_reg, i_reg = float(self.params.u_reg), float(self.params.i_reg)
        dg = torch.as_tensor(dims_g, dtype=torch.int64, device=self.device)
        U, V = u_fac[:, dg].float(), i_fac[:, dg].float()
        v_mask = None
        if self.item_dim_ok is not None:
            # dim 0 always allowed; the other dims only for frequent items
            v_mask = torch.where(dg[None, :] == 0, 1.0,
                                 self.item_dim_ok[:, None])
        resn = res + self._pred(U, V)
        resn_cs = resn[self.col_order]
        for _ in range(self.n_inner):
            U = self._solve(segment_sums(
                self._integrand(resn, V, self.cols), self.row_bounds), u_reg)
            V = self._solve(segment_sums(
                self._integrand(resn_cs, U, self.rows_cs), self.col_bounds),
                i_reg, v_mask)
        u_fac[:, dg] = U.to(u_fac.dtype)
        i_fac[:, dg] = V.to(i_fac.dtype)
        return resn - self._pred(U, V)


class CCDSolver(CCDPPSolver):
    """Per-entity CCD (trainCCD): a user sweep over all dims, then an item
    sweep over all dims, each in its own shuffled order, the add-back
    folded into the numerator. u starts at 0 (modelMF.cpp:1520-1526).
    ``draw`` returns both orders; ``epoch_with`` takes them."""

    def __init__(self, *args, **kw):
        kw.pop("n_inner", None)
        kw.setdefault("engine", "scatter")
        super().__init__(*args, n_inner=1, **kw)

    def draw(self):
        """(user-sweep order, item-sweep order), two permutations of
        range(k)."""
        return (torch.randperm(self.model.k, generator=self._gen),
                torch.randperm(self.model.k, generator=self._gen))

    def epoch_with(self, state: MFState, lr: float, dims) -> MFState:
        del lr
        dims_u, dims_i = (np.asarray(d, np.int64).tolist() for d in dims)
        state, u_fac, i_fac = self._start(state)
        u_reg, i_reg = float(self.params.u_reg), float(self.params.i_reg)
        rows, cols, res = self.rows, self.cols, self.res
        for kk in dims_u:
            u_k, vg = u_fac[:, kk].float(), i_fac[:, kk].float()[cols]
            su = segment_sums(((res + u_k[rows] * vg) * vg, vg * vg),
                              self.row_bounds)
            new_u = su[:, 0] / (u_reg + su[:, 1])
            res = res - (new_u[rows] - u_k[rows]) * vg
            u_fac[:, kk] = new_u.to(u_fac.dtype)
        # the item sweep on the item-sorted view of the residual (the same
        # values, entry by entry), put back in user order after
        rows, cols, res = self.rows_cs, self.cols_cs, res[self.col_order]
        for kk in dims_i:
            v_k, ug = i_fac[:, kk].float(), u_fac[:, kk].float()[rows]
            si = segment_sums(((res + ug * v_k[cols]) * ug, ug * ug),
                              self.col_bounds)
            new_v = si[:, 0] / (i_reg + si[:, 1])
            res = res - ug * (new_v[cols] - v_k[cols])
            i_fac[:, kk] = new_v.to(i_fac.dtype)
        self.res = torch.empty_like(res)
        self.res[self.col_order] = res
        return state._replace(u_fac=u_fac, i_fac=i_fac)
