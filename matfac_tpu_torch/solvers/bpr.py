"""BPR pairwise-ranking SGD with CSR gap negative sampling (port of
matfac_tpu/solvers/bpr.py).

ModelMFBPR::train / trainHogPosNeg (modelMFBPR.cpp:245-722). Positives are
train entries with rating > 0 and valid user and item (getBPRUIRatings,
modelMFBPR.cpp:46-58), shuffled once on the host with
``default_rng(params.seed)``; an epoch walks the batches of that stream in
a random order. Negatives come from the reference's CSR gap trick
(sampleNegItem, modelMFBPR.cpp:191-242), up to ``n_tries`` tries; a
positive whose tries all fail is dropped (weight 0). Two stream samplers,
as in the JAX package:

  * ``gap``: the literal sampler. A try draws jj ~ U[0, deg_u); an explicit
    zero rating there is taken; else j ~ U[the gap after rated item jj)
    and j is kept if it is a train item.
  * ``rankgap`` (default): the same gap, but the draw is uniform over the
    train items in the gap (a rank into the sorted train-item list), so a
    try fails only on an empty gap.

``mode="posneg"`` samples a random train user, a random positive of the
user's row and a negative that is a lower-rated item or a gap item
(samplePosNegItem, modelMFBPR.cpp:61-132).

The pairwise step (modelMFBPR.cpp:501-521), batched, from the factors at
the batch's start: r_uij = <p_u, q_p - q_n>, c = -1 / (1 + e^r_uij),
p_u -= lr (c (q_p - q_n) + 2 u_reg p_u), q_p -= lr (c p_u + 2 i_reg q_p),
q_n -= lr (-c p_u + 2 i_reg q_n); duplicates add up (``index_add_``, as
``.at[].add``), the item scatter over the fused [p; neg] index. A model
with a triple rank mask (the BPR x TMF+Poisson hybrid) masks p_u in r_uij
and all three gradients; the mask of each step is drawn from the solver's
second generator (``mask_gen``), or given to ``epoch_with``.

What the port keeps from the JAX package: each epoch's randomness is one
batch order ``border`` [n_batches] and one tensor of 32-bit random words
``bits`` of the JAX shapes ((n_batches, 2, n_tries, B) in stream mode,
(n_batches, 2 + 2 n_tries, B) in posneg mode), drawn from the solver's own
``torch.Generator`` (``draw``). ``epoch_with`` takes them as given, so a
test can feed the draws of ``jax.random``. torch has no general uint32
arithmetic: the words are int64 in [0, 2^32), and ``bits % deg`` in int64
equals the JAX uint32 result. What it leaves: the f32-packed one-gather
CSR rows (a TPU per-index-cost device; the port gathers int64 columns).

The epoch updates the state's factor tables IN PLACE (the JAX epoch
donates them), and returns the state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import MFState

_WORD = 1 << 32


def bpr_pair_terms(pu, qp, qn, w, u_reg: float, i_reg: float, m=None):
    """Batched pairwise BPR loss and analytic gradients
    (modelMFBPR.cpp:501-521) of the per-triple loss

        w * [ ln(1 + e^{-r_uij}) + u_reg ||pu ⊙ m||^2
              + i_reg (||qp ⊙ m||^2 + ||qn ⊙ m||^2) ]

    with r_uij = <pu ⊙ m, qp − qn>; ``m`` is the [B, k] triple rank mask,
    None (all ones) for plain BPR. Returns (gu, gp, gn, r_uij, loss_sum);
    loss_sum is the data term only, computed as logaddexp(0, -r) so it
    stays finite at |r| ~ 1e3 in f32."""
    pm = pu if m is None else pu * m
    r_uij = (pm * qp).sum(dim=1) - (pm * qn).sum(dim=1)
    loss_sum = (w * torch.logaddexp(torch.zeros_like(r_uij), -r_uij)).sum()
    coeff = w * (-1.0 / (1.0 + torch.exp(r_uij)))
    gu = coeff[:, None] * (qp - qn) + 2.0 * u_reg * w[:, None] * pu
    gp = coeff[:, None] * pu + 2.0 * i_reg * w[:, None] * qp
    gn = -coeff[:, None] * pu + 2.0 * i_reg * w[:, None] * qn
    if m is not None:
        gu, gp, gn = gu * m, gp * m, gn * m
    return gu, gp, gn, r_uij, loss_sum


class BPRSolver:
    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 batch_size: Optional[int] = None, n_tries: int = 2,
                 mode: str = "stream", sampler: str = "rankgap",
                 device="cuda"):
        """mode="stream": all positives every epoch (train,
        modelMFBPR.cpp:405-559); mode="posneg": trainHogPosNeg. sampler
        "rankgap" | "gap" picks the stream-mode negative sampler; posneg
        always uses the literal gap sampler."""
        if sampler not in ("rankgap", "gap"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if mode not in ("stream", "posneg"):
            raise ValueError(f"unknown mode {mode!r}")
        self.model = model
        self.params = params
        self.n_tries = n_tries
        self.mode = mode
        self.sampler = sampler
        self.device = torch.device(device)
        dev = self.device
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        bs = batch_size or params.batch_size
        self.n_items = int(model.n_items)

        # positives: rating > 0, valid entities; one static host shuffle
        r, c, v = train_mat.to_coo()
        keep = (v > 0) & ~invalid_users[r] & ~invalid_items[c]
        pr, pc = r[keep], c[keep]
        sperm = np.random.default_rng(params.seed).permutation(len(pr))
        pr, pc = pr[sperm], pc[sperm]
        n = len(pr)
        n_pad = (-n) % bs if n else bs
        pr_pad = np.concatenate([pr, np.zeros(n_pad, np.int64)]
                                ).astype(np.int64)
        self.pos_u = as_t(pr_pad)
        self.pos_i = as_t(np.concatenate([pc, np.zeros(n_pad, np.int64)]
                                         ).astype(np.int64))
        self.pos_valid = as_t(np.concatenate(
            [np.ones(n, np.float32), np.zeros(n_pad, np.float32)]))
        # (start, deg) of each positive's user row: batch contents are
        # static, only the batch order is random
        ip = train_mat.indptr.astype(np.int64)
        starts = ip[pr_pad]
        self.pos_start = as_t(starts)
        self.pos_deg = as_t(np.maximum(ip[pr_pad + 1] - starts, 1))
        self.n_pos = n
        self.batch_size = bs
        self.n_batches = len(pr_pad) // bs

        # the full train rows (explicit zeros included), sorted per row
        nnz = train_mat.nnz
        cols = train_mat.indices.astype(np.int64)
        self.nnz = nnz
        self.csr_cols = as_t(cols)
        self.csr_vals = as_t(train_mat.values.astype(np.float32))
        nxt = cols.copy()
        if nnz:
            nxt[:-1] = cols[1:]
        self.csr_next = as_t(nxt)   # next column; the last entry: itself
        # items with >= 1 train rating (trainItems, modelMFBPR.cpp:442-448)
        ti = np.zeros(self.n_items, bool)
        deg_i = train_mat.col_degrees()
        ti[: len(deg_i)] = deg_i[: self.n_items] > 0
        self.train_items = as_t(ti)

        if sampler == "rankgap" and mode == "stream":
            # per CSR entry e the candidate gap when jj lands on e:
            #   jj==0 -> [0, col_e); jj==deg-1 -> [col_e+1, n_items);
            #   else [col_e+1, next_col)   (modelMFBPR.cpp:211-219; jj==0
            # wins for single-entry rows), as (first rank, count) into the
            # sorted train-item list
            deg_full = np.diff(ip)
            row_id = np.repeat(np.arange(len(deg_full)), deg_full)
            idx_in_row = np.arange(nnz) - ip[row_id]
            first = idx_in_row == 0
            last = idx_in_row == deg_full[row_id] - 1
            lo = np.where(first, 0, cols + 1)
            hi = np.where(first, cols, np.where(last, self.n_items, nxt))
            cum = np.zeros(self.n_items + 1, np.int64)
            np.cumsum(ti, out=cum[1:])
            self.cum_lo = as_t(cum[lo])
            self.cnt = as_t(cum[hi] - cum[lo])
            sel = np.nonzero(ti)[0].astype(np.int64)
            self.sel_items = as_t(sel if len(sel) else np.zeros(1, np.int64))
        deg_u = train_mat.row_degrees()
        tu = np.nonzero((deg_u > 0) & ~invalid_users[: train_mat.nrows])[0]
        self.train_users = as_t(tu.astype(np.int64))
        if mode == "posneg":
            self.train_user_start = as_t(ip[tu])
            self.train_user_deg = as_t(np.maximum(ip[tu + 1] - ip[tu], 1))
        self.generator = torch.Generator(device=dev).manual_seed(params.seed)
        # the triple rank masks of a sampled-rank model are drawn where the
        # indices live
        self.mask_gen = torch.Generator(device=dev).manual_seed(
            params.seed + 47)
        self.last_loss = torch.zeros((), device=dev)
        self.last_inversions = torch.zeros((), dtype=torch.int64, device=dev)

    # ------------------------------------------------------------------
    def _row(self, pos: torch.Tensor):
        """(col, val, next col) of CSR entries; positions past the end
        clamp, as JAX gathers do."""
        pos = pos.clamp(0, max(self.nnz - 1, 0))
        return self.csr_cols[pos], self.csr_vals[pos], self.csr_next[pos]

    def _gap_try(self, start, deg, b_jj, b_m, explicit_of):
        """One try of the literal gap sampler: (candidate, ok)."""
        jj = b_jj % deg
        item_jj, val_jj, next_item = self._row(start + jj)
        explicit = explicit_of(val_jj)
        lo = torch.where(jj == 0, 0, item_jj + 1)
        hi = torch.where(jj == 0, item_jj,
                         torch.where(jj == deg - 1, self.n_items, next_item))
        span = torch.clamp(hi - lo, min=1)
        j = lo + b_m % span
        gap_ok = (hi - lo > 0) & self.train_items[
            j.clamp(0, self.n_items - 1)]
        return torch.where(explicit, item_jj, j), explicit | gap_ok

    def sample_gap(self, start, deg, jj_bits, j_bits):
        """Literal gap sampler (modelMFBPR.cpp:191-242): jj_bits, j_bits
        [n_tries, B] words. Returns (neg [B] int64, ok [B] bool)."""
        neg = torch.zeros_like(start)
        ok = torch.zeros(start.shape, dtype=torch.bool, device=start.device)
        for t in range(jj_bits.shape[0]):
            cand, cand_ok = self._gap_try(start, deg, jj_bits[t], j_bits[t],
                                          lambda val: val == 0.0)
            neg = torch.where(cand_ok & ~ok, cand, neg)
            ok = ok | cand_ok
        return neg, ok

    def sample_rankgap(self, start, deg, jj_bits, j_bits):
        """Rank-gap sampler (module docstring). Returns (neg, ok)."""
        B = start.shape[0]
        pos = (start[None, :] + jj_bits % deg[None, :]).clamp(
            0, max(self.nnz - 1, 0))
        vr = torch.zeros(B, dtype=torch.int64, device=start.device)
        is_rank = torch.zeros(B, dtype=torch.bool, device=start.device)
        ok = torch.zeros(B, dtype=torch.bool, device=start.device)
        for t in range(jj_bits.shape[0]):
            p = pos[t]
            explicit = self.csr_vals[p] == 0.0
            cnt = self.cnt[p]
            gap_ok = cnt > 0
            m = j_bits[t] % torch.clamp(cnt, min=1)
            cand_vr = torch.where(explicit, self.csr_cols[p],
                                  self.cum_lo[p] + m)
            cand_ok = explicit | gap_ok
            take = cand_ok & ~ok
            vr = torch.where(take, cand_vr, vr)
            is_rank = torch.where(take, ~explicit & gap_ok, is_rank)
            ok = ok | cand_ok
        n_sel = self.sel_items.shape[0]
        neg = torch.where(is_rank, self.sel_items[vr.clamp(0, n_sel - 1)],
                          vr)
        return neg, ok

    def sample_posneg(self, bb):
        """One posneg batch from its words bb [2 + 2 n_tries, B]: (u, p,
        neg, w) with w = positive rated > 0 and a negative found
        (samplePosNegItem, modelMFBPR.cpp:61-132)."""
        nt = self.n_tries
        u_idx = bb[0] % self.train_users.shape[0]
        u = self.train_users[u_idx]
        start = self.train_user_start[u_idx]
        deg = self.train_user_deg[u_idx]
        p, pos_rat, _ = self._row(start + bb[1] % deg)
        neg = torch.zeros_like(u)
        ok = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
        for t in range(nt):
            # an explicit negative is a lower-rated item (:88)
            cand, cand_ok = self._gap_try(start, deg, bb[2 + t],
                                          bb[2 + nt + t],
                                          lambda val: val < pos_rat)
            neg = torch.where(cand_ok & ~ok, cand, neg)
            ok = ok | cand_ok
        return u, p, neg, ((pos_rat > 0) & ok).to(torch.float32)

    # ------------------------------------------------------------------
    def draw(self):
        """This epoch's (border, bits) from the solver's generator: the
        JAX package's shapes, words in [0, 2^32) as int64. posneg draws no
        batch order (border None)."""
        g, dev, nb, B = self.generator, self.device, self.n_batches, \
            self.batch_size
        if self.mode == "posneg":
            shape = (nb, 2 + 2 * self.n_tries, B)
            return None, torch.randint(0, _WORD, shape, generator=g,
                                       device=dev, dtype=torch.int64)
        border = torch.randperm(nb, generator=g, device=dev)
        bits = torch.randint(0, _WORD, (nb, 2, self.n_tries, B),
                             generator=g, device=dev, dtype=torch.int64)
        return border, bits

    def internal_state(self) -> dict:
        """What an exact resume needs besides the factor tables: both
        generators."""
        return {"gen": self.generator.get_state().cpu().numpy(),
                "mask_gen": self.mask_gen.get_state().cpu().numpy()}

    def set_internal_state(self, st: dict) -> None:
        as_state = lambda a: torch.from_numpy(np.asarray(a, np.uint8))
        if "gen" in st:
            self.generator.set_state(as_state(st["gen"]))
        if "mask_gen" in st:
            self.mask_gen.set_state(as_state(st["mask_gen"]))

    def _step(self, st: MFState, u, p, neg, w, lr: float, m=None):
        params = self.params
        if m is None:
            m = self.model.triple_rank_mask(u, p, neg,
                                            generator=self.mask_gen)
        pu, qp, qn = st.u_fac[u], st.i_fac[p], st.i_fac[neg]
        gu, gp, gn, r_uij, loss = bpr_pair_terms(
            pu, qp, qn, w, float(params.u_reg), float(params.i_reg), m)
        inv = ((-r_uij > float(params.eps)) & (w > 0)).sum()
        st.u_fac.index_add_(0, u, (-lr * gu).to(st.u_fac.dtype))
        st.i_fac.index_add_(0, torch.cat([p, neg]),
                            (-lr * torch.cat([gp, gn])).to(st.i_fac.dtype))
        return loss, inv

    def epoch_with(self, state: MFState, lr: float, border, bits,
                   masks=None) -> MFState:
        """One epoch on the given draws (see ``draw``). ``masks``: the
        triple rank mask of each step, [B, k] 0/1 (step t uses masks[t]),
        in place of the model's, e.g. the draws of the JAX engine; None asks
        the model (a sampled-rank model draws from ``mask_gen``)."""
        loss = torch.zeros((), device=self.device)
        inv = torch.zeros((), dtype=torch.int64, device=self.device)
        B = self.batch_size
        bits = bits.to(self.device)
        mask_of = lambda t: (None if masks is None else torch.as_tensor(
            masks[t], dtype=torch.float32, device=self.device))
        if self.mode == "posneg":
            for b in range(self.n_batches):
                bl, bi = self._step(state, *self.sample_posneg(bits[b]), lr,
                                    mask_of(b))
                loss, inv = loss + bl, inv + bi
        else:
            # step t takes batch border[t] and the words bits[t]
            for t, b in enumerate(border.tolist()):
                sl = slice(b * B, (b + 1) * B)
                start, deg = self.pos_start[sl], self.pos_deg[sl]
                if self.sampler == "rankgap":
                    neg, ok = self.sample_rankgap(start, deg, bits[t, 0],
                                                  bits[t, 1])
                else:
                    neg, ok = self.sample_gap(start, deg, bits[t, 0],
                                              bits[t, 1])
                w = self.pos_valid[sl] * ok.to(torch.float32)
                bl, bi = self._step(state, self.pos_u[sl], self.pos_i[sl],
                                    neg, w, lr, mask_of(t))
                loss, inv = loss + bl, inv + bi
        self.last_loss, self.last_inversions = loss, inv
        return state

    def epoch(self, state: MFState, lr: float) -> MFState:
        return self.epoch_with(state, lr, *self.draw())
