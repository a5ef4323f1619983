"""The stream-BPR engine's batch (``solvers/bpr.py``): two host calls a
batch on the card, the eager chain on the CPU.

A batch of positives (u, p) samples its negatives n by the rank-gap
sampler (the solver's docstring) and applies the pairwise step
(modelMFBPR.cpp:501-521) at the batch's starting values:

    r   = <p_u o m, q_p> - <p_u o m, q_n>,  c = -w / (1 + e^r)
    g_u = (c (q_p - q_n) + 2 u_reg w p_u) o m
    g_p = (c p_u + 2 i_reg w q_p) o m,  g_n = (-c p_u + 2 i_reg w q_n) o m

then adds -lr g to the rows of every triple in a fixed order
(``ops/scatter.py``): the user side by the batch's staged plan, the item
side over the fused index [p; n]. w is the positive's valid flag times
whether a negative was found, m the model's triple rank mask (all ones
where it has none). The batch's loss sum(w logaddexp(0, -r)) and its
inversions (-r > eps and w > 0) are added to the epoch's two sums.

``bpr_sample_plain`` and ``bpr_step_plain`` are those steps as eager
PyTorch ops, the engine's route on the CPU (the CPU parity tests against
JAX keep their bits) and the yardstick on the card. ``BPRStep`` holds one
solver's staged positives, CSR rows and rank-gap tables: ``epoch(U, I,
lr, bits, loss, inv)`` checks the tables once and returns the epoch's
``(sample, step)``. On CPU tables they run the plain versions on batch b's
slices; on CUDA tables each is one call of ``csrc/bpr_step.cu``:
``sample(t, b)`` the sampler's kernel, ``step(b, neg, w, m)`` the gradient
kernel, the sums, the item side's sort and both ordered scatters,
enqueued on the current stream with no sync and no allocation (the
scratch is made once a solver). There is no fallback: a CUDA table the
kernel does not take raises. The kernel sums the dot products and the
batch's loss in its own fixed order, so it equals the eager chain to f32
rounding, not bit for bit; its negatives are the eager sampler's bit for
bit, and two runs of an epoch give the same bits.

The ``bpr.step`` span marks each batch's step call; the counter
``bpr.step`` counts the calls that went through the kernel (both kept
only while a profiler records, ``train/profiler.py``).
``BPRStep.launches`` counts the kernel's step calls, ``.sample_launches``
its sampler calls, ``.scatter_launches`` the ordered scatters the step
calls enqueued, as the C entry reports them.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.ops.scatter import Plan, index_add_ordered_
from matfac_tpu_torch.train.profiler import count, span

_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _BprArgs(ctypes.Structure):
    """``BprArgs`` of ``csrc/bpr_step.cu``, field for field (8 bytes
    each): the positives, CSR rows, rank-gap tables, scratch and user
    plans, set once a solver; the words, tables and sums, once an
    epoch."""
    _fields_ = [(n, _P) for n in (
        "pos_u", "pos_i", "pos_valid", "pos_start", "pos_deg", "csr_cols",
        "csr_vals", "cum_lo", "cnt", "sel_items")] + [(n, _L) for n in (
            "nnz", "n_sel", "batch", "n_batches", "n_tries")] + [
        (n, _D) for n in ("two_u_reg", "two_i_reg", "eps")] + [
        (n, _P) for n in ("gu", "gi", "neg", "w", "i_keys", "u_keys", "iota",
                          "i_rows", "i_order", "u_rows", "u_order",
                          "loss_part", "inv_part", "sort_tmp")] + [
        ("sort_bytes", _L), ("bits", _P), ("n_steps", _L), ("u_fac", _P),
        ("i_fac", _P)] + [(n, _L) for n in (
            "k", "n_users", "n_items", "u_row", "i_row", "dtype")] + [
        ("neg_lr", _D), ("loss", _P), ("inv", _P), ("device", _L),
        ("stream", _P), ("plan_order", _P), ("plan_rows", _P)]


_SIGNATURES = {
    "bpr_sample": (_I, [_P, _L, _L]),                    # args, t, b
    # args, b; u, p, n, w, m; m_row; the scatters it launched (out)
    "bpr_step": (_I, [_P, _L] + [_P] * 5 + [_L, _P]),
    "bpr_sort_bytes": (_I, [_L, _L, _P]),                # n, device, out
    "bpr_step_error_string": (ctypes.c_char_p, [_I]),
}
# triples a block of the gradient kernel (kTriples of csrc/bpr_step.cu):
# it writes one partial sum a block
_TRIPLES = 16


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc on first use)."""
    return _build.load("bpr_step", _SIGNATURES)


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


def bpr_sample_plain(start, deg, jj_bits, j_bits, csr_cols, csr_vals,
                     cum_lo, cnt, sel_items):
    """The rank-gap sampler (``solvers/bpr.py``'s docstring) as eager ops:
    ``start``, ``deg`` [B] the positives' user rows in the CSR, ``jj_bits``,
    ``j_bits`` [n_tries, B] words. Returns (neg [B] int64, ok [B] bool)."""
    B = start.shape[0]
    pos = (start[None, :] + jj_bits % deg[None, :]).clamp(
        0, max(csr_cols.shape[0] - 1, 0))
    vr = torch.zeros(B, dtype=torch.int64, device=start.device)
    is_rank = torch.zeros(B, dtype=torch.bool, device=start.device)
    ok = torch.zeros(B, dtype=torch.bool, device=start.device)
    for t in range(jj_bits.shape[0]):
        p = pos[t]
        explicit = csr_vals[p] == 0.0
        c = cnt[p]
        gap_ok = c > 0
        m = j_bits[t] % torch.clamp(c, min=1)
        cand_vr = torch.where(explicit, csr_cols[p], cum_lo[p] + m)
        cand_ok = explicit | gap_ok
        take = cand_ok & ~ok
        vr = torch.where(take, cand_vr, vr)
        is_rank = torch.where(take, ~explicit & gap_ok, is_rank)
        ok = ok | cand_ok
    n_sel = sel_items.shape[0]
    neg = torch.where(is_rank, sel_items[vr.clamp(0, n_sel - 1)], vr)
    return neg, ok


def bpr_step_plain(U, I, u, p, neg, w, lr: float, u_reg: float,
                   i_reg: float, eps: float, m=None,
                   u_plan: Optional[Plan] = None):
    """One batch's pairwise step as eager ops, in place on the tables:
    ``u``, ``p``, ``neg`` [B] the triples' ids, ``w`` [B] their weights,
    ``m`` [B, k] the rank mask or None, ``u_plan`` the user side's staged
    plan or None. Returns the batch's (loss, inversions), 0-dim."""
    pu, qp, qn = U[u], I[p], I[neg]
    gu, gp, gn, r_uij, loss = bpr_pair_terms(pu, qp, qn, w, u_reg, i_reg, m)
    inv = ((-r_uij > eps) & (w > 0)).sum()
    index_add_ordered_(U, 0, u, (-lr * gu).to(U.dtype), u_plan)
    index_add_ordered_(I, 0, torch.cat([p, neg]),
                       (-lr * torch.cat([gp, gn])).to(I.dtype))
    return loss, inv


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_batch(neg, w, m, u, p, B: int, k: int, device: int) -> None:
    """What the step kernel reads of a batch: n (and u, p where given)
    int64 [B], w f32 [B], each contiguous, m f32 [B, k] of unit column
    stride or None, on the tables' device."""
    for t, dt in ((neg, torch.int64), (w, torch.float32), (u, torch.int64),
                  (p, torch.int64)):
        if t is not None and (t.dtype != dt or t.shape != (B,)
                              or not t.is_contiguous()
                              or t.get_device() != device):
            raise ValueError(f"a batch's ids int64 [B] and weights f32 [B], "
                             f"contiguous, on the tables' device; not "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if m is not None and (m.dtype != torch.float32 or m.shape != (B, k)
                          or m.stride(1) != 1 or m.get_device() != device):
        raise ValueError(f"a rank mask f32 [B, k] of unit column stride on "
                         f"the tables' device, not {m.dtype} "
                         f"{tuple(m.shape)} on {m.device}")


class BPRStep:
    """The batch over one solver's staged positives: ``pos_u``, ``pos_i``
    (int64), ``pos_valid`` (f32), ``pos_start``, ``pos_deg`` (int64), one
    element a positive, batch b at [b B, (b + 1) B); the train rows
    ``csr_cols`` (int64), ``csr_vals`` (f32); the rank-gap tables
    ``cum_lo``, ``cnt`` [nnz] and ``sel_items`` (int64), or None where the
    solver samples otherwise; ``u_plans`` each batch's user plan
    (``stage_plans``), or None. On a CUDA device the kernel's static
    arguments and its scratch (~(3 B k) table entries) are staged once."""

    launches = 0            # step calls of the kernel route, all instances
    sample_launches = 0     # sampler calls of the kernel route
    scatter_launches = 0    # the ordered scatters the step calls enqueued

    def __init__(self, pos_u, pos_i, pos_valid, pos_start, pos_deg,
                 csr_cols, csr_vals, cum_lo, cnt, sel_items,
                 u_plans: Optional[List[Plan]], batch_size: int,
                 n_tries: int, u_reg: float, i_reg: float, eps: float,
                 n_users: int, n_items: int):
        self.pos_u, self.pos_i, self.pos_valid = pos_u, pos_i, pos_valid
        self.pos_start, self.pos_deg = pos_start, pos_deg
        self.csr_cols, self.csr_vals = csr_cols, csr_vals
        self.cum_lo, self.cnt, self.sel_items = cum_lo, cnt, sel_items
        self.u_plans = u_plans
        self.batch_size, self.n_tries = batch_size, n_tries
        self.n_batches = pos_u.shape[0] // batch_size
        self.u_reg, self.i_reg, self.eps = (float(u_reg), float(i_reg),
                                            float(eps))
        self.n_users, self.n_items = n_users, n_items
        self._args = self._scratch = None
        if pos_u.is_cuda:
            self._stage()

    def _stage(self) -> None:
        """The kernel's static arguments and the scratch that does not
        depend on the tables, checked once."""
        dev = self.pos_u.device
        B, n = self.batch_size, self.pos_u.shape[0]
        tables = [(self.pos_u, torch.int64), (self.pos_i, torch.int64),
                  (self.pos_valid, torch.float32),
                  (self.pos_start, torch.int64), (self.pos_deg, torch.int64),
                  (self.csr_cols, torch.int64), (self.csr_vals, torch.float32)]
        tables += [(t, torch.int64) for t in (self.cum_lo, self.cnt,
                                              self.sel_items)
                   if t is not None]
        for t, dt in tables:
            if t.device != dev or t.dtype != dt or t.dim() != 1 \
                    or not t.is_contiguous():
                raise ValueError(f"the staged positives and tables: 1-D, "
                                 f"contiguous, on {dev}, as {dt}; not "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if any(t.shape[0] != n for t, _ in tables[1:5]) or n % B \
                or self.csr_vals.shape[0] != self.csr_cols.shape[0] \
                or (self.cum_lo is None) != (self.cnt is None):
            raise ValueError("positives of whole batches, a CSR of one "
                             "length, both gap tables or neither")
        if 2 * B >= 2 ** 31 or self.n_users >= 2 ** 31 \
                or self.n_items >= 2 ** 31:
            raise ValueError("the kernel's plans hold int32 positions and "
                             "ids")
        i32 = dict(dtype=torch.int32, device=dev)
        blocks = -(-B // _TRIPLES)
        self._ids = dict(
            neg=torch.zeros(B, dtype=torch.int64, device=dev),
            w=torch.zeros(B, dtype=torch.float32, device=dev),
            i_keys=torch.empty(2 * B, **i32), u_keys=torch.empty(B, **i32),
            iota=torch.arange(2 * B, **i32), i_rows=torch.empty(2 * B, **i32),
            i_order=torch.empty(2 * B, **i32), u_rows=torch.empty(B, **i32),
            u_order=torch.empty(B, **i32),
            loss_part=torch.empty(blocks, dtype=torch.float32, device=dev),
            inv_part=torch.empty(blocks, dtype=torch.int64, device=dev))
        a = self._args = _BprArgs()
        for name in ("pos_u", "pos_i", "pos_valid", "pos_start", "pos_deg",
                     "csr_cols", "csr_vals", "cum_lo", "cnt", "sel_items"):
            setattr(a, name, _ptr(getattr(self, name)))
        for name, t in self._ids.items():
            setattr(a, name, t.data_ptr())
        a.nnz = self.csr_cols.shape[0]
        a.n_sel = 0 if self.sel_items is None else self.sel_items.shape[0]
        a.batch, a.n_batches, a.n_tries = B, self.n_batches, self.n_tries
        a.two_u_reg, a.two_i_reg = 2.0 * self.u_reg, 2.0 * self.i_reg
        a.eps = self.eps
        a.device = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        if self.u_plans is not None:
            # each batch's plan pointers, host arrays the C entry indexes
            self._plan_ptrs = [(_P * self.n_batches)(*(t.data_ptr() for t in
                                                       ts))
                               for ts in ([q.order for q in self.u_plans],
                                          [q.rows for q in self.u_plans])]
            a.plan_order, a.plan_rows = (ctypes.addressof(x)
                                         for x in self._plan_ptrs)

    def epoch_plain(self, U, I, lr: float, bits, loss, inv):
        """The epoch's ``(sample, step)`` as the plain versions on batch
        b's slices, on any device; each step adds its batch's loss and
        inversions to ``loss`` and ``inv`` in place."""
        B = self.batch_size

        def sample(t: int, b: int):
            sl = slice(b * B, (b + 1) * B)
            neg, ok = bpr_sample_plain(
                self.pos_start[sl], self.pos_deg[sl], bits[t, 0], bits[t, 1],
                self.csr_cols, self.csr_vals, self.cum_lo, self.cnt,
                self.sel_items)
            return neg, self.pos_valid[sl] * ok.to(torch.float32)

        def step(b: int, neg, w, m, u=None, p=None):
            plan = None
            if u is None:
                sl = slice(b * B, (b + 1) * B)
                u, p = self.pos_u[sl], self.pos_i[sl]
                plan = self.u_plans[b] if self.u_plans else None
            with span("bpr.step"):
                bl, bi = bpr_step_plain(U, I, u, p, neg, w, lr, self.u_reg,
                                        self.i_reg, self.eps, m, plan)
            loss.add_(bl)
            inv.add_(bi)
        return sample, step

    def _scratch_for(self, U) -> tuple:
        """The gradient rows ([B, k] and [2B, k] in the tables' type) and
        the sorts' scratch, made once a solver: its tables keep their type
        and width."""
        B, k, dev = self.batch_size, U.shape[1], U.device
        sc = self._scratch
        if sc is None or sc[0].dtype != U.dtype or sc[0].shape[1] != k:
            lib, need = library(), ctypes.c_longlong()
            err = lib.bpr_sort_bytes(2 * B, self._args.device,
                                     ctypes.addressof(need))
            if err != 0:
                raise RuntimeError(f"bpr sort query failed: "
                                   f"{lib.bpr_step_error_string(err).decode()}"
                                   f" (cudaError {err})")
            sc = self._scratch = (
                torch.empty((B, k), dtype=U.dtype, device=dev),
                torch.empty((2 * B, k), dtype=U.dtype, device=dev),
                torch.empty(max(need.value, 1), dtype=torch.uint8,
                            device=dev))
        return sc

    def epoch(self, U, I, lr: float, bits, loss, inv):
        """The epoch's ``(sample, step)``, updating the tables in place and
        adding each batch's loss and inversions to ``loss`` (f32) and
        ``inv`` (int64), 0-dim: ``sample(t, b)`` returns batch b's (neg,
        w) from the words ``bits[t]`` ([n_steps, 2, n_tries, B] int64, or
        None where the solver samples otherwise); ``step(b, neg, w, m, u=
        None, p=None)`` steps the triples, u and p None for batch b's
        staged positives. CPU tables take ``epoch_plain``; CUDA tables are
        checked here, once, and each call is one call of the kernel. A
        batch's inputs are checked at the first step that gives each
        pattern of them (a mask or none, ids or none)."""
        if U.is_cpu:
            return self.epoch_plain(U, I, lr, bits, loss, inv)
        if self._args is None:
            raise ValueError("a solver staged on the CPU given CUDA tables")
        dev = self.pos_u.device
        k = U.shape[1]
        code = _DTYPES.get(U.dtype)
        if any(t.device != dev for t in (U, I)) or U.dim() != 2 \
                or I.dim() != 2 or I.shape[1] != k or code is None \
                or I.dtype != U.dtype or U.stride(1) != 1 \
                or I.stride(1) != 1 or U.shape[0] < self.n_users \
                or I.shape[0] < self.n_items:
            raise ValueError(
                f"tables the kernel does not take: U {U.dtype} "
                f"{tuple(U.shape)}, I {I.dtype} {tuple(I.shape)} on "
                f"{U.device}; it takes f32 or bf16 tables of one type with "
                f"rows of unit column stride, on {dev}, covering "
                f"{self.n_users} x {self.n_items} ids")
        if loss.shape != () or loss.dtype != torch.float32 \
                or inv.shape != () or inv.dtype != torch.int64 \
                or loss.device != dev or inv.device != dev:
            raise ValueError("the epoch's sums: 0-dim f32 and int64 on the "
                             "tables' device")
        B = self.batch_size
        if bits is not None and (
                bits.dtype != torch.int64 or bits.dim() != 4
                or tuple(bits.shape[1:]) != (2, self.n_tries, B)
                or not bits.is_contiguous() or bits.device != dev):
            raise ValueError(f"the epoch's words int64 [n_steps, 2, "
                             f"{self.n_tries}, {B}], contiguous, on {dev}; "
                             f"not {bits.dtype} {tuple(bits.shape)} on "
                             f"{bits.device}")
        gu, gi, tmp = self._scratch_for(U)
        # the epoch's own copy: its calls keep its tables
        a = _BprArgs.from_buffer_copy(self._args)
        a.gu, a.gi = gu.data_ptr(), gi.data_ptr()
        a.sort_tmp, a.sort_bytes = tmp.data_ptr(), tmp.numel()
        a.bits = _ptr(bits)
        a.n_steps = 0 if bits is None else bits.shape[0]
        a.u_fac, a.i_fac = U.data_ptr(), I.data_ptr()
        a.k, a.n_users, a.n_items = k, U.shape[0], I.shape[0]
        a.u_row, a.i_row, a.dtype = U.stride(0), I.stride(0), code
        a.neg_lr = -float(lr)
        a.loss, a.inv = loss.data_ptr(), inv.data_ptr()
        a.stream = torch._C._cuda_getCurrentRawStream(a.device)
        lib = library()
        addr, di = ctypes.addressof(a), a.device
        scatters = ctypes.c_int()
        out = ctypes.addressof(scatters)
        neg_t, w_t = self._ids["neg"], self._ids["w"]
        seen = set()

        def fail(what: str, err: int):
            raise RuntimeError(f"bpr {what} launch failed: "
                               f"{lib.bpr_step_error_string(err).decode()} "
                               f"(cudaError {err})")

        def sample(t: int, b: int):
            err = lib.bpr_sample(addr, t, b)
            if err != 0:
                fail("sample", err)
            BPRStep.sample_launches += 1
            return neg_t, w_t

        def step(b: int, neg, w, m, u=None, p=None):
            pattern = (m is None, u is None)
            if pattern not in seen:
                _check_batch(neg, w, m, u, p, B, k, di)
                seen.add(pattern)
            with span("bpr.step"):
                err = lib.bpr_step(addr, b, _ptr(u), _ptr(p), neg.data_ptr(),
                                   w.data_ptr(), _ptr(m),
                                   0 if m is None else m.stride(0), out)
            if err != 0:
                fail("step", err)
            count("bpr.step")
            BPRStep.launches += 1
            BPRStep.scatter_launches += scatters.value
        step.args = a, scatters, bits     # alive while the epoch's calls run
        return sample, step
