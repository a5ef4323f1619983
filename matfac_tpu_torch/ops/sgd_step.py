"""The sgd engine's batch step (``solvers/sgd.py``): one host call a batch
on the card, the eager chain on the CPU.

A batch of the staged rating stream applies

    e   = r - <p_u o m, q_i>   (+ b_u + b_i for a bias model)
    g_u = (-2 w e q_i + 2 reg_u ru p_u) o m o s_u / n_u
    g_i = (-2 w e p_u + 2 reg_i ri q_i) o m o s_i / n_i

at the batch's starting values, then adds -lr g to the rows of every
example in a fixed order (``ops/scatter.py``). w is the model's example
weight times the valid flag, m its rank mask, s_u, s_i its side gates,
n_u, n_i the collision counts of ``collision_norm``, ru, ri the valid flag
times the per-entity regularization scales; a bias model's biases train
by the same rule.

``sgd_step_plain`` is that step as eager PyTorch ops, the engine's route
on the CPU and the yardstick on the card. ``SGDStep`` holds one solver's
staged stream and, on the card, each batch's plans: ``epoch(U, I, bu, bi,
lr)`` checks the tables once and returns the epoch's ``step(b, w, m,
side)``, which on CPU tables runs ``sgd_step_plain`` on batch b's slices,
and on CUDA tables makes one call of ``csrc/sgd_step.cu``'s ``sgd_step``:
the gradient kernel and the ordered scatters, enqueued on the current
stream, with no sync and no allocation (the scratch rows are allocated
once a solver). There is no fallback: a CUDA table the kernel does not
take raises. The kernel sums the dot product in its own fixed order, so
it equals the eager chain to f32 rounding, not bit for bit; two runs of
an epoch give the same bits.

The ``sgd.step`` span marks each batch's call; the counter ``sgd.step``
counts the calls that went through the kernel (both kept only while a
profiler records, ``train/profiler.py``). ``SGDStep.launches`` counts the
kernel calls, ``SGDStep.scatter_launches`` the ordered scatters they
enqueued, as the C entry reports them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.ops.scatter import (Plan, index_add_ordered_,
                                          stage_plans)
from matfac_tpu_torch.train.profiler import count, span

_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _StepArgs(ctypes.Structure):
    """``StepArgs`` of ``csrc/sgd_step.cu``, field for field (8 bytes
    each): the stream, its scales and the batches' plans, set once a
    solver; the tables and the scratch rows, once an epoch."""
    _fields_ = [(n, _P) for n in (
        "rows", "cols", "vals", "valid", "inv_nu", "inv_ni", "reg_scale_u",
        "reg_scale_i", "reg_vec")] + [
        ("two_u_reg", _D), ("two_i_reg", _D)] + [(n, _L) for n in (
            "batch", "k", "use_factors", "use_bias")] + [(n, _P) for n in (
                "gu", "gi", "gbu", "gbi", "u_fac", "i_fac", "u_bias",
                "i_bias")] + [(n, _L) for n in (
                    "n_users", "n_items", "u_row", "i_row", "bu_stride",
                    "bi_stride", "dtype", "bias_dtype")] + [
        ("neg_lr", _D), ("device", _L), ("stream", _P), ("n_batches", _L)] + [
        (n, _P) for n in ("u_order", "u_rows", "i_order", "i_rows")]


_SIGNATURES = {
    # args, batch; w; m, m_row; su, su_row, su_col; si, si_row, si_col;
    # the scatters it launched (out)
    "sgd_step": (_I, [_P, _L, _P, _P, _L] + [_P, _L, _L] * 2 + [_P]),
    "sgd_step_error_string": (ctypes.c_char_p, [_I]),
}


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc on first use)."""
    return _build.load("sgd_step", _SIGNATURES)


def sgd_step_plain(U, I, bu, bi, u, i, r, v, w, m, side, inv_nu, inv_ni,
                   reg_scale_u, reg_scale_i, u_reg, i_reg, lr: float,
                   use_factors: bool, use_bias: bool,
                   up: Optional[Plan] = None, ip: Optional[Plan] = None
                   ) -> None:
    """One batch as eager PyTorch ops, in place on the tables. ``u``,
    ``i``, ``r``, ``v``, ``inv_nu``, ``inv_ni``: the batch's ids, ratings,
    valid flags and collision scales (None: no ``collision_norm``);
    ``u_reg``, ``i_reg``: floats, or the per-dim rates [1, k]; ``up``,
    ``ip``: the batch's plans, or None."""
    pu, qi = U[u].float(), I[i].float()
    bu_old, bi_old = bu[u].float(), bi[i].float()
    pred = torch.zeros_like(r)
    if use_factors:
        pred = ((pu if m is None else pu * m) * qi).sum(dim=1)
    if use_bias:
        pred = pred + bu_old + bi_old
    diff = r - pred
    ru = v if reg_scale_u is None else reg_scale_u[u] * v
    ri = v if reg_scale_i is None else reg_scale_i[i] * v
    wd = w * diff
    if use_factors:
        gu = -2.0 * wd[:, None] * qi + 2.0 * u_reg * (ru[:, None] * pu)
        gi = -2.0 * wd[:, None] * pu + 2.0 * i_reg * (ri[:, None] * qi)
        if m is not None:
            gu, gi = gu * m, gi * m
        if side is not None:
            # per-side gates on the whole gradient, prediction
            # untouched (othersrc modelMFLoc.cpp:124-159)
            gu, gi = gu * side[0], gi * side[1]
        if inv_nu is not None:
            gu = gu * inv_nu[:, None]
            gi = gi * inv_ni[:, None]
        index_add_ordered_(U, 0, u, (-lr * gu).to(U.dtype), up)
        index_add_ordered_(I, 0, i, (-lr * gi).to(I.dtype), ip)
    if use_bias:
        gbu = -2.0 * wd + 2.0 * u_reg * ru * bu_old
        gbi = -2.0 * wd + 2.0 * i_reg * ri * bi_old
        if side is not None:
            gbu, gbi = gbu * side[0][:, 0], gbi * side[1][:, 0]
        if inv_nu is not None:
            gbu = gbu * inv_nu
            gbi = gbi * inv_ni
        index_add_ordered_(bu, 0, u, (-lr * gbu).to(bu.dtype), up)
        index_add_ordered_(bi, 0, i, (-lr * gbi).to(bi.dtype), ip)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_hooks(w, m, side, B: int, k: int, device: int) -> None:
    """What the kernel reads of the hooks' outputs: w [B] f32, m [B, k]
    f32 of unit column stride, each side gate [B, k] or [B, 1] f32, on the
    tables' device."""
    if w.dtype != torch.float32 or w.shape != (B,) \
            or not w.is_contiguous() or w.get_device() != device:
        raise ValueError(f"weights [B] f32 on the tables' device, not "
                         f"{w.dtype} {tuple(w.shape)}")
    gates = [(m, (k,))] if m is not None else []
    if side is not None:
        gates += [(side[0], (1, k)), (side[1], (1, k))]
    for t, widths in gates:
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != B \
                or t.shape[1] not in widths or t.get_device() != device:
            raise ValueError(f"a [B, k] f32 mask or a [B, 1] f32 gate on "
                             f"the tables' device, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if m is not None and m.stride(1) != 1:
        raise ValueError("a rank mask of unit column stride")


def _gate(t: Optional[torch.Tensor]) -> tuple:
    """A gate's pointer, row stride and column stride (0 for [B, 1])."""
    if t is None:
        return None, 0, 0
    return t.data_ptr(), t.stride(0), 0 if t.shape[1] == 1 else t.stride(1)


class SGDStep:
    """The batch step over one solver's staged stream: ``rows``, ``cols``
    (int64), ``vals``, ``valid`` (f32), one element an example, batch b at
    [b B, (b + 1) B); ``inv_nu`` / ``inv_ni`` the same length, or None;
    ``reg_scale_u`` [n_users], ``reg_scale_i`` [n_items], ``reg_vec`` [k]
    (f32, in place of ``u_reg`` / ``i_reg`` on both sides), or None. On a
    CUDA device each batch's order of adds is staged once for both sides
    (``u_plans``, ``i_plans``: ``stage_plans``, which checks the ids lie
    in [0, n_users) and [0, n_items)); the CPU's ``index_add_`` takes
    none."""

    launches = 0            # calls of the kernel route, all instances
    scatter_launches = 0    # the ordered scatters those calls enqueued

    def __init__(self, rows, cols, vals, valid, batch_size: int,
                 inv_nu, inv_ni, reg_scale_u, reg_scale_i, reg_vec,
                 u_reg: float, i_reg: float, use_factors: bool,
                 use_bias: bool, n_users: int, n_items: int):
        self.rows, self.cols, self.vals, self.valid = rows, cols, vals, valid
        self.batch_size = batch_size
        self.n_batches = rows.shape[0] // batch_size
        self.inv_nu, self.inv_ni = inv_nu, inv_ni
        self.reg_scale_u, self.reg_scale_i = reg_scale_u, reg_scale_i
        self.reg_vec = reg_vec
        self.u_reg, self.i_reg = float(u_reg), float(i_reg)
        self.use_factors, self.use_bias = bool(use_factors), bool(use_bias)
        self.n_users, self.n_items = n_users, n_items
        self.u_plans = self.i_plans = None
        self._args = self._scratch = None
        if rows.is_cuda:
            self._stage()

    def _stage(self) -> None:
        """The plans and the kernel's static arguments, checked once."""
        dev = self.rows.device
        stream = (self.rows, self.cols, self.vals, self.valid)
        dtypes = (torch.int64, torch.int64, torch.float32, torch.float32)
        scales = [t for t in (self.inv_nu, self.inv_ni, self.reg_scale_u,
                              self.reg_scale_i, self.reg_vec)
                  if t is not None]
        n = self.rows.shape[0]
        for t, dt in zip(stream + tuple(scales),
                         dtypes + (torch.float32,) * len(scales)):
            if t.device != dev or t.dtype != dt or t.dim() != 1 \
                    or not t.is_contiguous():
                raise ValueError(f"the staged stream and its scales: 1-D, "
                                 f"contiguous, on {dev}, as {dt}; not "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if any(t.shape[0] != n for t in stream[1:]) or n % self.batch_size \
                or (self.inv_nu is None) != (self.inv_ni is None):
            raise ValueError("a stream of whole batches, both collision "
                             "scales or neither")
        if self.reg_vec is not None and self.use_bias:
            raise ValueError("per-dim reg_vec is factor-only")
        shape = (self.n_batches, self.batch_size)
        self.u_plans = stage_plans(self.rows.view(shape), self.n_users)
        self.i_plans = stage_plans(self.cols.view(shape), self.n_items)
        # each batch's plan pointers, host arrays the C entry indexes by b
        self._plan_ptrs = [(_P * self.n_batches)(*(t.data_ptr() for t in ts))
                           for ts in ([p.order for p in self.u_plans],
                                      [p.rows for p in self.u_plans],
                                      [p.order for p in self.i_plans],
                                      [p.rows for p in self.i_plans])]
        a = self._args = _StepArgs()
        for name in ("rows", "cols", "vals", "valid", "inv_nu", "inv_ni",
                     "reg_scale_u", "reg_scale_i", "reg_vec"):
            setattr(a, name, _ptr(getattr(self, name)))
        a.two_u_reg, a.two_i_reg = 2.0 * self.u_reg, 2.0 * self.i_reg
        a.batch, a.n_batches = self.batch_size, self.n_batches
        a.use_factors, a.use_bias = int(self.use_factors), int(self.use_bias)
        a.device = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        a.u_order, a.u_rows, a.i_order, a.i_rows = (
            ctypes.addressof(x) for x in self._plan_ptrs)

    def epoch_plain(self, U, I, bu, bi, lr: float) -> Callable:
        """The epoch's ``step`` as ``sgd_step_plain`` on batch b's slices,
        on any device."""
        B = self.batch_size
        if self.reg_vec is not None:
            u_reg = i_reg = self.reg_vec[None, :]
        else:
            u_reg, i_reg = self.u_reg, self.i_reg
        lr = float(lr)

        def step(b: int, w, m, side):
            sl = slice(b * B, (b + 1) * B)
            up, ip = ((self.u_plans[b], self.i_plans[b]) if self.u_plans
                      else (None, None))
            cn = self.inv_nu is not None
            with span("sgd.step"):
                sgd_step_plain(
                    U, I, bu, bi, self.rows[sl], self.cols[sl],
                    self.vals[sl], self.valid[sl], w, m, side,
                    self.inv_nu[sl] if cn else None,
                    self.inv_ni[sl] if cn else None, self.reg_scale_u,
                    self.reg_scale_i, u_reg, i_reg, lr, self.use_factors,
                    self.use_bias, up, ip)
        return step

    def epoch(self, U, I, bu, bi, lr: float) -> Callable:
        """The epoch's ``step(b, w, m, side)``, updating the tables in
        place: w [B] f32, m [B, k] f32 or None, side a pair of [B, k] or
        [B, 1] f32 gates or None (the model's hooks of batch b). CPU
        tables take ``epoch_plain``; CUDA tables are checked here, once,
        and each step is one call of the kernel. The hooks' outputs are
        checked at the first step that gives each pattern of them (a mask
        or none, gates or none): a model's hooks give one layout a
        pattern."""
        if U.is_cpu:
            return self.epoch_plain(U, I, bu, bi, lr)
        if self._args is None:
            raise ValueError("a solver staged on the CPU given CUDA tables")
        dev = self.rows.device
        k = U.shape[1]
        code, bcode = _DTYPES.get(U.dtype), _DTYPES.get(bu.dtype)
        if any(t.device != dev for t in (U, I, bu, bi)) \
                or U.dim() != 2 or I.dim() != 2 or I.shape[1] != k \
                or bu.dim() != 1 or bi.dim() != 1 or U.stride(1) != 1 \
                or I.stride(1) != 1 or code is None or bcode is None \
                or I.dtype != U.dtype or bi.dtype != bu.dtype \
                or U.shape[0] < self.n_users or I.shape[0] < self.n_items \
                or bu.shape[0] < self.n_users or bi.shape[0] < self.n_items \
                or (self.reg_vec is not None
                    and self.reg_vec.shape[0] != k):
            raise ValueError(
                f"tables the kernel does not take: U {U.dtype} "
                f"{tuple(U.shape)}, I {I.dtype} {tuple(I.shape)}, biases "
                f"{bu.dtype} / {bi.dtype} on {U.device}; it takes f32 or "
                f"bf16 factors with rows of unit column stride, 1-D biases, "
                f"on {dev}, covering {self.n_users} x {self.n_items} ids")
        B = self.batch_size
        sc = self._scratch
        if sc is None or sc[0].dtype != U.dtype or sc[0].shape[1] != k \
                or sc[2].dtype != bu.dtype:
            # made once a solver: its tables keep their types and width
            sc = self._scratch = tuple(
                torch.empty(shape, dtype=dt, device=dev) for shape, dt in (
                    ((B, k), U.dtype), ((B, k), U.dtype), ((B,), bu.dtype),
                    ((B,), bu.dtype)))
        # the epoch's own copy: its steps keep its tables
        a = _StepArgs.from_buffer_copy(self._args)
        a.gu, a.gi, a.gbu, a.gbi = (t.data_ptr() for t in sc)
        a.u_fac, a.i_fac = U.data_ptr(), I.data_ptr()
        a.u_bias, a.i_bias = bu.data_ptr(), bi.data_ptr()
        a.k, a.n_users, a.n_items = k, U.shape[0], I.shape[0]
        a.u_row, a.i_row = U.stride(0), I.stride(0)
        a.bu_stride, a.bi_stride = bu.stride(0), bi.stride(0)
        a.dtype, a.bias_dtype = code, bcode
        a.neg_lr = -float(lr)
        a.stream = torch._C._cuda_getCurrentRawStream(a.device)
        lib = library()
        call, addr, di = lib.sgd_step, ctypes.addressof(a), a.device
        scatters = ctypes.c_int()
        out = ctypes.addressof(scatters)
        seen = set()

        def step(b: int, w, m, side):
            pattern = (m is None, side is None)
            if pattern not in seen:
                _check_hooks(w, m, side, B, k, di)
                seen.add(pattern)
            su, si = (None, None) if side is None else side
            with span("sgd.step"):
                err = call(addr, b, w.data_ptr(),
                           None if m is None else m.data_ptr(),
                           0 if m is None else m.stride(0),
                           *_gate(su), *_gate(si), out)
            if err != 0:
                raise RuntimeError(
                    f"sgd step launch failed: "
                    f"{lib.sgd_step_error_string(err).decode()} "
                    f"(cudaError {err})")
            count("sgd.step")
            SGDStep.launches += 1
            SGDStep.scatter_launches += scatters.value
        step.args = a, scatters     # alive while the epoch's steps run
        return step
