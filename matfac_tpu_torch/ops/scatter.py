"""Scatter-add in a fixed order: the engines' ``.at[].add`` on the card.

JAX sums a batch's colliding rows with XLA's scatter-add, which gives the
same bits on every run (matfac_tpu/solvers/sgd.py calls its engine "the
deterministic analog of hogwild"). ``Tensor.index_add_`` on a CUDA tensor
adds with atomics in no fixed order, so two runs of an epoch differ in the
last bits and the difference grows over the epochs.

``index_add_ordered_`` adds each row's duplicates onto the row one after
another, in their order in ``index``, each add rounded to the table's
type, so the sum is the same on every run. On a CUDA tensor that is one
launch of the hand-written kernel ``csrc/ordered_scatter.cu``, which walks
a *plan* (``Plan``): the index's stable sort, i.e. its rows in ascending
order and each one's position in the source. A caller whose indices never
change stages the plans once on the card (``stage_plans``: the sgd
engine's batches, BPR's user side) and passes each call its plan; any other call makes one
with a stable sort on the card (``plan_ordered``). For a 2-D table the
bits equal those of PyTorch's ``index_put_(accumulate=True)`` (the same
stable order and rounding); a 1-D table sums in the same order, where
that route may reduce a run by a warp tree. The call's host
cost is a ctypes launch, and with a staged plan it neither sorts nor
syncs. Its time grows with the count of a batch's hottest row (the adds
of one row wait on each other).

On the CPU it is ``index_add_`` itself, whatever the plan, so the CPU
parity tests against JAX keep their bits; for a bf16 table that rounds
less often than the card's route, which rounds at every duplicate.
``ordered_scatter_plain`` is the kernel's semantics in plain PyTorch, for
the tests and ``chip_smoke.py``. There is no atomic route.

The ``scatter.ordered`` span marks each call; the counter
``scatter.staged`` counts the calls that were given a plan (both kept only
while a profiler records, ``train/profiler.py``).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import torch

from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.train.profiler import count, span

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # table, src, order, rows; n, n_rows; k; t_row, t_col, s_row, s_col;
    # dtype, index bytes, device; stream
    "ordered_scatter": (_I, [_P] * 4 + [_L, _L, _I] + [_L] * 4
                        + [_I] * 3 + [_P]),
    "ordered_scatter_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           torch.float64: 3}
_INDEX_BYTES = {torch.int32: 4, torch.int64: 8}


class Plan(NamedTuple):
    """The order of one scatter's adds: ``rows`` [n], the index sorted
    ascending (stable), and ``order`` [n], the position in the index (and
    the source) of each; both int32 or both int64, on the table's device."""
    order: torch.Tensor
    rows: torch.Tensor


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc on first use)."""
    return _build.load("ordered_scatter", _SIGNATURES)


def plan_ordered(index: torch.Tensor) -> Plan:
    """The plan of one index [n]: one stable sort on the index's device."""
    rows, order = torch.sort(index.long(), stable=True)
    return Plan(order, rows)


def stage_plans(index: torch.Tensor, n_rows: int) -> List[Plan]:
    """The plans of a static index [n_batches, B], one a batch (each row
    sorted stably, int32), made once: the ids are checked in [0, n_rows)
    here (a host sync), so a call with one of these plans checks nothing
    more. The index must not change while the plans are in use."""
    if index.dim() != 2:
        raise ValueError("stage_plans takes an index of [n_batches, B]")
    if n_rows >= 2 ** 31 or index.shape[1] >= 2 ** 31:
        raise ValueError("a staged plan holds int32 rows and positions")
    if index.numel() and (int(index.min()) < 0
                          or int(index.max()) >= n_rows):
        raise ValueError(f"index out of range [0, {n_rows})")
    rows, order = torch.sort(index, dim=1, stable=True)
    rows, order = rows.to(torch.int32), order.to(torch.int32)
    return [Plan(o, r) for o, r in zip(order, rows)]


def _layout(t: torch.Tensor, dim: int) -> tuple:
    """(rows, columns, row stride, column stride) of a 1-D or 2-D tensor
    scattered along ``dim``."""
    if t.dim() == 1:
        return t.shape[0], 1, t.stride(0), 1
    other = 1 - dim
    return t.shape[dim], t.shape[other], t.stride(dim), t.stride(other)


def ordered_scatter(table: torch.Tensor, dim: int, source: torch.Tensor,
                    plan: Plan) -> torch.Tensor:
    """The kernel route: ``table`` (1-D or 2-D, CUDA; f32, bf16, f16 or
    f64) gets ``source``'s slices along ``dim`` added in ``plan``'s order,
    in place, on the current stream; returns ``table``. Raises on what the
    kernel does not take; an id out of range traps on the card."""
    nd = table.dim()
    if dim < 0:
        dim += nd
    if nd not in (1, 2) or not 0 <= dim < nd:
        raise ValueError(f"a 1-D or 2-D table along one of its dims, not "
                         f"{nd}-D along {dim}")
    code = _DTYPES.get(table.dtype)
    if code is None or source.dtype != table.dtype:
        raise TypeError(f"table and source of one type of {list(_DTYPES)}, "
                        f"not {table.dtype} and {source.dtype}")
    order, rows = plan
    ibytes = _INDEX_BYTES.get(rows.dtype)
    if ibytes is None or order.dtype != rows.dtype:
        raise TypeError(f"plan of int32 or int64, not {order.dtype} and "
                        f"{rows.dtype}")
    di = table.get_device()     # -1 on the CPU
    if di < 0 or source.get_device() != di or rows.get_device() != di \
            or order.get_device() != di:
        raise ValueError("table, source and plan must share a CUDA device")
    n_rows, k, t_row, t_col = _layout(table, dim)
    n, ks, s_row, s_col = _layout(source, dim)
    if source.dim() != nd or ks != k or rows.shape != (n,) \
            or order.shape != (n,):
        raise ValueError(f"source {tuple(source.shape)} and plan "
                         f"{tuple(rows.shape)} do not fit table "
                         f"{tuple(table.shape)} along dim {dim}")
    if not (rows.is_contiguous() and order.is_contiguous()):
        raise ValueError("a plan's tensors must be contiguous")
    if n == 0 or k == 0:
        return table
    lib = library()
    # the current stream's handle, without building a Stream object: this
    # call runs once a batch side, so its host time is the engine's pace
    stream = torch._C._cuda_getCurrentRawStream(di)
    err = lib.ordered_scatter(
        table.data_ptr(), source.data_ptr(), order.data_ptr(),
        rows.data_ptr(), n, n_rows, k, t_row, t_col, s_row, s_col, code,
        ibytes, di, stream)
    if err != 0:
        raise RuntimeError(f"ordered scatter launch failed: "
                           f"{lib.ordered_scatter_error_string(err).decode()}"
                           f" (cudaError {err})")
    ordered_scatter.launches += 1
    return table


ordered_scatter.launches = 0


def ordered_scatter_plain(table: torch.Tensor, dim: int,
                          source: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The kernel's sums in plain PyTorch, on any device: the runs' i-th
    adds together, i = 0, 1, ..., each rounded to the table's type after
    an add in f32 (f64 for an f64 table). In place; returns ``table``."""
    view, src = table.movedim(dim, 0), source.movedim(dim, 0)
    rows, order = plan.rows.long(), plan.order.long()
    n = rows.numel()
    if n == 0:
        return table
    pos = torch.arange(n, device=rows.device)
    head = torch.ones(n, dtype=torch.bool, device=rows.device)
    head[1:] = rows[1:] != rows[:-1]
    rank = pos - torch.where(head, pos, 0).cummax(0).values
    by_rank = torch.sort(rank, stable=True).indices
    acc = torch.float64 if table.dtype == torch.float64 else torch.float32
    start = 0
    for c in torch.bincount(rank).tolist():
        sel = by_rank[start:start + c]
        start += c
        r = rows[sel]
        view[r] = (view[r].to(acc) + src[order[sel]].to(acc)).to(table.dtype)
    return table


def index_add_ordered_(table: torch.Tensor, dim: int, index: torch.Tensor,
                       source: torch.Tensor, plan: Optional[Plan] = None
                       ) -> torch.Tensor:
    """``table.index_add_(dim, index, source)`` with colliding entries
    summed in a fixed order on every device; returns ``table``. ``plan``:
    ``index``'s plan, staged by the caller (``stage_plans``); None makes
    one on a CUDA table (``plan_ordered``). The CPU takes ``index_add_``
    and no plan."""
    with span("scatter.ordered"):
        if plan is not None:
            count("scatter.staged")
        if table.is_cpu:
            return table.index_add_(dim, index, source)
        if plan is None:
            plan = plan_ordered(index)
        elif plan.rows.shape != index.shape:
            raise ValueError(f"a plan of {tuple(plan.rows.shape)} for an "
                             f"index of {tuple(index.shape)}")
        return ordered_scatter(table, dim, source, plan)
