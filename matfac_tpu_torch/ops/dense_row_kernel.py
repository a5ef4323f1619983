"""Row-stripe dense SGD epoch: the hand-written CUDA kernel's wrapper.

Port of matfac_tpu/ops/dense_row_kernel.py. Its two Pallas TPU kernels
(``dense_rows_epoch_pallas`` on float R+W tiles, ``dense_rows_codes_pallas``
on int8 rating codes) become ONE CUDA kernel templated on tile and weight
type, ``csrc/dense_rows.cu`` (design and cost notes there): with
``mm_bf16`` and k <= 128 its three products run on bf16 tensor cores,
otherwise on the CUDA cores. Not carried over: the bf16-resident item
table of the codes kernel (the port keeps f32 tables, as JAX's default XLA
path does), the panel-major relayout and the sequential grid — they were
TPU VMEM and DMA workarounds.

``dense_rows_epoch`` takes the tensors' device as the route: a CPU tensor
runs the plain ``dense_sweep_rows``; a CUDA tensor launches the kernel or
raises. One C call runs the epoch's stripes in order, each a round of one
cell (``stripe_cells`` puts the order on the device once an epoch);
``dense_rows_epoch.launches`` counts kernel launches: two per stripe (the
panel kernel and the step kernel, which steps the items and the stripe's
users), plus one an epoch for the bf16 copy of U when the products run on
the tensor cores (``epoch_launches``).
The validity counts the kernels read depend on the tiles alone: the
solver computes them once at staging (``stripe_counts``) and passes them;
a caller that passes none has them computed on each call.

Rank masks (TMF, TMF+Dropout) come as ``ranks=(Lu, Li, Q)``: int32
lambda (or rank) tables of the stripes' users [NU, bu] and of the items
[ni_pad], and a per-visit rank table Q [NU, k] whose row t ranks the
lambdas at the t-th stripe of ``row_order`` (``identity_quantiles`` for
static ranks, ``visit_quantiles`` for Poisson draws). The kernel reads the
masked regularization counts from suffix histograms of the tiles'
lambdas, ``rank_hists``, which the solver stages once beside the counts.
The masks are instantiated for int8 codes and int8 validity W only, the
tiles of the 0/1-weight models that carry them. The rank checks and, on
the card, the rank rows put in stripe order run in the span
``stripes.ranks``.

``dense_cells_epoch`` is the same kernel's cell-grid entry, the port of
the JAX dense engine's diag cell grid (``dense_sweep_diag``, which XLA
computes there): DSGD rounds of [bu, bi] cells, one panel launch over all
of a round's live cells and one step launch over their rows (the step
also refreshes the blocks' bf16 U rows), plus the bf16 copy of U once an
epoch on the tensor-core route. ``cells_plan`` is the host's plan of an
epoch: each round's live cells (dummy lanes dropped), which go to the
device once an epoch, and the launches, 2 a round with a live cell (+1).
No rank masks, as in JAX.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.ops.dense_block_kernel import (dense_sweep_diag,
                                                    dense_sweep_rows)
from matfac_tpu_torch.train.profiler import span

Ranks = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

KERNELS_PER_STRIPE = 2     # panel kernel + step kernel
_RTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_WTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

_P = ctypes.c_void_p
_EPOCH_TAIL = [
    _P, _P, _P,                                         # cnt_u, cnt_i, scratch
    _P, ctypes.c_int, ctypes.c_int,                     # cells, n_order, NU
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # bu, ni_pad, k
    ctypes.c_float, ctypes.c_float, ctypes.c_float,     # lr, r_scale, u_reg
    ctypes.c_float, _P, _P, _P]          # i_reg, stream, failed, launched
_SIGNATURES = {
    "dense_rows_epoch": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rtype,
        _P, _P, _P, _P,                     # wtype, mm, cn; u3, i_tab, R, W
        _P, _P, _P, _P, _P] + _EPOCH_TAIL),  # lu, li, qs, hist_u, hist_i
    "dense_cells_epoch": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rtype,
        _P, _P, _P, _P,                     # wtype, mm, cn; u3, i3, R, W
        _P, _P, _P,                         # cnt_u, cnt_i, scratch
        _P, _P, ctypes.c_int, ctypes.c_int,  # cells, counts, rounds, G
        ctypes.c_int,                                  # NU
        ctypes.c_int, ctypes.c_int, ctypes.c_int,      # bu, bi, k
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # lr, r_scale, u_reg
        ctypes.c_float, _P, _P, _P]),        # i_reg, stream, failed, launched
    "dense_rows_ablate": (ctypes.c_int, [
        ctypes.c_int, _P, _P, _P,                   # stage; u3, i_tab, R
        _P, _P, _P, _P, _P,    # cnt_u, cnt_i, scratch, cells, counts
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # rounds, lanes, NU
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # bu, ni_pad, k
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # lr, r_scale, u_reg
        ctypes.c_float, _P, _P, _P]),        # i_reg, stream, failed, launched
    "dense_rows_scratch_bytes": (ctypes.c_size_t, [ctypes.c_int] * 6),
    "dense_rows_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 4),
    "dense_rows_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc on first use)."""
    return _build.load("dense_rows", _SIGNATURES)


def tensor_cores(k: int, mm_bf16: bool) -> bool:
    """Whether the products run on the tensor cores (the bf16 copy of U, a
    launch an epoch) or on the CUDA cores (f32 products, or k > 128)."""
    return bool(mm_bf16) and k <= 128


def epoch_launches(n_rounds: int, k: int, mm_bf16: bool) -> int:
    """Kernel launches of one epoch on the card: the panel and step
    kernels of each round (a stripe, or a cell-grid round with a live
    cell), and the bf16 copy of U on the tensor-core route."""
    return 2 * n_rounds + tensor_cores(k, mm_bf16)


def stripe_cells(row_order: torch.Tensor, device) -> torch.Tensor:
    """The stripe epoch's rounds as the kernel reads them: int32 [NU, 2],
    (lane 0, stripe) for each visit in order, on ``device``."""
    order = row_order.to(device="cpu", dtype=torch.int32)
    return torch.stack([torch.zeros_like(order), order], 1).to(device)


def cells_plan(ub_idx: torch.Tensor, NU: int, k: int, mm_bf16: bool) -> dict:
    """How ``dense_cells_epoch`` runs the rounds ub_idx [R, NI] on the card:
    ``cells`` int32 [n_live, 2], the (lane, user block) pairs of every
    round, lanes ascending, a dummy lane (user block NU) left out as
    ``dense_sweep_diag`` skips it; ``counts`` int32 [R], each round's live
    cells (a round of none launches nothing); ``launches``, 2 a round with
    a live cell plus the bf16 copy of U (``epoch_launches``)."""
    idx = ub_idx.to(device="cpu", dtype=torch.int64)
    live = idx < NU
    lanes = torch.arange(idx.shape[1]).expand_as(idx)
    cells = torch.stack([lanes[live], idx[live]], 1).to(torch.int32)
    counts = live.sum(1, dtype=torch.int32)
    rounds = int((counts > 0).sum())
    return dict(cells=cells.contiguous(), counts=counts.contiguous(),
                rounds=rounds, launches=epoch_launches(rounds, k, mm_bf16))


def stripe_counts(R_rows: torch.Tensor, W_rows: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 validity counts of every stripe (or cell), (cnt_u [NU, bu],
    cnt_i [NU, ni_pad]): W > 0, or code != 0 for int8 codes (W_rows=None),
    one tile at a time on the tiles' device."""
    tiles = R_rows if W_rows is None else W_rows
    NU, bu, ni = tiles.shape
    cnt_u = torch.empty((NU, bu), dtype=torch.float32, device=tiles.device)
    cnt_i = torch.empty((NU, ni), dtype=torch.float32, device=tiles.device)
    for s in range(NU):
        valid = tiles[s] != 0 if W_rows is None else tiles[s] > 0
        cnt_u[s] = valid.sum(dim=1, dtype=torch.float32)
        cnt_i[s] = valid.sum(dim=0, dtype=torch.float32)
    return cnt_u, cnt_i


def rank_hists(R_rows: torch.Tensor, W_rows: Optional[torch.Tensor],
               Lu: torch.Tensor, Li: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Suffix histograms of the partners' lambdas, per stripe:
    hist_u [NU, bu, k] int32 with hist_u[s, u, l] = #{valid i in row u of
    stripe s : Li[i] > l}, and hist_i [NU, ni_pad, k] int16 the same for
    each item over the stripe's users (at most bu <= 32767 of them).
    Validity is W > 0, or code != 0 for int8 codes (W_rows=None). With a
    nondecreasing rank row q, #{valid i : q[Li[i] - 1] > d} is
    hist_u[s, u, j] for j the first index with q[j] > d: the stripe
    kernel's masked regularization counts. 0/1 f32 products, so the
    counts are exact."""
    tiles = R_rows if W_rows is None else W_rows
    NU, bu, ni = tiles.shape
    if bu > torch.iinfo(torch.int16).max:
        raise ValueError(f"int16 item histograms count at most 32767 users "
                         f"a stripe, not bu={bu}")
    dev = tiles.device
    levels = torch.arange(k, device=dev)
    above = lambda L: (L.to(dev)[..., None] > levels).to(torch.float32)
    g_i = above(Li)                                    # [ni, k]
    hist_u = torch.empty((NU, bu, k), dtype=torch.int32, device=dev)
    hist_i = torch.empty((NU, ni, k), dtype=torch.int16, device=dev)
    for s in range(NU):
        valid = (tiles[s] != 0 if W_rows is None else tiles[s] > 0)
        valid = valid.to(torch.float32)
        hist_u[s] = valid @ g_i
        hist_i[s] = valid.T @ above(Lu[s])
    return hist_u, hist_i


def _check_ranks(ranks, NU, bu, ni_pad, k, dev):
    Lu, Li, Q = ranks
    if (tuple(Lu.shape), tuple(Li.shape), tuple(Q.shape)) != (
            (NU, bu), (ni_pad,), (NU, k)):
        raise ValueError(f"ranks must be Lu [{NU}, {bu}], Li [{ni_pad}] and "
                         f"Q [{NU}, {k}]")
    if any(t.dtype != torch.int32 or t.device != dev for t in ranks):
        raise ValueError(f"ranks must be int32 tensors on {dev}")
    # the kernel's masked counts need rank rows nondecreasing in lambda
    ok = ((Q[:, 1:] >= Q[:, :-1]).all() & (Q >= 1).all() & (Q <= k).all()
          & (Lu >= 1).all() & (Lu <= k).all() & (Li >= 1).all()
          & (Li <= k).all())
    if not bool(ok):
        raise ValueError(f"ranks: Lu, Li and Q must lie in [1, {k}] and each "
                         "row of Q must be nondecreasing")


def _check_tiles(R, W, r_scale, tabs):
    if W is None:
        if R.dtype != torch.int8 or r_scale is None:
            raise ValueError("W=None means int8 rating codes in R with an "
                             "r_scale")
    elif W.shape != R.shape:
        raise ValueError("W tiles must have R's shape")
    tabs = tabs + [R] + ([] if W is None else [W])
    if any(t.device != tabs[0].device for t in tabs):
        raise ValueError("factor tables and tiles must share a device")
    if any(not t.is_contiguous() for t in tabs):
        raise ValueError("factor tables and tiles must be contiguous")
    if tabs[0].dtype != torch.float32 or tabs[1].dtype != torch.float32:
        raise ValueError("factor tables must be float32")


def _check_kernel_tiles(R, W, dev):
    """The tile types the CUDA kernel is instantiated for; (rtype, wtype)."""
    if dev.type != "cuda":
        raise ValueError(f"no route for device {dev}")
    if R.dtype not in _RTYPES or (
            W is not None and (W.dtype not in _WTYPES
                               or R.dtype == torch.int8)):
        raise ValueError("the CUDA kernel takes f32/bf16 R with int8, bf16 "
                         "or f32 W, or int8 codes without W")
    return _RTYPES[R.dtype], 0 if W is None else _WTYPES[W.dtype]


def _check_counts(counts, shapes, dev):
    if tuple(tuple(c.shape) for c in counts) != shapes or any(
            c.dtype != torch.float32 or c.device != dev
            or not c.is_contiguous() for c in counts):
        raise ValueError(f"counts must be contiguous f32 {shapes[0]} and "
                         f"{shapes[1]} on {dev}")


def _raise_failed(lib, what, err, failed, rtype, wtype, k, mm_bf16):
    msg = lib.dense_rows_error_string(err).decode()
    smem = lib.dense_rows_smem_bytes(rtype, wtype, k, int(mm_bf16))
    raise RuntimeError(
        f"dense_rows kernel launch failed on {what} {failed}: {msg} "
        f"(cudaError {err}; {smem} B shared memory per block)")


def _check(u3, i_tab, row_order, R_rows, W_rows, r_scale):
    if u3.dim() != 3 or i_tab.dim() != 2 or R_rows.dim() != 3:
        raise ValueError("want u3 [NU, bu, k], i_tab [ni_pad, k], "
                         "R_rows [NU, bu, ni_pad]")
    NU, bu, k = u3.shape
    ni_pad = i_tab.shape[0]
    if i_tab.shape[1] != k or tuple(R_rows.shape) != (NU, bu, ni_pad):
        raise ValueError(f"shape mismatch: u3 {tuple(u3.shape)}, i_tab "
                         f"{tuple(i_tab.shape)}, R_rows "
                         f"{tuple(R_rows.shape)}")
    _check_tiles(R_rows, W_rows, r_scale, [u3, i_tab])
    if row_order.dim() != 1 or row_order.numel() != NU or \
            row_order.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"row_order must be [{NU}] integer stripe ids")
    # each stripe once: the kernel reads a bf16 copy of U made at the
    # epoch's start, which a second visit of a stripe would find stale
    if not torch.equal(torch.sort(row_order.cpu()).values,
                       torch.arange(NU, dtype=row_order.dtype)):
        raise ValueError(f"row_order must be a permutation of [0, {NU})")


def dense_rows_epoch(u3: torch.Tensor, i_tab: torch.Tensor,
                     row_order: torch.Tensor, lr,
                     R_rows: torch.Tensor, W_rows: Optional[torch.Tensor],
                     r_scale: Optional[float], u_reg: float, i_reg: float,
                     collision_norm: bool, mm_bf16: bool,
                     counts: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None, ranks: Optional[Ranks] = None,
                     hists: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One row-stripe dense epoch over the stripes of ``row_order`` (a
    permutation of the NU stripes).

    u3 [NU, bu, k] f32, i_tab [ni_pad, k] f32, R_rows [NU, bu, ni_pad]
    (f32/bf16 ratings with int8, bf16 or f32 weights W_rows, or int8 codes
    with W_rows=None and r_scale). ``counts``: the tiles'
    ``stripe_counts``, computed here when not given. ``ranks``: (Lu, Li,
    Q) rank masks, see the module docstring; ``hists``: their
    ``rank_hists``, computed here when not given. Updates u3 and i_tab IN
    PLACE and returns them."""
    _check(u3, i_tab, row_order, R_rows, W_rows, r_scale)
    NU, bu, k = u3.shape
    ni_pad = i_tab.shape[0]
    if ranks is not None:
        with span("stripes.ranks"):
            _check_ranks(ranks, NU, bu, ni_pad, k, u3.device)
            if u3.device.type != "cpu":
                # the kernels read each stripe's rank row: that of its visit
                Q = ranks[2]
                Qs = torch.empty_like(Q)
                Qs[row_order.to(device=Q.device, dtype=torch.int64)] = Q
    if u3.device.type == "cpu":
        Lu, Li, Q = ranks if ranks is not None else (None, None, None)
        return dense_sweep_rows(u3, i_tab, row_order, lr, R_rows, W_rows,
                                u_reg, i_reg, collision_norm, mm_bf16,
                                r_scale=r_scale, Lu3=Lu, Li=Li, Q=Q)
    rtype, wtype = _check_kernel_tiles(R_rows, W_rows, u3.device)
    if ranks is not None and W_rows is not None and \
            W_rows.dtype != torch.int8:
        raise ValueError(f"rank masks are instantiated for int8 codes and "
                         f"int8 W tiles, not {R_rows.dtype} R with "
                         f"{W_rows.dtype} W")
    lib = library()
    if counts is None:
        counts = stripe_counts(R_rows, W_rows)
    _check_counts(counts, ((NU, bu), (NU, ni_pad)), u3.device)
    cnt_u, cnt_i = counts
    masks = [None] * 5
    if ranks is not None:
        Lu, Li, _ = ranks
        if hists is None:
            hists = rank_hists(R_rows, W_rows, Lu, Li, k)
        hist_u, hist_i = hists
        if (tuple(hist_u.shape), tuple(hist_i.shape)) != (
                (NU, bu, k), (NU, ni_pad, k)) or \
                (hist_u.dtype, hist_i.dtype) != (torch.int32, torch.int16) \
                or any(h.device != u3.device or not h.is_contiguous()
                       for h in hists):
            raise ValueError(f"hists must be contiguous int32 [{NU}, {bu}, "
                             f"{k}] and int16 [{NU}, {ni_pad}, {k}] on "
                             f"{u3.device}")
        masks = [Lu.contiguous(), Li.contiguous(), Qs, hist_u, hist_i]
    # the stripe's user and item gradients (the kernels leave them zeroed)
    # and the bf16 copy of U
    scratch = torch.zeros(lib.dense_rows_scratch_bytes(1, NU, bu, ni_pad, k,
                                                       int(mm_bf16)),
                          dtype=torch.uint8, device=u3.device)
    cells = stripe_cells(row_order, u3.device)
    failed, launched = ctypes.c_longlong(-1), ctypes.c_longlong(0)
    with torch.cuda.device(u3.device):
        err = lib.dense_rows_epoch(
            rtype, wtype, int(mm_bf16), int(collision_norm), u3.data_ptr(),
            i_tab.data_ptr(), R_rows.data_ptr(),
            None if W_rows is None else W_rows.data_ptr(),
            *(None if m is None else m.data_ptr() for m in masks),
            cnt_u.data_ptr(), cnt_i.data_ptr(), scratch.data_ptr(),
            cells.data_ptr(), NU, NU, bu, ni_pad, k, float(lr),
            float(r_scale or 0.0), float(u_reg), float(i_reg),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(failed),
            ctypes.byref(launched))
    dense_rows_epoch.launches += launched.value
    if err != 0:
        _raise_failed(lib, "stripe", err, failed.value, rtype, wtype, k,
                      mm_bf16)
    return u3, i_tab


dense_rows_epoch.launches = 0


def _check_cells(u3, i3, ub_idx, R_cells, W_cells, r_scale):
    if u3.dim() != 3 or i3.dim() != 3 or R_cells.dim() != 3:
        raise ValueError("want u3 [NU, bu, k], i3 [NI, bi, k], R_cells "
                         "[NU * NI + 1, bu, bi]")
    NU, bu, k = u3.shape
    NI, bi = i3.shape[:2]
    if i3.shape[2] != k or tuple(R_cells.shape) != (NU * NI + 1, bu, bi):
        raise ValueError(f"shape mismatch: u3 {tuple(u3.shape)}, i3 "
                         f"{tuple(i3.shape)}, R_cells "
                         f"{tuple(R_cells.shape)}")
    _check_tiles(R_cells, W_cells, r_scale, [u3, i3])
    if ub_idx.dim() != 2 or ub_idx.shape[1] != NI or \
            ub_idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ub_idx must be [rounds, {NI}] integer user "
                         "blocks")
    idx = ub_idx.cpu().to(torch.int64)
    if bool(((idx < 0) | (idx > NU)).any()):
        raise ValueError(f"ub_idx must lie in [0, {NU}] ({NU}: a dummy "
                         "lane)")
    # the lanes of a round run together from the round's old tables, as in
    # JAX, only when no user block appears twice in a round
    real = torch.where(idx < NU, idx, -1 - torch.arange(NI))
    if bool((real.sort(dim=1).values.diff(dim=1) == 0).any()):
        raise ValueError("a user block appears twice in one round of "
                         "ub_idx")


def dense_cells_epoch(u3: torch.Tensor, i3: torch.Tensor,
                      ub_idx: torch.Tensor, lr, R_cells: torch.Tensor,
                      W_cells: Optional[torch.Tensor],
                      r_scale: Optional[float], u_reg: float, i_reg: float,
                      collision_norm: bool, mm_bf16: bool,
                      counts: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One diag cell-grid dense epoch over the rounds of ``ub_idx``.

    u3 [NU, bu, k] f32, i3 [NI, bi, k] f32, ub_idx [R, NI] (lane l owns
    item block l; NU marks a dummy lane; no user block twice in a round),
    R_cells [NU * NI + 1, bu, bi] in cell-major order (cell ub * NI + l,
    the dummy cell last; f32/bf16 ratings with int8, bf16 or f32 weights
    W_cells, or int8 codes with W_cells=None and r_scale). ``counts``: the
    cells' ``stripe_counts``, computed here when not given. A CPU tensor
    runs the plain ``dense_sweep_diag``, a CUDA tensor the kernel. Updates
    u3 and i3 IN PLACE and returns them."""
    _check_cells(u3, i3, ub_idx, R_cells, W_cells, r_scale)
    NU, bu, k = u3.shape
    NI, bi = i3.shape[:2]
    if u3.device.type == "cpu":
        return dense_sweep_diag(u3, i3, ub_idx, lr, R_cells, W_cells, u_reg,
                                i_reg, collision_norm, mm_bf16,
                                r_scale=r_scale)
    rtype, wtype = _check_kernel_tiles(R_cells, W_cells, u3.device)
    lib = library()
    if counts is None:
        counts = stripe_counts(R_cells, W_cells)
    n_cells = NU * NI + 1
    _check_counts(counts, ((n_cells, bu), (n_cells, bi)), u3.device)
    cnt_u, cnt_i = counts
    # the lanes' gradients (the kernels leave them zeroed) and the bf16
    # copy of U
    scratch = torch.zeros(lib.dense_rows_scratch_bytes(NI, NU, bu, bi, k,
                                                       int(mm_bf16)),
                          dtype=torch.uint8, device=u3.device)
    plan = cells_plan(ub_idx, NU, k, mm_bf16)
    cells, per_round = plan["cells"].to(u3.device), plan["counts"]
    failed, launched = ctypes.c_longlong(-1), ctypes.c_longlong(0)
    with torch.cuda.device(u3.device):
        err = lib.dense_cells_epoch(
            rtype, wtype, int(mm_bf16), int(collision_norm), u3.data_ptr(),
            i3.data_ptr(), R_cells.data_ptr(),
            None if W_cells is None else W_cells.data_ptr(),
            cnt_u.data_ptr(), cnt_i.data_ptr(), scratch.data_ptr(),
            cells.data_ptr(), per_round.data_ptr(), per_round.numel(), NI,
            NU, bu, bi, k, float(lr), float(r_scale or 0.0), float(u_reg),
            float(i_reg),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(failed),
            ctypes.byref(launched))
    dense_cells_epoch.launches += launched.value
    if err != 0:
        _raise_failed(lib, "round", err, failed.value, rtype, wtype, k,
                      mm_bf16)
    return u3, i3


dense_cells_epoch.launches = 0
