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
raises. One C call runs the epoch's stripes in order;
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
tiles of the 0/1-weight models that carry them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.ops.dense_block_kernel import dense_sweep_rows

Ranks = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

KERNELS_PER_STRIPE = 2     # panel kernel + step kernel
_RTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_WTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

_P = ctypes.c_void_p
_EPOCH_TAIL = [
    _P, _P, _P,                                         # cnt_u, cnt_i, scratch
    _P, ctypes.c_int, ctypes.c_int,                     # order, n_order, NU
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # bu, ni_pad, k
    ctypes.c_float, ctypes.c_float, ctypes.c_float,     # lr, r_scale, u_reg
    ctypes.c_float, _P, _P, _P]          # i_reg, stream, failed, launched
_SIGNATURES = {
    "dense_rows_epoch": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rtype,
        _P, _P, _P, _P,                     # wtype, mm, cn; u3, i_tab, R, W
        _P, _P, _P, _P, _P] + _EPOCH_TAIL),  # lu, li, qs, hist_u, hist_i
    "dense_rows_ablate": (ctypes.c_int, [
        ctypes.c_int, _P, _P, _P] + _EPOCH_TAIL),   # stage; u3, i_tab, R
    "dense_rows_scratch_bytes": (ctypes.c_size_t, [ctypes.c_int] * 5),
    "dense_rows_epoch_launches": (ctypes.c_longlong, [ctypes.c_int] * 3),
    "dense_rows_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 4),
    "dense_rows_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc on first use)."""
    return _build.load("dense_rows", _SIGNATURES)


def epoch_launches(n_stripes: int, k: int, mm_bf16: bool) -> int:
    """Kernel launches of one epoch on the card."""
    return library().dense_rows_epoch_launches(n_stripes, k, int(mm_bf16))


def stripe_counts(R_rows: torch.Tensor, W_rows: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 validity counts of every stripe, (cnt_u [NU, bu], cnt_i [NU,
    ni_pad]): W > 0, or code != 0 for int8 codes (W_rows=None), one stripe
    at a time on the tiles' device."""
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
    if W_rows is None:
        if R_rows.dtype != torch.int8 or r_scale is None:
            raise ValueError("W_rows=None means int8 rating codes in "
                             "R_rows with an r_scale")
    elif W_rows.shape != R_rows.shape:
        raise ValueError("W_rows must have R_rows' shape")
    tabs = [u3, i_tab, R_rows] + ([] if W_rows is None else [W_rows])
    if any(t.device != u3.device for t in tabs):
        raise ValueError("u3, i_tab, R_rows and W_rows must share a device")
    if any(not t.is_contiguous() for t in tabs):
        raise ValueError("u3, i_tab, R_rows and W_rows must be contiguous")
    if u3.dtype != torch.float32 or i_tab.dtype != torch.float32:
        raise ValueError("factor tables must be float32")
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
        _check_ranks(ranks, NU, bu, ni_pad, k, u3.device)
    if u3.device.type == "cpu":
        Lu, Li, Q = ranks if ranks is not None else (None, None, None)
        return dense_sweep_rows(u3, i_tab, row_order, lr, R_rows, W_rows,
                                u_reg, i_reg, collision_norm, mm_bf16,
                                r_scale=r_scale, Lu3=Lu, Li=Li, Q=Q)
    if u3.device.type != "cuda":
        raise ValueError(f"no route for device {u3.device}")
    if R_rows.dtype not in _RTYPES or (
            W_rows is not None and (W_rows.dtype not in _WTYPES
                                    or R_rows.dtype == torch.int8)):
        raise ValueError("the CUDA kernel takes f32/bf16 R with int8, bf16 "
                         "or f32 W, or int8 codes without W")
    if ranks is not None and W_rows is not None and \
            W_rows.dtype != torch.int8:
        raise ValueError(f"rank masks are instantiated for int8 codes and "
                         f"int8 W tiles, not {R_rows.dtype} R with "
                         f"{W_rows.dtype} W")
    lib = library()
    rtype = _RTYPES[R_rows.dtype]
    wtype = 0 if W_rows is None else _WTYPES[W_rows.dtype]
    if counts is None:
        counts = stripe_counts(R_rows, W_rows)
    cnt_u, cnt_i = counts
    if (tuple(cnt_u.shape), tuple(cnt_i.shape)) != ((NU, bu), (NU, ni_pad)) \
            or any(c.dtype != torch.float32 or c.device != u3.device
                   or not c.is_contiguous() for c in counts):
        raise ValueError(f"counts must be contiguous f32 [{NU}, {bu}] and "
                         f"[{NU}, {ni_pad}] on {u3.device}")
    masks = [None] * 5
    if ranks is not None:
        Lu, Li, Q = ranks
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
        # the kernels read each stripe's rank row: that of its visit
        Qs = torch.empty_like(Q)
        Qs[row_order.to(device=Q.device, dtype=torch.int64)] = Q
        masks = [Lu.contiguous(), Li.contiguous(), Qs, hist_u, hist_i]
    # the stripe's user and item gradients (the kernels leave them zeroed)
    # and the bf16 copy of U
    scratch = torch.zeros(lib.dense_rows_scratch_bytes(NU, bu, ni_pad, k,
                                                       int(mm_bf16)),
                          dtype=torch.uint8, device=u3.device)
    order = row_order.to(device="cpu", dtype=torch.int64).contiguous()
    failed, launched = ctypes.c_longlong(-1), ctypes.c_longlong(0)
    with torch.cuda.device(u3.device):
        err = lib.dense_rows_epoch(
            rtype, wtype, int(mm_bf16), int(collision_norm), u3.data_ptr(),
            i_tab.data_ptr(), R_rows.data_ptr(),
            None if W_rows is None else W_rows.data_ptr(),
            *(None if m is None else m.data_ptr() for m in masks),
            cnt_u.data_ptr(), cnt_i.data_ptr(), scratch.data_ptr(),
            order.data_ptr(), NU, NU, bu, ni_pad, k, float(lr),
            float(r_scale or 0.0), float(u_reg), float(i_reg),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(failed),
            ctypes.byref(launched))
    dense_rows_epoch.launches += launched.value
    if err != 0:
        msg = lib.dense_rows_error_string(err).decode()
        smem = lib.dense_rows_smem_bytes(rtype, wtype, k, int(mm_bf16))
        raise RuntimeError(
            f"dense_rows kernel launch failed on stripe {failed.value}: "
            f"{msg} (cudaError {err}; {smem} B shared memory per block)")
    return u3, i_tab


dense_rows_epoch.launches = 0
