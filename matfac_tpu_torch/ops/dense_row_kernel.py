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

``StripeTiles`` holds one staged set of tiles and everything the kernel
reads that no epoch changes, made and checked once when it is built: the
tiles, their validity counts (``stripe_counts``), the scratch and, for
rank masks, the rank tables and their suffix histograms (``rank_hists``).
The tiles' device is the route: on the CPU it stages nothing and runs the
plain ``dense_sweep_rows`` / ``dense_sweep_diag``; on a CUDA device a
tile type the kernel does not take raises when it is built. An epoch
takes only what changes (the tables, the order, ``lr`` and TMF+Dropout's
uniforms), checks them on the host and, on the card, makes one
host-to-device copy (the order, with the uniforms) and no card sync,
enqueued on the current stream: the device buffers are staged once and
reused in stream order. ``StripeTiles.launches`` counts kernel launches:
two a round (the panel kernel and the step kernel, which steps the
items and the round's users), plus one an epoch for the bf16 copy of U
when the products run on the tensor cores (``epoch_launches``).

``rows_epoch`` runs the row stripes: one C call runs the epoch's stripes
in order, each a round of one cell (``stripe_cells``). Rank masks (TMF,
TMF+Dropout) come as ``ranks=(Lu, Li)``: int32 lambda (or rank) tables
of the stripes' users [NU, bu] and of the items [ni_pad], in [1, k], with
``pois_cdf``, TMF+Dropout's Poisson CDF table [k, k], from which each
visit's rank row is drawn at its uniform (``visit_quantiles``), or None
for static ranks (``identity_quantiles``). A table whose columns do not
increase down its rows makes every rank row nondecreasing in lambda and
in [1, k], which the kernel's lookup of its masked regularization counts
in the histograms needs: both are checked when the object is built, so
no epoch checks a rank. The masks are instantiated for int8 codes and
int8 validity W only, the tiles of the 0/1-weight models that carry
them. An epoch's rank draw runs in the span ``stripes.ranks``.

``cells_epoch`` is the same kernel's cell-grid entry, the port of the
JAX dense engine's diag cell grid (``dense_sweep_diag``, which XLA
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
                                                    dense_sweep_rows,
                                                    identity_quantiles,
                                                    visit_quantiles)
from matfac_tpu_torch.train.profiler import span

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
    """How ``cells_epoch`` runs the rounds ub_idx [R, NI] on the card:
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


def _host_ints(t, name: str, dims: int) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu" or \
            t.dim() != dims or t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name} must be a {dims}-D int32 or int64 host "
                         "tensor")
    return t


class StripeTiles:
    """One staged set of the kernel's tiles (see the module docstring).

    R [n, bu, width]: f32/bf16 ratings with int8, bf16 or f32 weights W,
    or int8 codes with W=None and ``r_scale``. ``NI`` None: the row
    stripes, n = NU and width the padded catalog; else the diag cell grid
    in cell-major order, n = NU * NI + 1 (cell ub * NI + lane, the
    all-invalid dummy cell last) and width bi. ``k``: the factor tables'
    width. ``ranks`` (Lu, Li) and ``pois_cdf``: the rank masks of the row
    stripes."""

    launches = 0    # kernel launches of every object's epochs

    def __init__(self, R: torch.Tensor, W: Optional[torch.Tensor],
                 r_scale: Optional[float], k: int, u_reg: float,
                 i_reg: float, collision_norm: bool, mm_bf16: bool,
                 NI: Optional[int] = None,
                 ranks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 pois_cdf: Optional[torch.Tensor] = None):
        if R.dim() != 3:
            raise ValueError("tiles must be [n_tiles, bu, width]")
        if W is None:
            if R.dtype != torch.int8 or r_scale is None:
                raise ValueError("W=None means int8 rating codes in R with "
                                 "an r_scale")
        elif W.shape != R.shape:
            raise ValueError("W tiles must have R's shape")
        if any(t is not None and (t.device != R.device
                                  or not t.is_contiguous())
               for t in (R, W, pois_cdf, *(ranks or ()))):
            raise ValueError("tiles and rank tables must be contiguous and "
                             "on one device")
        n, self.bu, self.width = R.shape
        if NI is not None and (n < NI + 1 or (n - 1) % NI):
            raise ValueError(f"cell tiles must be [NU * {NI} + 1, bu, bi], "
                             f"not {tuple(R.shape)}")
        self.NU = n if NI is None else (n - 1) // NI
        self.R, self.W, self.r_scale, self.NI = R, W, r_scale, NI
        self.k, self.u_reg, self.i_reg = int(k), float(u_reg), float(i_reg)
        self.collision_norm, self.mm_bf16 = bool(collision_norm), \
            bool(mm_bf16)
        self.ranks, self.pois_cdf = ranks, pois_cdf
        if ranks is not None or pois_cdf is not None:
            self._check_ranks()
        self.device = R.device
        self.counts = self.hists = None
        if self.device.type == "cuda":
            self._stage()
        elif self.device.type != "cpu":
            raise ValueError(f"no route for device {self.device}")

    @staticmethod
    def hist_bytes(NU: int, bu: int, width: int, k: int, device) -> int:
        """Bytes of the rank histograms a masked object stages on
        ``device``: int32 [NU, bu, k] and int16 [NU, width, k] on a CUDA
        device, none on the CPU."""
        return NU * k * (4 * bu + 2 * width) \
            if torch.device(device).type == "cuda" else 0

    def _check_ranks(self) -> None:
        NU, k = self.NU, self.k
        if self.NI is not None or self.ranks is None:
            raise ValueError("rank masks take (Lu, Li) on the row stripes")
        Lu, Li = self.ranks
        if (tuple(Lu.shape), tuple(Li.shape)) != ((NU, self.bu),
                                                  (self.width,)) \
                or Lu.dtype != torch.int32 or Li.dtype != torch.int32:
            raise ValueError(f"ranks must be int32 Lu [{NU}, {self.bu}] and "
                             f"Li [{self.width}]")
        if not bool((Lu >= 1).all() & (Lu <= k).all() & (Li >= 1).all()
                    & (Li <= k).all()):
            raise ValueError(f"ranks: Lu and Li must lie in [1, {k}]")
        # every visit's rank row clip(#{m : C[lam - 1, m] < U}, 1, k) is
        # then nondecreasing in lam: the kernel's histogram lookup needs it
        C = self.pois_cdf
        if C is not None and (tuple(C.shape) != (k, k)
                              or C.dtype != torch.float32
                              or not bool((C[1:] <= C[:-1]).all())):
            raise ValueError(f"pois_cdf must be f32 [{k}, {k}] with columns "
                             "that do not increase down its rows")

    def _stage(self) -> None:
        """The kernel's inputs that no epoch changes, made once."""
        R, W, dev = self.R, self.W, self.device
        if R.dtype not in _RTYPES or (
                W is not None and (W.dtype not in _WTYPES
                                   or R.dtype == torch.int8)):
            raise ValueError("the CUDA kernel takes f32/bf16 R with int8, "
                             "bf16 or f32 W, or int8 codes without W")
        if self.ranks is not None and W is not None and \
                W.dtype != torch.int8:
            raise ValueError(f"rank masks are instantiated for int8 codes "
                             f"and int8 W tiles, not {R.dtype} R with "
                             f"{W.dtype} W")
        self._types = (_RTYPES[R.dtype], 0 if W is None else _WTYPES[W.dtype])
        self._lib = library()
        self.counts = stripe_counts(R, W)
        lanes = 1 if self.NI is None else self.NI
        # a round's gradients (the kernels leave them zeroed) and the bf16
        # copy of U
        self._scratch = torch.zeros(
            self._lib.dense_rows_scratch_bytes(lanes, self.NU, self.bu,
                                               self.width, self.k,
                                               int(self.mm_bf16)),
            dtype=torch.uint8, device=dev)
        # where an epoch's copy lands: (lane, tile) a visit, every cell once
        # in a cell-grid epoch, then TMF+Dropout's uniforms
        self._order = torch.empty(
            2 * self.NU * lanes + (self.pois_cdf is not None) * self.NU,
            dtype=torch.int32, device=dev)
        self._masks = [None] * 5
        if self.ranks is not None:
            self.hists = rank_hists(R, W, *self.ranks, self.k)
            static = identity_quantiles(self.NU, self.k, dev)
            self._masks = [*self.ranks,
                           static if self.pois_cdf is None else None,
                           *self.hists]

    def visit_ranks(self, round_u: Optional[torch.Tensor] = None):
        """(Lu, Li, Q) of an epoch, Q [NU, k] the rank row of each visit in
        order (the plain version's form), or None without rank masks."""
        if self.ranks is None:
            return None
        return (*self.ranks, identity_quantiles(self.NU, self.k, self.device)
                if self.pois_cdf is None
                else visit_quantiles(self.pois_cdf, round_u))

    def _check_tables(self, u3, tab, tab_shape) -> None:
        want = ((self.NU, self.bu, self.k), tab_shape)
        if any(tuple(t.shape) != s or t.dtype != torch.float32
               or t.device != self.device or not t.is_contiguous()
               for t, s in zip((u3, tab), want)):
            raise ValueError(
                f"factor tables must be contiguous f32 {want[0]} and "
                f"{want[1]} on {self.device}, not {u3.dtype} "
                f"{tuple(u3.shape)} and {tab.dtype} {tuple(tab.shape)}")

    def _upload(self, parts) -> torch.Tensor:
        """The epoch's one host-to-device copy, of the int32 ``parts``
        through pinned memory into the staged buffer, enqueued on the
        current stream behind the last epoch's kernels; its device view."""
        host = torch.cat(parts).pin_memory()
        if host.numel() > self._order.numel():   # a cell visited twice
            self._order = torch.empty(host.numel(), dtype=torch.int32,
                                      device=self.device)
        buf = self._order[:host.numel()]
        buf.copy_(host, non_blocking=True)
        return buf

    def rows_epoch(self, u3: torch.Tensor, i_tab: torch.Tensor,
                   row_order: torch.Tensor, lr,
                   round_u: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One row-stripe epoch over the stripes of ``row_order`` (a host
        permutation of the NU stripes); ``round_u`` [NU] f32 host uniforms,
        one a visit in order, with the CDF table, else None. Updates u3
        [NU, bu, k] and i_tab [ni_pad, k] IN PLACE and returns them."""
        NU = self.NU
        if self.NI is not None:
            raise ValueError("cell-grid tiles run cells_epoch")
        self._check_tables(u3, i_tab, (self.width, self.k))
        order = _host_ints(row_order, "row_order", 1)
        # each stripe once: the kernel reads a bf16 copy of U made at the
        # epoch's start, which a second visit of a stripe would find stale
        if order.numel() != NU or not torch.equal(
                torch.sort(order).values, torch.arange(NU,
                                                       dtype=order.dtype)):
            raise ValueError(f"row_order must be a permutation of [0, {NU})")
        if (round_u is None) != (self.pois_cdf is None) or (
                round_u is not None and (
                    tuple(round_u.shape) != (NU,) or round_u.device.type
                    != "cpu" or round_u.dtype != torch.float32)):
            raise ValueError(f"round_u: [{NU}] f32 host uniforms with the "
                             "CDF table, else None")
        if self.device.type == "cpu":
            Lu = Li = Q = None
            if self.ranks is not None:
                with span("stripes.ranks"):
                    Lu, Li, Q = self.visit_ranks(round_u)
            return dense_sweep_rows(u3, i_tab, order, lr, self.R, self.W,
                                    self.u_reg, self.i_reg,
                                    self.collision_norm, self.mm_bf16,
                                    r_scale=self.r_scale, Lu3=Lu, Li=Li, Q=Q)
        cells = stripe_cells(order, "cpu").view(-1)
        if round_u is None:
            buf = self._upload([cells])
        else:
            with span("stripes.ranks"):
                # the uniforms in stripe order: the kernels read stripe s's
                # rank row at row s
                us = torch.empty_like(round_u)
                us[order.long()] = round_u
                buf = self._upload([cells, us.view(torch.int32)])
                self._masks[2] = visit_quantiles(
                    self.pois_cdf, buf[2 * NU:].view(torch.float32))
        return self._launch("dense_rows_epoch", "stripe", u3, i_tab, lr, [
            *self._masks, *self.counts, self._scratch, buf, NU, NU, self.bu,
            self.width])

    def cells_epoch(self, u3: torch.Tensor, i3: torch.Tensor,
                    ub_idx: torch.Tensor, lr
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One diag cell-grid epoch over the rounds of ``ub_idx`` [R, NI]
        (host ints; lane l owns item block l; NU marks a dummy lane; no
        user block twice in a round). Updates u3 [NU, bu, k] and i3 [NI,
        bi, k] IN PLACE and returns them."""
        NU, NI = self.NU, self.NI
        if NI is None:
            raise ValueError("row-stripe tiles run rows_epoch")
        self._check_tables(u3, i3, (NI, self.width, self.k))
        idx = _host_ints(ub_idx, "ub_idx", 2)
        if idx.shape[1] != NI:
            raise ValueError(f"ub_idx must be [rounds, {NI}] user blocks")
        idx = idx.to(torch.int64)
        if bool(((idx < 0) | (idx > NU)).any()):
            raise ValueError(f"ub_idx must lie in [0, {NU}] ({NU}: a dummy "
                             "lane)")
        # the lanes of a round run together from the round's old tables, as
        # in JAX, only when no user block appears twice in a round
        real = torch.where(idx < NU, idx, -1 - torch.arange(NI))
        if bool((real.sort(dim=1).values.diff(dim=1) == 0).any()):
            raise ValueError("a user block appears twice in one round of "
                             "ub_idx")
        if self.device.type == "cpu":
            return dense_sweep_diag(u3, i3, idx, lr, self.R, self.W,
                                    self.u_reg, self.i_reg,
                                    self.collision_norm, self.mm_bf16,
                                    r_scale=self.r_scale)
        plan = cells_plan(idx, NU, self.k, self.mm_bf16)
        per_round = plan["counts"]     # a host array the C entry reads
        buf = self._upload([plan["cells"].view(-1)])
        return self._launch("dense_cells_epoch", "round", u3, i3, lr, [
            *self.counts, self._scratch, buf, per_round, per_round.numel(),
            NI, NU, self.bu, self.width])

    def _launch(self, entry: str, what: str, u3, tab, lr, args):
        """One call of the C ``entry`` on the current stream; ``args`` its
        arguments between the tiles and k."""
        ptr = lambda a: a.data_ptr() if isinstance(a, torch.Tensor) else a
        failed, launched = ctypes.c_longlong(-1), ctypes.c_longlong(0)
        with torch.cuda.device(self.device):
            err = getattr(self._lib, entry)(
                *self._types, int(self.mm_bf16), int(self.collision_norm),
                u3.data_ptr(), tab.data_ptr(), self.R.data_ptr(),
                ptr(self.W), *(ptr(a) for a in args), self.k, float(lr),
                float(self.r_scale or 0.0), self.u_reg, self.i_reg,
                torch.cuda.current_stream().cuda_stream,
                ctypes.byref(failed), ctypes.byref(launched))
        StripeTiles.launches += launched.value
        if err != 0:
            self._scratch.zero_()    # a failed round may leave gradients
            msg = self._lib.dense_rows_error_string(err).decode()
            smem = self._lib.dense_rows_smem_bytes(*self._types, self.k,
                                                   int(self.mm_bf16))
            raise RuntimeError(
                f"dense_rows kernel launch failed on {what} {failed.value}: "
                f"{msg} (cudaError {err}; {smem} B shared memory per block)")
        return u3, tab
