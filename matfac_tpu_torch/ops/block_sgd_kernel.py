"""One-hot cell SGD epochs: the hand-written CUDA kernel's wrappers and their
plain PyTorch versions.

Port of matfac_tpu/ops/block_sgd_kernel.py. Users and items are cut into
blocks of bu / bi rows; the ratings of each (user block x item block) cell
are staged as a stream (solvers/block_sgd.py), and a minibatch of a cell
gathers its factor rows, forms the weighted, rank-masked residual and the
per-occurrence regularization, divides by the host-staged collision counts
and adds the summed update of each row once (``batch_update``). The TPU ran
the gathers and the scatter as one-hot matmuls; here they are gathers and
``index_add_``, with the same rounding points:

  * ``mm_bf16``: pu = bf16(U[u]), qi = bf16(I[i]) (the regularization uses
    them too), and each row adds the f32 sum of its bf16-rounded -lr*g
    terms to the f32 table ONCE;
  * every gather of a step reads the pre-step blocks.

The Pallas kernel ``block_sgd_epoch`` (row schedule) and the diag schedule's
step become ONE CUDA kernel, ``csrc/block_sgd.cu`` (design and cost notes
there); ``ops/sgd_kernel.fused_cell_update`` is a one-lane use of it.
Not carried over: the dummy factor block u3[NU] (dummy lanes of the diag
schedule are skipped), the VMEM guard and ``pad_k`` (MXU lane filling).

``block_sgd_epoch`` (row schedule) and ``block_sgd_diag_epoch`` take the
tensors' device as the route: a CPU tensor runs the plain version
(``block_sweep_rows`` / ``block_sweep_diag``); a CUDA tensor launches the
kernel or raises. On the card an epoch is ONE launch over a device table of
lanes (``row_lanes`` / ``epoch_lanes``, built in numpy, one copy to the
device); each wrapper's ``launches`` counts launches (one per epoch), and
its ``cells`` is a device counter the kernel adds each finished (lane,
cell) to, read only when asked (``cells_done``). The kernel reads the
streams as ``slice_tables``: each batch slice's valid slots sorted by row,
once per side, cut into segments. ``stage_slices`` checks the stream ids
and builds those tables once; a caller that runs many epochs on the same
streams (``BlockSGDSolver``) stages them once and passes them as
``slices=``, and a call without them checks and stages its streams anew.
Both wrappers update ``u_tab`` and ``i_tab`` IN PLACE and return them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from matfac_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_TABLES = ("meta_u", "meta_i", "own_u", "own_i", "seg_u", "seg_i", "ent_u",
           "ent_i", "cnt")
_SIGNATURES = {
    "block_sgd_run": (_I, [
        _I, _I, _I,                          # mm_bf16, cn, mask
        _P, _P] + [_P] * len(_TABLES) + [    # u_tab, i_tab, the slices
        _P, _I, _I, _I, _I, _I, _I, _I,      # lanes, rounds, n_par, n_batch,
        _F, _F, _F,                          #   bs, bu, bi, k; -lr, 2 regs
        _I, _I, _I, _P, _P, _P, _P]),        # C, Q, range; scratch, bar,
                                             #   cells, stream
    "block_sgd_ablate": (_I, [
        _I, _P, _P] + [_P] * len(_TABLES) + [   # stage, tables, slices
        _P, _I, _I, _I, _I, _I, _I, _I,      # lanes, rounds, ..., k
        _F, _F, _F, _P, _P, _P, _P, _I]),    # scratch, work, sink, st, C
    "block_sgd_plan": (_I, [_I] * 6 + [_P]),
    "block_sgd_scratch_floats": (ctypes.c_size_t, [_I] * 7),
    "block_sgd_error_string": (ctypes.c_char_p, [_I]),
}
ROUTES = ("cluster", "scratch")
# cudaErrorCooperativeLaunchTooLarge: the clusters cannot all be resident
_NOT_CO_RESIDENT = 720
MAX_ROWS = 32767   # kMaxRows: a row is 15 bits of an entry
MAX_BATCH = 16384  # kMaxBatch: a batch's segments fit 15 bits


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc on first use)."""
    return _build.load("block_sgd", _SIGNATURES)


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def batch_update(U: torch.Tensor, I: torch.Tensor, u, i, r, w,
                 cnu: Optional[torch.Tensor], cni: Optional[torch.Tensor],
                 lam: Optional[torch.Tensor], lr: float, u_reg: float,
                 i_reg: float, collision_norm: bool, use_mask: bool,
                 mm_bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch on L independent lanes (JAX ``_batch_update`` under a
    vmap): U [L, bu, k], I [L, bi, k] f32 blocks; u, i, lam int and r, w,
    cnu, cni f32, each [L, b]. Returns the new (U, I)."""
    L, bu, k = U.shape
    bi = I.shape[1]
    u, i = u.long(), i.long()
    lane = torch.arange(L, device=U.device)[:, None]
    pu, qi = U[lane, u], I[lane, i]                    # [L, b, k]
    if mm_bf16:
        pu, qi = _bf16(pu), _bf16(qi)
    if use_mask:
        m = (torch.arange(k, device=U.device) < lam[..., None]).to(
            torch.float32)
        pred = (pu * m * qi).sum(-1)
    else:
        pred = (pu * qi).sum(-1)
    coeff = w * (r - pred)
    vmask = (w > 0).to(torch.float32)
    gu = -2.0 * coeff[..., None] * qi + 2.0 * u_reg * vmask[..., None] * pu
    gi = -2.0 * coeff[..., None] * pu + 2.0 * i_reg * vmask[..., None] * qi
    if use_mask:
        gu = gu * m
        gi = gi * m
    if collision_norm:
        gu = gu / cnu[..., None]
        gi = gi / cni[..., None]
    tu, ti = -lr * gu, -lr * gi
    if mm_bf16:
        tu, ti = _bf16(tu), _bf16(ti)
    dU = torch.zeros((L * bu, k), dtype=torch.float32, device=U.device)
    dI = torch.zeros((L * bi, k), dtype=torch.float32, device=U.device)
    dU.index_add_(0, (lane * bu + u).reshape(-1), tu.reshape(-1, k))
    dI.index_add_(0, (lane * bi + i).reshape(-1), ti.reshape(-1, k))
    return U + dU.view(L, bu, k), I + dI.view(L, bi, k)


def _host(x) -> np.ndarray:
    """A schedule array (tensor on any device, or array-like) on the host."""
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      np.int64)


def _slice(rows, starts, bs):
    idx = starts[:, None] + torch.arange(bs, device=starts.device)
    return [None if x is None else torch.gather(x, 1, idx) for x in rows]


def block_sweep_rows(u_tab, i_tab, row_of, ib_seq, boff, lr, u_loc, i_loc,
                     vals, wts, cnu, cni, lam, bs: int, bu: int, bi: int,
                     NI: int, u_reg: float, i_reg: float,
                     collision_norm: bool, use_mask: bool,
                     mm_bf16: bool = True):
    """Row-schedule epoch, plain PyTorch (JAX ``block_sweep_rows``):
    u_tab [NU*bu, k], i_tab [NI*bi, k]; streams [NU, NI*S]; row_of [NU],
    ib_seq / boff [NU, NI]. User-block rows in ``row_of`` order, each
    sweeping its cells in ``ib_seq`` order, every cell's minibatches from
    its batch offset. Updates the tables in place."""
    NU, row_len = u_loc.shape
    S = row_len // NI
    n_steps = S // bs
    streams = [x.view(NU * NI, S) if x is not None else None
               for x in (u_loc, i_loc, vals, wts, cnu, cni, lam)]
    row_of, ib_seq, boff = (_host(x) for x in (row_of, ib_seq, boff))
    for t in range(NU):
        ro = int(row_of[t])
        U = u_tab[ro * bu:(ro + 1) * bu][None]
        for j in range(NI):
            ib = int(ib_seq[t, j])
            I = i_tab[ib * bi:(ib + 1) * bi][None]
            cell = ro * NI + ib
            for s in range(n_steps):
                a = ((s + int(boff[t, j])) % n_steps) * bs
                U, I = batch_update(
                    U, I, *(None if x is None else x[cell:cell + 1, a:a + bs]
                            for x in streams),
                    lr, u_reg, i_reg, collision_norm, use_mask, mm_bf16)
            i_tab[ib * bi:(ib + 1) * bi] = I[0]
        u_tab[ro * bu:(ro + 1) * bu] = U[0]
    return u_tab, i_tab


def block_sweep_diag(u_tab, i_tab, ub_idx, ib_idx, boff, lr, u_loc, i_loc,
                     vals, wts, cnu, cni, lam, bs: int, bu: int, bi: int,
                     NI: int, u_reg: float, i_reg: float,
                     collision_norm: bool, use_mask: bool,
                     mm_bf16: bool = True):
    """Diag-schedule epoch, plain PyTorch (JAX ``block_sweep_diag``):
    u_tab [NU*bu, k], i_tab [NI*bi, k]; streams [n_cells + 1, S];
    ub_idx / ib_idx / boff [R, G]. Each round runs its lanes, disjoint in
    both axes, as one batch dimension; lanes whose user block is the dummy
    NU are skipped. Updates the tables in place."""
    k = u_tab.shape[1]
    NU = u_tab.shape[0] // bu
    S = u_loc.shape[1]
    n_steps = S // bs
    dev = u_tab.device
    u3 = u_tab.view(NU, bu, k)
    i3 = i_tab.view(-1, bi, k)
    streams = (u_loc, i_loc, vals, wts, cnu, cni, lam)
    ub_idx, ib_idx, boff = (torch.from_numpy(_host(x))
                            for x in (ub_idx, ib_idx, boff))
    for t in range(ub_idx.shape[0]):
        valid = ub_idx[t] < NU
        ub, ib = ub_idx[t][valid].to(dev), ib_idx[t][valid].to(dev)
        if not len(ub):
            continue
        bo = boff[t][valid].to(dev)
        rows = [None if x is None else x[ub * NI + ib] for x in streams]
        U, I = u3[ub], i3[ib]
        for s in range(n_steps):
            su, si, sv, sw, scu, sci, sl = _slice(
                rows, ((s + bo) % n_steps) * bs, bs)
            U, I = batch_update(U, I, su, si, sv, sw, scu, sci, sl, lr,
                                u_reg, i_reg, collision_norm, use_mask,
                                mm_bf16)
        u3[ub] = U
        i3[ib] = I
    return u_tab, i_tab


def diag_schedule(gen: torch.Generator, NU: int, G: int, n_steps: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch of DSGD rounds (JAX ``device_diag_schedule``, drawn from
    a CPU ``torch.Generator``): random groups of G user blocks, padded
    with the dummy block NU; each group's G rotations in a random order,
    the rotation on the user side, so lane l keeps item block l; a random
    batch offset per (round, lane). Returns int64 (ub_idx, ib_idx, boff),
    each [R, G] with R = ceil(NU / G) * G."""
    n_groups = -(-NU // G)
    total = n_groups * G
    ub_all = torch.cat([torch.arange(NU),
                        torch.full((total - NU,), NU, dtype=torch.int64)])
    ub_all = ub_all[torch.randperm(total, generator=gen)].view(n_groups, G)
    dperm = torch.stack([torch.randperm(G, generator=gen)
                         for _ in range(n_groups)])
    lanes = torch.arange(G)
    ub_rep = ub_all.repeat_interleave(G, dim=0)           # [R, G]
    src = (lanes[None, :] - dperm.reshape(-1, 1)) % G     # [R, G]
    ub_idx = torch.gather(ub_rep, 1, src)
    ib_idx = lanes.expand_as(ub_idx).clone()
    boff = torch.randint(0, max(n_steps, 1), (total, G), generator=gen)
    return ub_idx, ib_idx, boff


# ----------------------------------------------------------------------
# staging shared by the kernel wrappers
# ----------------------------------------------------------------------

def _check_ids(u_loc: torch.Tensor, i_loc: torch.Tensor, bu: int,
               bi: int) -> None:
    """The stream ids in range (a sync each)."""
    for name, x, hi in (("u_loc", u_loc, bu), ("i_loc", i_loc, bi)):
        lo_v, hi_v = (int(v) for v in torch.aminmax(x))
        if lo_v < 0 or hi_v >= hi:
            raise ValueError(f"{name} outside [0, {hi})")


def slice_tables(streams, bs: int, bu: int, bi: int, collision_norm: bool,
                 use_mask: bool, range_size: int) -> dict:
    """The kernel's view of streams [rows, S]: each static batch slice of bs
    slots (slice = stream row * S / bs + batch) with its valid (w != 0)
    slots sorted by row, once per side (stable, so a row keeps its slots'
    stream order). The kernel's lane groups take ``range_size`` sorted
    slots each (the plan's range, 4 or 8); a SEGMENT is a run of one row
    within such a range, and a row's sum is the sum of its segments' sums,
    in order:

    * ``meta_u`` / ``meta_i`` [slices, bs, 4] int32 per sorted slot: the
      other side's row (| lam << 16 under use_mask), then the f32 bits of
      r, w and the side's collision count (1.0 without collision_norm);
    * ``own_u`` / ``own_i`` [slices, bs] int16: the slots' own rows;
    * ``seg_u`` / ``seg_i`` [slices, bs] int16: the slots' segments,
      numbered per side;
    * ``ent_u`` / ``ent_i`` [slices, bs] int32, the touched rows first:
      (the row's first segment << 16) | row;
    * ``cnt`` [slices, 8] int32: (user rows, item rows, valid slots, user
      segments, item segments, 0, 0, 0). A slice without valid slots is a
      step the kernel skips.

    Made on the streams' device with tensor ops."""
    u_loc, i_loc, vals, wts, cnu, cni, lam = streams
    rows, S = u_loc.shape
    n_sl = rows * (S // bs)
    dev = u_loc.device
    flat = lambda x: x.reshape(n_sl, bs)
    bits = lambda x: flat(x).view(torch.int32)
    valid = flat(wts) != 0
    j = torch.arange(bs, dtype=torch.int32, device=dev)
    one = int(torch.ones((), dtype=torch.float32).view(torch.int32))

    def side(loc, other, cn, n_rows):
        key = torch.where(valid, flat(loc), n_rows)
        skey, order = torch.sort(key, dim=1, stable=True)
        take = lambda x: x.gather(1, order)
        x0 = take(flat(other))
        if use_mask:
            x0 = x0 | take(flat(lam) << 16)
        cn_bits = take(bits(cn)) if collision_norm else \
            torch.full_like(x0, one)
        meta = torch.stack([x0, take(bits(vals)), take(bits(wts)), cn_bits],
                           -1).contiguous()
        ok = skey < n_rows
        newrow = ok.clone()
        newrow[:, 1:] &= skey[:, 1:] != skey[:, :-1]
        newseg = newrow | (ok & (j % range_size == 0))
        seg = (newseg.cumsum(1) - 1).to(torch.int32)
        ent = (seg << 16) | torch.where(ok, skey, 0)
        first = torch.sort((~newrow).to(torch.uint8), dim=1,
                           stable=True).indices
        return (meta, torch.where(ok, skey, 0).to(torch.int16).contiguous(),
                seg.clamp(min=0).to(torch.int16).contiguous(),
                ent.gather(1, first).contiguous(), newrow.sum(1),
                newseg.sum(1))

    meta_u, own_u, seg_u, ent_u, rows_u, segs_u = side(u_loc, i_loc, cnu, bu)
    meta_i, own_i, seg_i, ent_i, rows_i, segs_i = side(i_loc, u_loc, cni, bi)
    z = torch.zeros_like(rows_u)
    cnt = torch.stack([rows_u, rows_i, valid.sum(1), segs_u, segs_i, z, z, z],
                      -1).to(torch.int32).contiguous()
    return dict(meta_u=meta_u, meta_i=meta_i, own_u=own_u, own_i=own_i,
                seg_u=seg_u, seg_i=seg_i, ent_u=ent_u, ent_i=ent_i, cnt=cnt)


def _spec(streams, bs, bu, bi, collision_norm, use_mask) -> tuple:
    """What staged slices were made from: the streams' storage and size,
    the blocks and the options."""
    return (tuple(x.data_ptr() for x in streams if x is not None),
            streams[0].numel(), bs, bu, bi, bool(collision_norm),
            bool(use_mask))


def stage_slices(streams, bs: int, bu: int, bi: int, collision_norm: bool,
                 use_mask: bool, range_size: int) -> dict:
    """The streams staged for the kernel, once: their ids checked in range
    (raises ValueError), then their ``slice_tables`` for launches whose
    plan takes ranges of ``range_size`` (``plan(...)["range"]``). Pass the
    result to the wrappers as ``slices=``; they then check and stage
    nothing per call. The streams must not change while it is in use."""
    _check_ids(streams[0], streams[1], bu, bi)
    return dict(slice_tables(streams, bs, bu, bi, collision_norm, use_mask,
                             range_size), range=range_size,
                spec=_spec(streams, bs, bu, bi, collision_norm, use_mask))


def _check(u_tab, i_tab, streams, bs, bu, bi, use_mask, collision_norm,
           slices=None):
    """Shapes, types, devices and contiguity (no sync); then the stream ids
    in range, or, where ``slices`` were staged, that they were staged from
    these streams and options (no sync)."""
    u_loc, i_loc, vals, wts, cnu, cni, lam = streams
    if u_tab.dim() != 2 or i_tab.dim() != 2 or u_tab.shape[1] != \
            i_tab.shape[1]:
        raise ValueError("want u_tab [NU*bu, k], i_tab [NI*bi, k]")
    if u_tab.shape[0] % bu or i_tab.shape[0] % bi:
        raise ValueError("table rows must be whole blocks of bu / bi")
    if u_tab.dtype != torch.float32 or i_tab.dtype != torch.float32:
        raise ValueError("factor tables must be float32")
    need = [("u_loc", u_loc, torch.int32), ("i_loc", i_loc, torch.int32),
            ("vals", vals, torch.float32), ("wts", wts, torch.float32)]
    if collision_norm:
        need += [("cnu", cnu, torch.float32), ("cni", cni, torch.float32)]
    if use_mask:
        need += [("lam", lam, torch.int32)]
    for name, x, dt in need:
        if x is None or x.dtype != dt or x.shape != u_loc.shape:
            raise ValueError(f"{name} must be {dt} of u_loc's shape")
    tensors = [u_tab, i_tab] + [x for _, x, _ in need]
    if any(t.device != u_tab.device for t in tensors):
        raise ValueError("tables and streams must share a device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("tables and streams must be contiguous")
    if u_loc.shape[-1] % bs:
        raise ValueError("stream rows must be whole batches of bs")
    if slices is None:
        _check_ids(u_loc, i_loc, bu, bi)
    elif slices["spec"] != _spec(streams, bs, bu, bi, collision_norm,
                                 use_mask):
        raise ValueError("slices were staged from other streams, blocks or "
                         "options")


def row_lanes(row_of, ib_seq, boff, NU: int, NI: int, n_steps: int
              ) -> np.ndarray:
    """The row schedule's epoch table [NU * NI, 1, 4] int32 (user block,
    item block, stream row, batch offset): one round per cell, user rows in
    ``row_of`` order, each sweeping its cells in ``ib_seq`` order; raises
    on a schedule that is not one."""
    row_of, ib_seq, boff = (_host(x) for x in (row_of, ib_seq, boff))
    if row_of.shape != (NU,) or ib_seq.shape != (NU, NI) or \
            not np.array_equal(np.sort(row_of), np.arange(NU)) or \
            not (np.sort(ib_seq, 1) == np.arange(NI)).all():
        raise ValueError("row_of must permute the NU rows and each ib_seq "
                         "row the NI item blocks")
    if boff.shape != (NU, NI) or boff.min() < 0 or \
            boff.max() >= max(n_steps, 1):
        raise ValueError("boff outside [0, S // bs)")
    ro = np.repeat(row_of[:, None], NI, 1)
    lanes = np.stack([ro, ib_seq, ro * NI + ib_seq, boff], -1)
    return lanes.reshape(NU * NI, 1, 4).astype(np.int32)


def epoch_lanes(ub_idx, ib_idx, boff, NU: int, NI: int, n_steps: int
                ) -> np.ndarray:
    """The diag schedule's epoch table [R, G, 4] int32 (user block or -1
    for a dummy lane, item block, stream row, batch offset), lanes in
    place; raises on a schedule whose real lanes of a round share a
    block."""
    ub, ib, bo = (_host(x) for x in (ub_idx, ib_idx, boff))
    valid = ub < NU
    if (ub < 0).any() or (ib < 0).any() or (ib >= NI).any() or \
            (bo < 0).any() or (bo >= max(n_steps, 1)).any():
        raise ValueError("schedule entries outside their ranges")
    # the real lanes of a round are distinct in both axes (dummy lanes
    # take distinct negative keys)
    other = -1 - np.arange(ub.shape[1])
    bad = np.zeros(ub.shape[0], bool)
    for x in (ub, ib):
        key = np.sort(np.where(valid, x, other), 1)
        bad |= (key[:, 1:] == key[:, :-1]).any(1)
    if bad.any():
        raise ValueError(f"round {int(np.argmax(bad))} has lanes that "
                         "share a block")
    lanes = np.stack([np.where(valid, ub, -1), ib,
                      np.where(valid, ub * NI + ib, 0), bo], -1)
    return lanes.astype(np.int32)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------

_PLANS: dict = {}
_BUFS: dict = {}


def plan_at(lib, n_par: int, bs: int, bu: int, bi: int, k: int,
            cluster: int) -> dict:
    """``block_sgd_plan`` on the current CUDA device at cluster size
    ``cluster`` (0: the kernel's choice), as a dict; raises where the card
    cannot host it."""
    out = (ctypes.c_int * 6)()
    err = lib.block_sgd_plan(n_par, bs, bu, bi, k, cluster, out)
    if err:
        raise RuntimeError(
            f"block_sgd_plan failed: "
            f"{lib.block_sgd_error_string(err).decode()} (cudaError "
            f"{err}; {n_par} lanes, bs={bs}, bu={bu}, bi={bi}, k={k}, "
            f"cluster {cluster})")
    return dict(route=ROUTES[out[0]], cluster=out[1], clusters=out[2],
                smem=out[3], resident=out[4], range=out[5])


def plan(n_par: int, bs: int, bu: int, bi: int, k: int) -> dict:
    """The kernel's launch plan on the current CUDA device for n_par
    parallel lanes of bs-slot steps: route ("cluster": a step's segment
    sums in the cluster's shared memory, "scratch": in a global scratch),
    cluster size C, clusters launched (each takes every Q-th lane of a
    round), shared bytes per CTA and co-resident clusters, and the range
    (sorted slots a lane group takes: 8, or 4 where ranges of 8 would leave
    lane groups idle)."""
    key = (torch.cuda.current_device(), n_par, bs, bu, bi, k)
    if key not in _PLANS:
        _PLANS[key] = plan_at(library(), n_par, bs, bu, bi, k, 0)
    return _PLANS[key]


def _buf(device, name: str, n: int, dtype, stream=None) -> torch.Tensor:
    """A persistent zeroed device buffer of at least n values, one per
    (device, name, stream), replaced by a larger one when a launch needs
    more: the round barrier, which the kernel leaves reusable (one per
    stream, so launches on two streams never share it); the scratch, which
    it writes before it reads; the one-lane table."""
    key = (device, name, stream)
    if key not in _BUFS or _BUFS[key].numel() < n:
        _BUFS[key] = torch.zeros(n, dtype=dtype, device=device)
    return _BUFS[key]


def _counter(fn, device) -> torch.Tensor:
    if fn.cells is None or fn.cells.device != device:
        fn.cells = torch.zeros(1, dtype=torch.int64, device=device)
    return fn.cells


def cells_done(fn) -> int:
    """(lane, cell) pairs the kernel finished under wrapper ``fn`` since
    its counts were reset (reads the device counter: a sync)."""
    return 0 if fn.cells is None else int(fn.cells.item())


def reset_counts(*fns) -> None:
    """Zero the ``launches`` and ``cells`` counts of the given wrappers."""
    for fn in fns:
        fn.launches = 0
        if fn.cells is not None:
            fn.cells.zero_()


def launch(fn, u_tab, i_tab, streams, lanes, bs: int, bu: int, bi: int,
           lr, u_reg, i_reg, collision_norm: bool, use_mask: bool,
           mm_bf16: bool, slices: Optional[dict] = None) -> None:
    """One launch of the kernel over ``lanes`` ([R, P, 4] int32, numpy or
    on the device) on streams [rows, S], counted on wrapper ``fn``; reads
    ``slices`` (``stage_slices``) where given, else the streams'
    ``slice_tables`` made here. A grid whose clusters cannot all be
    resident at once raises."""
    if max(bu, bi) > MAX_ROWS or bs > MAX_BATCH:
        raise ValueError(f"the CUDA kernel takes blocks of at most "
                         f"{MAX_ROWS} rows and batches of at most "
                         f"{MAX_BATCH} slots")
    lib = library()
    dev = u_tab.device
    k = u_tab.shape[1]
    R, P = lanes.shape[:2]
    with torch.cuda.device(dev):
        pl = plan(P, bs, bu, bi, k)
        C, Q = pl["cluster"], pl["clusters"]
        if slices is None:
            slices = slice_tables(streams, bs, bu, bi, collision_norm,
                                  use_mask, pl["range"])
        elif slices["range"] != pl["range"]:
            raise ValueError(f"slices staged for ranges of "
                             f"{slices['range']}; this launch's plan takes "
                             f"{pl['range']}")
        if not torch.is_tensor(lanes):
            lanes = torch.from_numpy(np.ascontiguousarray(
                lanes, np.int32)).pin_memory().to(dev, non_blocking=True)
        stream = torch.cuda.current_stream().cuda_stream
        n = lib.block_sgd_scratch_floats(Q, C, bs, bu, bi, k, pl["range"])
        scratch = _buf(dev, "scratch", n, torch.float32, stream) if n \
            else None
        err = lib.block_sgd_run(
            int(mm_bf16), int(collision_norm), int(use_mask),
            u_tab.data_ptr(), i_tab.data_ptr(),
            *(slices[x].data_ptr() for x in _TABLES), lanes.data_ptr(), R,
            P, streams[0].shape[1] // bs, bs, bu, bi, k, -float(lr),
            2.0 * float(u_reg), 2.0 * float(i_reg), C, Q, pl["range"],
            None if scratch is None else scratch.data_ptr(),
            _buf(dev, "bar", 2, torch.int32, stream).data_ptr(),
            _counter(fn, dev).data_ptr(), stream)
    if err != 0:
        msg = lib.block_sgd_error_string(err).decode()
        why = (f"the {Q} clusters of {C} CTAs cannot all be resident at "
               f"once ({pl['resident']} can)"
               if err == _NOT_CO_RESIDENT else msg)
        raise RuntimeError(
            f"block_sgd kernel launch failed: {why} (cudaError {err}; "
            f"{R} rounds x {P} lanes, bs={bs}, bu={bu}, bi={bi}, k={k}, "
            f"{pl['route']} route, {pl['smem']} B shared memory per CTA)")
    fn.launches += 1


def _route(u_tab):
    if u_tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for device {u_tab.device}")
    return u_tab.device.type


def block_sgd_epoch(u_tab, i_tab, row_of, ib_seq, boff, lr, u_loc, i_loc,
                    vals, wts, cnu, cni, lam, bs: int, bu: int, bi: int,
                    NI: int, u_reg: float, i_reg: float,
                    collision_norm: bool, use_mask: bool,
                    mm_bf16: bool = True, slices: Optional[dict] = None):
    """Row-schedule epoch (the Pallas ``block_sgd_epoch``): u_tab
    [NU*bu, k], i_tab [NI*bi, k] f32; streams [NU, NI*S]; row_of [NU],
    ib_seq / boff [NU, NI]. On the card: one launch, one cluster walking
    the NU * NI cells in order (``row_lanes``), on ``slices`` where the
    streams were staged (``stage_slices``; the CPU route ignores them)."""
    streams = (u_loc, i_loc, vals, wts, cnu, cni, lam)
    _check(u_tab, i_tab, streams, bs, bu, bi, use_mask, collision_norm,
           slices)
    NU, row_len = u_loc.shape
    if _route(u_tab) == "cpu":
        return block_sweep_rows(u_tab, i_tab, row_of, ib_seq, boff, lr,
                                *streams, bs, bu, bi, NI, u_reg, i_reg,
                                collision_norm, use_mask, mm_bf16)
    S = row_len // NI
    lanes = row_lanes(row_of, ib_seq, boff, NU, NI, S // bs)
    flat = tuple(x.view(NU * NI, S) if x is not None else None
                 for x in streams)
    launch(block_sgd_epoch, u_tab, i_tab, flat, lanes, bs, bu, bi, lr, u_reg,
           i_reg, collision_norm, use_mask, mm_bf16, slices)
    return u_tab, i_tab


block_sgd_epoch.launches = 0
block_sgd_epoch.cells = None


def block_sgd_diag_epoch(u_tab, i_tab, ub_idx, ib_idx, boff, lr, u_loc,
                         i_loc, vals, wts, cnu, cni, lam, bs: int, bu: int,
                         bi: int, NI: int, u_reg: float, i_reg: float,
                         collision_norm: bool, use_mask: bool,
                         mm_bf16: bool = True,
                         slices: Optional[dict] = None):
    """Diag-schedule epoch (the DSGD rounds of ``block_sweep_diag``):
    u_tab [NU*bu, k], i_tab [NI*bi, k] f32; streams [n_cells + 1, S];
    ub_idx / ib_idx / boff [R, G]. On the card: one launch over the rounds
    (``epoch_lanes``), one cluster per lane and a grid barrier between
    rounds, on ``slices`` as in ``block_sgd_epoch``."""
    streams = (u_loc, i_loc, vals, wts, cnu, cni, lam)
    _check(u_tab, i_tab, streams, bs, bu, bi, use_mask, collision_norm,
           slices)
    if _route(u_tab) == "cpu":
        return block_sweep_diag(u_tab, i_tab, ub_idx, ib_idx, boff, lr,
                                *streams, bs, bu, bi, NI, u_reg, i_reg,
                                collision_norm, use_mask, mm_bf16)
    NU = u_tab.shape[0] // bu
    S = u_loc.shape[1]
    if u_loc.shape[0] < NU * NI:
        raise ValueError(f"want at least {NU * NI} stream rows")
    lanes = epoch_lanes(ub_idx, ib_idx, boff, NU, NI, S // bs)
    launch(block_sgd_diag_epoch, u_tab, i_tab, streams, lanes, bs, bu, bi,
           lr, u_reg, i_reg, collision_norm, use_mask, mm_bf16, slices)
    return u_tab, i_tab


block_sgd_diag_epoch.launches = 0
block_sgd_diag_epoch.cells = None
