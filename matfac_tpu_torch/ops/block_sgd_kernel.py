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
kernel or raises. Each carries a ``launches`` count: one per user-block row
and one per diag round. Both update ``u_tab`` and ``i_tab`` IN PLACE and
return them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from matfac_tpu_torch.ops import _build

_SIGNATURES = {
    "block_sgd_run": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # mm_bf16, cn, mask
        ctypes.c_void_p, ctypes.c_void_p,                   # u_tab, i_tab
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # u_loc, i_loc, vals
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # wts, cnu, cni
        ctypes.c_void_p, ctypes.c_void_p,                   # lam, lanes
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # n_ctas, cells, S
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # bs, bu, bi
        ctypes.c_int,                                       # k
        ctypes.c_float, ctypes.c_float, ctypes.c_float,     # -lr, 2 u_reg, 2 i_reg
        ctypes.c_void_p, ctypes.c_void_p]),                 # scratch, stream
    "block_sgd_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 3),
    "block_sgd_scratch_floats": (ctypes.c_size_t, [ctypes.c_int] * 4),
    "block_sgd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


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
# kernel wrappers
# ----------------------------------------------------------------------

def _check(u_tab, i_tab, streams, bs, bu, bi, use_mask, collision_norm):
    """Shapes, types, devices and contiguity; the stream ids in range."""
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
    for name, x, hi in (("u_loc", u_loc, bu), ("i_loc", i_loc, bi)):
        lo_v, hi_v = (int(v) for v in torch.aminmax(x))
        if lo_v < 0 or hi_v >= hi:
            raise ValueError(f"{name} outside [0, {hi})")


def _launch(lib, u_tab, i_tab, streams, lanes_ptr: int, n_ctas: int,
            cells_per_cta: int, S: int, bs: int, bu: int, bi: int, lr,
            u_reg, i_reg, collision_norm, use_mask, mm_bf16, scratch,
            stream) -> None:
    ptr = lambda x: None if x is None else x.data_ptr()
    u_loc, i_loc, vals, wts, cnu, cni, lam = streams
    err = lib.block_sgd_run(
        int(mm_bf16), int(collision_norm), int(use_mask), u_tab.data_ptr(),
        i_tab.data_ptr(), ptr(u_loc), ptr(i_loc), ptr(vals), ptr(wts),
        ptr(cnu) if collision_norm else None,
        ptr(cni) if collision_norm else None,
        ptr(lam) if use_mask else None, lanes_ptr, n_ctas, cells_per_cta, S,
        bs, bu, bi, u_tab.shape[1], -float(lr), 2.0 * float(u_reg),
        2.0 * float(i_reg), ptr(scratch), stream)
    if err != 0:
        msg = lib.block_sgd_error_string(err).decode()
        raise RuntimeError(
            f"block_sgd kernel launch failed: {msg} (cudaError {err}; "
            f"{n_ctas} CTAs, bu={bu}, bi={bi}, k={u_tab.shape[1]}, "
            f"{'global scratch' if scratch is not None else 'shared'} "
            f"deltas, {lib.block_sgd_smem_bytes(bu, bi, u_tab.shape[1])} B "
            "for the shared route)")


def _scratch(lib, n_ctas, bu, bi, k, device):
    n = lib.block_sgd_scratch_floats(n_ctas, bu, bi, k)
    return (torch.zeros(n, dtype=torch.float32, device=device)
            if n else None)


def run_lanes(u_tab, i_tab, streams, lanes: np.ndarray, counts, S: int,
              bs: int, bu: int, bi: int, lr, u_reg, i_reg,
              collision_norm: bool, use_mask: bool, mm_bf16: bool,
              cells_per_cta: int = 1) -> int:
    """Launch the kernel once per group of ``lanes`` [n_launch, width, 4]
    (int32: user block, item block, stream row, batch offset): launch t
    runs ``counts[t]`` CTAs of ``cells_per_cta`` lanes each. Returns the
    number of launches made."""
    lib = library()
    width = lanes.shape[1]
    lanes_dev = torch.from_numpy(np.ascontiguousarray(
        lanes, dtype=np.int32)).to(u_tab.device)
    k = u_tab.shape[1]
    scratch = _scratch(lib, max(int(max(counts, default=0)), 1), bu, bi, k,
                       u_tab.device)
    base = lanes_dev.data_ptr()
    n = 0
    with torch.cuda.device(u_tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        for t, c in enumerate(counts):
            if not c:
                continue
            _launch(lib, u_tab, i_tab, streams, base + t * width * 16,
                    int(c), cells_per_cta, S, bs, bu, bi, lr, u_reg, i_reg,
                    collision_norm, use_mask, mm_bf16, scratch, stream)
            n += 1
    return n


def _route(u_tab):
    if u_tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for device {u_tab.device}")
    return u_tab.device.type


def block_sgd_epoch(u_tab, i_tab, row_of, ib_seq, boff, lr, u_loc, i_loc,
                    vals, wts, cnu, cni, lam, bs: int, bu: int, bi: int,
                    NI: int, u_reg: float, i_reg: float,
                    collision_norm: bool, use_mask: bool,
                    mm_bf16: bool = True):
    """Row-schedule epoch (the Pallas ``block_sgd_epoch``): u_tab
    [NU*bu, k], i_tab [NI*bi, k] f32; streams [NU, NI*S]; row_of [NU],
    ib_seq / boff [NU, NI]. On the card: one launch per user-block row,
    one CTA walking the row's NI cells in ``ib_seq`` order."""
    streams = (u_loc, i_loc, vals, wts, cnu, cni, lam)
    _check(u_tab, i_tab, streams, bs, bu, bi, use_mask, collision_norm)
    NU, row_len = u_loc.shape
    if _route(u_tab) == "cpu":
        return block_sweep_rows(u_tab, i_tab, row_of, ib_seq, boff, lr,
                                *streams, bs, bu, bi, NI, u_reg, i_reg,
                                collision_norm, use_mask, mm_bf16)
    row_of, ib_seq, boff = (_host(x) for x in (row_of, ib_seq, boff))
    S = row_len // NI
    if sorted(row_of.tolist()) != list(range(NU)) or ib_seq.shape != \
            (NU, NI) or any(sorted(r) != list(range(NI))
                            for r in ib_seq.tolist()):
        raise ValueError("row_of must permute the NU rows and each ib_seq "
                         "row the NI item blocks")
    if boff.min() < 0 or boff.max() >= max(S // bs, 1):
        raise ValueError("boff outside [0, S // bs)")
    ro = row_of[:, None].repeat(NI, 1)
    lanes = np.stack([ro, ib_seq, ro * NI + ib_seq, boff], -1)
    flat = [x.view(NU * NI, S) if x is not None else None for x in streams]
    block_sgd_epoch.launches += run_lanes(
        u_tab, i_tab, flat, lanes, [1] * NU, S, bs, bu, bi, lr, u_reg,
        i_reg, collision_norm, use_mask, mm_bf16, cells_per_cta=NI)
    return u_tab, i_tab


block_sgd_epoch.launches = 0


def diag_lanes(ub_idx, ib_idx, boff, NU: int, NI: int, n_steps: int):
    """(lanes [R, G, 4] int32 with each round's real lanes first, real
    lanes per round [R]) of a diag schedule; raises on a schedule whose
    real lanes of a round share a block."""
    ub, ib, bo = (_host(x) for x in (ub_idx, ib_idx, boff))
    valid = ub < NU
    if (ub < 0).any() or (ib < 0).any() or (ib >= NI).any() or \
            (bo < 0).any() or (bo >= max(n_steps, 1)).any():
        raise ValueError("schedule entries outside their ranges")
    for t in range(ub.shape[0]):
        v = valid[t]
        if len(set(ub[t][v].tolist())) < v.sum() or \
                len(set(ib[t][v].tolist())) < v.sum():
            raise ValueError(f"round {t} has lanes that share a block")
    lanes = np.stack([ub, ib, ub * NI + ib, bo], -1)
    order = np.argsort(~valid, axis=1, kind="stable")
    lanes = np.take_along_axis(lanes, order[..., None], 1)
    return lanes.astype(np.int32), valid.sum(1)


def block_sgd_diag_epoch(u_tab, i_tab, ub_idx, ib_idx, boff, lr, u_loc,
                         i_loc, vals, wts, cnu, cni, lam, bs: int, bu: int,
                         bi: int, NI: int, u_reg: float, i_reg: float,
                         collision_norm: bool, use_mask: bool,
                         mm_bf16: bool = True):
    """Diag-schedule epoch (the DSGD rounds of ``block_sweep_diag``):
    u_tab [NU*bu, k], i_tab [NI*bi, k] f32; streams [n_cells + 1, S];
    ub_idx / ib_idx / boff [R, G]. On the card: one launch per round, one
    CTA per real lane."""
    streams = (u_loc, i_loc, vals, wts, cnu, cni, lam)
    _check(u_tab, i_tab, streams, bs, bu, bi, use_mask, collision_norm)
    if _route(u_tab) == "cpu":
        return block_sweep_diag(u_tab, i_tab, ub_idx, ib_idx, boff, lr,
                                *streams, bs, bu, bi, NI, u_reg, i_reg,
                                collision_norm, use_mask, mm_bf16)
    NU = u_tab.shape[0] // bu
    S = u_loc.shape[1]
    if u_loc.shape[0] < NU * NI:
        raise ValueError(f"want at least {NU * NI} stream rows")
    lanes, counts = diag_lanes(ub_idx, ib_idx, boff, NU, NI, S // bs)
    block_sgd_diag_epoch.launches += run_lanes(
        u_tab, i_tab, streams, lanes, counts.tolist(), S, bs, bu, bi, lr,
        u_reg, i_reg, collision_norm, use_mask, mm_bf16)
    return u_tab, i_tab


block_sgd_diag_epoch.launches = 0
