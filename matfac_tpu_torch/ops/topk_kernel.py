"""Full-catalog top-N for a set of queried users: the hand-written CUDA
kernel's wrapper and its plain PyTorch version.

Port of matfac_tpu/ops/topk_kernel.py. Its Pallas TPU kernel ``topk_tiles``
becomes ``csrc/topk.cu`` (design and cost notes there). The port returns
what the JAX package's default XLA scorer returns (eval/ranking.py:82-102),
because serving hands the scores to users:

  * score = ((u . i + mu) + u_bias) + i_bias, in that order (``topk_tiles``
    drops mu and u_bias as ranking-invariant);
  * invalid items and the items of the user's train row score -3e38;
  * the n best, descending, equal scores going to the smallest item id;
  * slots with no scorable item carry id -1 and score -3e38.

Not carried over: the per-tile rated lists ``[n_tiles, BU, c_max]`` (the
kernel reads the train CSR rows), the padded item table and the fixed
user blocks (any set of user ids is scored).

``topk_catalog`` takes the tensors' device as the route: a CPU tensor runs
``topk_plain``; a CUDA tensor launches the kernel or raises. On the card,
n <= ``FUSED_MAX_N`` takes the fused score-and-select kernel, which writes
no score to device memory: one launch a pass, or two where the catalog is
split into slices to fill the card (``fused_plan``); larger n takes the
radix route, ``KERNELS_PER_CHUNK`` launches per chunk of
``chunk_users(n_items)`` users (``radix_plan``): the fused route's sweep
writes each score once to a [chunk, n_items] scratch, and a select kernel
reads each user's row once (into shared memory up to
``library().topk_radix_resident_items(n)`` items) and picks the n best by
radix passes that start at the row's highest differing key bit.
``topk_catalog.launches`` counts the launches; ``pass_launches`` says how
many one call makes. ``radix_scores`` runs the score stage alone (its own
``.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.train.profiler import count, span

NEG_INF = float(np.float32(-3.0e38))   # the f32 value, exactly
KERNELS_PER_CHUNK = 2   # radix route: score kernel + select kernel
# f32 scores one chunk may hold (1 GiB): bounds the radix route's scratch
# and the plain version's score and sort temporaries
SCRATCH_FLOATS = 1 << 28
_MAX_CHUNK = 1 << 20    # users a chunk, whatever the catalog
# the fused route (csrc/topk.cu): n up to FUSED_MAX_N (kFusedMaxN there:
# each user's candidate buffer lives in shared memory), tiles of FUSED_TILE_USERS users x
# FUSED_TILE_ITEMS items, at most FUSED_MAX_SPLITS catalog slices and
# FUSED_MAX_MERGE keys a user to merge
FUSED_MAX_N = 128
FUSED_TILE_USERS, FUSED_TILE_ITEMS = 64, 256
FUSED_MAX_SPLITS, FUSED_MAX_MERGE = 32, 4096

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "topk_catalog_chunk": (_I, [_P] * 12 + [_I] * 4 + [_P]),  # B, I, k, n
    "topk_radix_scores": (_I, [_P] * 10 + [_I] * 3 + [_P]),   # B, I, k
    "topk_radix_resident_items": (_I, [_I]),
    "topk_radix_select_per_sm": (_I, [_I, _I]),
    "topk_fused": (_I, [_P] * 12 + [_I] * 6 + [_P]),  # B, I, k, n, cap, S
    "topk_max_n": (_I, []),
    "topk_fused_resident": (_I, [_I]),
    "topk_error_string": (ctypes.c_char_p, [_I]),
}


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc on first use)."""
    return _build.load("topk", _SIGNATURES)


def chunk_users(n_items: int) -> int:
    """Users scored per chunk (one kernel pair, one scratch) at this
    catalog width: the radix route and the plain version."""
    return max(1, min(_MAX_CHUNK, SCRATCH_FLOATS // max(n_items, 1)))


def fused_capacity(n: int) -> int:
    """Candidate keys the fused kernel keeps a user: a power of 2 with room
    for n and one more round of 32, at least 64."""
    return max(64, 1 << (n + 31).bit_length())


def fused_splits(B: int, n_items: int, n: int, resident: int) -> int:
    """Catalog slices of the fused route: as many as the ``resident`` CTAs
    the card holds at once can run beside the B / 64 user tiles in one
    wave (1 when the user tiles alone fill it), at most one per 256-item
    tile, FUSED_MAX_SPLITS, and FUSED_MAX_MERGE / n (the merge's keys a
    user)."""
    user_tiles = -(-B // FUSED_TILE_USERS)
    n_tiles = -(-n_items // FUSED_TILE_ITEMS)
    return max(1, min(resident // user_tiles, n_tiles, FUSED_MAX_SPLITS,
                      FUSED_MAX_MERGE // n))


def radix_plan(B: int, n_items: int) -> dict:
    """How the radix route runs B users: chunks of ``chunk`` users, each a
    score and a select launch."""
    chunk = chunk_users(n_items)
    chunks = -(-B // chunk)
    return dict(chunk=chunk, chunks=chunks,
                launches=chunks * KERNELS_PER_CHUNK)


def fused_plan(B: int, n_items: int, n: int) -> dict:
    """How ``topk_catalog`` runs B users at n on the card: the route
    ("fused" up to FUSED_MAX_N, else "radix"), the fused route's candidate
    buffer and catalog slices, and the kernel launches of the call."""
    if n > FUSED_MAX_N:
        return dict(route="radix", cap=0, splits=0,
                    launches=radix_plan(B, n_items)["launches"])
    cap = fused_capacity(n)
    resident = library().topk_fused_resident(cap)
    if resident <= 0:
        raise RuntimeError(f"topk_fused_resident failed (cudaError "
                           f"{-resident})")
    splits = fused_splits(B, n_items, n, resident) if B else 1
    return dict(route="fused", cap=cap, splits=splits, resident=resident,
                launches=(1 + (splits > 1)) if B else 0)


def pass_launches(B: int, n_items: int, n: int) -> int:
    """Kernel launches of one ``topk_catalog`` call on the card."""
    return fused_plan(B, n_items, n)["launches"]


def _check(u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr, indices,
           users, n):
    if u_fac.dim() != 2 or i_fac.dim() != 2 or u_fac.shape[1] != \
            i_fac.shape[1]:
        raise ValueError(f"want u_fac [*, k] and i_fac [n_items, k], got "
                         f"{tuple(u_fac.shape)} and {tuple(i_fac.shape)}")
    n_items = i_fac.shape[0]
    if tuple(i_bias.shape) != (n_items,) or tuple(invalid.shape) != \
            (n_items,):
        raise ValueError("i_bias and invalid must be [n_items]")
    if tuple(u_bias.shape) != (u_fac.shape[0],) or mu.numel() != 1:
        raise ValueError("u_bias must be [n_users] and mu one value")
    if invalid.dtype != torch.bool:
        raise ValueError("invalid must be a bool mask")
    if indptr.dim() != 1 or indptr.dtype != torch.int64 or \
            indices.dim() != 1 or indices.dtype != torch.int32:
        raise ValueError("the exclusion CSR must be int64 indptr and int32 "
                         "indices")
    if users.dim() != 1 or users.dtype != torch.int64:
        raise ValueError("users must be a 1-d int64 tensor")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    tabs = (u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr, indices,
            users)
    if any(t.device != u_fac.device for t in tabs):
        raise ValueError("all inputs must share a device")
    if any(t.dtype != torch.float32 for t in tabs[:5]):
        raise ValueError("factors, biases and mu must be float32")
    if users.numel():
        with span("topk.check_ids"):
            lo, hi = int(users.min()), int(users.max())
            count("card_syncs", 2)
        if lo < 0 or hi >= min(u_fac.shape[0], indptr.numel() - 1):
            raise ValueError(f"user ids must lie in [0, "
                             f"{min(u_fac.shape[0], indptr.numel() - 1)})")


def _row_ranges(indptr: torch.Tensor, users: torch.Tensor):
    """(local row, CSR position) of every train entry of ``users``."""
    starts = indptr[users]
    counts = indptr[users + 1] - starts
    rows = torch.repeat_interleave(
        torch.arange(users.numel(), device=users.device), counts)
    first = torch.repeat_interleave(starts - (torch.cumsum(counts, 0)
                                              - counts), counts)
    return rows, first + torch.arange(rows.numel(), device=users.device)


def scores_plain(u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr, indices,
                 users) -> torch.Tensor:
    """The plain PyTorch version of the radix route's score stage: [B,
    n_items] f32 scores of ``users``, -3e38 where an item is invalid or in
    the user's train row."""
    sc = (((u_fac[users] @ i_fac.T) + mu) + u_bias[users][:, None]) \
        + i_bias[None, :]
    sc.masked_fill_(invalid[None, :], NEG_INF)
    rows, pos = _row_ranges(indptr, users)
    sc[rows, indices[pos].long()] = NEG_INF
    return sc


def topk_plain(u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr, indices,
               users, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: dense scores per chunk of users, the
    exclusions written over them, and a stable descending sort (equal
    scores keep id order). Returns (scores [B, n] f32, ids [B, n] int32)."""
    B, n_items = users.numel(), i_fac.shape[0]
    dev = u_fac.device
    out_s = torch.full((B, n), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    take = min(n, n_items)
    step = chunk_users(n_items)
    for s in range(0, B, step):
        sc = scores_plain(u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr,
                          indices, users[s:s + step])
        top_s, top_i = torch.sort(sc, dim=1, descending=True, stable=True)
        del sc
        top_s, top_i = top_s[:, :take], top_i[:, :take]
        ok = top_s > NEG_INF
        out_s[s:s + step, :take] = torch.where(ok, top_s, NEG_INF)
        out_i[s:s + step, :take] = torch.where(ok, top_i, -1).to(torch.int32)
    return out_s, out_i


def topk_catalog(u_fac: torch.Tensor, i_fac: torch.Tensor,
                 i_bias: torch.Tensor, u_bias: torch.Tensor,
                 mu: torch.Tensor, invalid: torch.Tensor,
                 indptr: torch.Tensor, indices: torch.Tensor,
                 users: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-n unrated items for each of ``users``.

    u_fac [n_users, k], i_fac [n_items, k], u_bias [n_users], i_bias
    [n_items], mu (one value), all f32; invalid [n_items] bool; indptr
    int64 / indices int32: the train CSR with one row per user (columns
    < n_items, sorted); users [B] int64. Returns (scores [B, n] f32, item
    ids [B, n] int32), descending. On the card n is at most
    ``library().topk_max_n()`` (4096); n <= FUSED_MAX_N takes the fused
    route, larger n the radix route."""
    _check(u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr, indices,
           users, n)
    if u_fac.device.type == "cpu":
        return topk_plain(u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr,
                          indices, users, n)
    if u_fac.device.type != "cuda":
        raise ValueError(f"no route for device {u_fac.device}")
    lib = library()
    if n > lib.topk_max_n():
        raise ValueError(f"the CUDA kernel takes n <= {lib.topk_max_n()}, "
                         f"got {n}")
    tabs = [t.contiguous() for t in (u_fac, i_fac, i_bias, u_bias,
                                     mu.reshape(1), invalid, indptr,
                                     indices, users)]
    B = users.numel()
    out_s = torch.empty((B, n), dtype=torch.float32, device=u_fac.device)
    out_i = torch.empty((B, n), dtype=torch.int32, device=u_fac.device)
    pl = fused_plan(B, i_fac.shape[0], n)
    if B:
        with torch.cuda.device(u_fac.device), span("topk.launch"):
            (_fused if pl["route"] == "fused" else _radix)(
                lib, tabs, out_s, out_i, n, pl)
    return out_s, out_i


topk_catalog.launches = 0


def _fused(lib, tabs, out_s, out_i, n: int, pl: dict) -> None:
    """The fused route: one launch, or two with catalog slices."""
    u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr, indices, users = tabs
    B, (n_items, k) = users.numel(), i_fac.shape
    keys = (torch.empty((B, pl["splits"], n), dtype=torch.int64,
                        device=u_fac.device) if pl["splits"] > 1 else None)
    err = lib.topk_fused(
        *(t.data_ptr() for t in (u_fac, users, i_fac, i_bias, u_bias, mu,
                                 invalid, indptr, indices)),
        None if keys is None else keys.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), B, n_items, k, n, pl["cap"], pl["splits"],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk fused kernel launch failed: "
                           f"{lib.topk_error_string(err).decode()} "
                           f"(cudaError {err}; {pl})")
    topk_catalog.launches += pl["launches"]


def _radix(lib, tabs, out_s, out_i, n: int, pl: dict) -> None:
    """The radix route: a score and a select kernel per chunk of users,
    through one [chunk, n_items] score scratch, each score written and
    read once."""
    u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr, indices, users = tabs
    B, (n_items, k) = users.numel(), i_fac.shape
    step = chunk_users(n_items)
    scratch = torch.empty(min(B, step) * n_items, dtype=torch.float32,
                          device=u_fac.device)
    stream = torch.cuda.current_stream().cuda_stream
    for s in range(0, B, step):
        m = min(step, B - s)
        err = lib.topk_catalog_chunk(
            u_fac.data_ptr(), users[s:].data_ptr(), i_fac.data_ptr(),
            i_bias.data_ptr(), u_bias.data_ptr(), mu.data_ptr(),
            invalid.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
            scratch.data_ptr(), out_s[s:].data_ptr(), out_i[s:].data_ptr(),
            m, n_items, k, n, stream)
        if err != 0:
            msg = lib.topk_error_string(err).decode()
            raise RuntimeError(f"topk kernel launch failed on users "
                               f"[{s}, {s + m}): {msg} (cudaError {err})")
        topk_catalog.launches += KERNELS_PER_CHUNK


def radix_scores(u_fac: torch.Tensor, i_fac: torch.Tensor,
                 i_bias: torch.Tensor, u_bias: torch.Tensor,
                 mu: torch.Tensor, invalid: torch.Tensor,
                 indptr: torch.Tensor, indices: torch.Tensor,
                 users: torch.Tensor) -> torch.Tensor:
    """The radix route's score stage: [B, n_items] f32, the scores of
    ``topk_catalog``'s order (-3e38 where an item is invalid or in the
    user's train row; on the card -0 as +0, bitwise the fused route's); at
    most ``chunk_users(n_items)`` users a call. Inputs as ``topk_catalog``;
    a CPU tensor runs ``scores_plain``."""
    _check(u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr, indices,
           users, 1)
    if u_fac.device.type == "cpu":
        return scores_plain(u_fac, i_fac, i_bias, u_bias, mu, invalid,
                            indptr, indices, users)
    if u_fac.device.type != "cuda":
        raise ValueError(f"no route for device {u_fac.device}")
    B, (n_items, k) = users.numel(), i_fac.shape
    if not 0 < B <= chunk_users(n_items):
        raise ValueError(f"radix_scores takes 1 to {chunk_users(n_items)} "
                         f"users at {n_items} items, got {B}")
    tabs = [t.contiguous() for t in (u_fac, users, i_fac, i_bias, u_bias,
                                     mu.reshape(1), invalid, indptr,
                                     indices)]
    S = torch.empty((B, n_items), dtype=torch.float32, device=u_fac.device)
    lib = library()
    with torch.cuda.device(u_fac.device):
        err = lib.topk_radix_scores(
            *(t.data_ptr() for t in tabs), S.data_ptr(), B, n_items, k,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk score kernel launch failed: "
                           f"{lib.topk_error_string(err).decode()} "
                           f"(cudaError {err})")
    radix_scores.launches += 1
    return S


radix_scores.launches = 0
