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
``topk_plain``; a CUDA tensor launches the kernel or raises.
``topk_catalog.launches`` counts kernel launches, ``KERNELS_PER_CHUNK``
per chunk of ``chunk_users(n_items)`` users.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from matfac_tpu_torch.ops import _build

NEG_INF = float(np.float32(-3.0e38))   # the f32 value, exactly
KERNELS_PER_CHUNK = 2   # score kernel + select kernel
# f32 scores one chunk may hold (1 GiB): bounds the kernel's scratch and the
# plain version's score and sort temporaries
SCRATCH_FLOATS = 1 << 28
_MAX_CHUNK = 1 << 20    # keeps the score kernel's user grid under 65535

_SIGNATURES = {
    "topk_catalog_chunk": (ctypes.c_int, [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, I, k, n
        ctypes.c_void_p]),                                        # stream
    "topk_max_n": (ctypes.c_int, []),
    "topk_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc on first use)."""
    return _build.load("topk", _SIGNATURES)


def chunk_users(n_items: int) -> int:
    """Users scored per chunk (one kernel pair, one scratch) at this
    catalog width."""
    return max(1, min(_MAX_CHUNK, SCRATCH_FLOATS // max(n_items, 1)))


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
        lo, hi = int(users.min()), int(users.max())
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
        uu = users[s:s + step]
        sc = (((u_fac[uu] @ i_fac.T) + mu) + u_bias[uu][:, None]) \
            + i_bias[None, :]
        sc.masked_fill_(invalid[None, :], NEG_INF)
        rows, pos = _row_ranges(indptr, uu)
        sc[rows, indices[pos].long()] = NEG_INF
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
    ``library().topk_max_n()`` (4096)."""
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
    u_fac, i_fac, i_bias, u_bias, mu, invalid, indptr, indices, users = tabs
    B, (n_items, k) = users.numel(), i_fac.shape
    dev = u_fac.device
    out_s = torch.empty((B, n), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, n), dtype=torch.int32, device=dev)
    step = chunk_users(n_items)
    scratch = torch.empty(min(B, step) * n_items, dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(0, B, step):
            m = min(step, B - s)
            err = lib.topk_catalog_chunk(
                u_fac.data_ptr(), users[s:].data_ptr(), i_fac.data_ptr(),
                i_bias.data_ptr(), u_bias.data_ptr(), mu.data_ptr(),
                invalid.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
                scratch.data_ptr(), out_s[s:].data_ptr(),
                out_i[s:].data_ptr(), m, n_items, k, n, stream)
            if err != 0:
                msg = lib.topk_error_string(err).decode()
                raise RuntimeError(f"topk kernel launch failed on users "
                                   f"[{s}, {s + m}): {msg} (cudaError "
                                   f"{err})")
            topk_catalog.launches += KERNELS_PER_CHUNK
    return out_s, out_i


topk_catalog.launches = 0
