"""Multi-process runtime: process-group set-up, the few collectives the
mesh solvers use, and host-local data loading (port of
matfac_tpu/parallel/distributed.py, whose ``jax.distributed`` bootstrap
and ``multihost_utils.process_allgather`` calls become
``torch.distributed``).

``initialize`` reads torchrun's variables (``MASTER_ADDR`` /
``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``) and is a no-op without them.
Backend: NCCL where every process of a host can have a CUDA device of its
own, else gloo. gloo moves CPU tensors only, so on the gloo backend the
exchanged blocks hop through host memory (``ring_exchange``,
``allgather_blocks``); NCCL refuses two ranks on one card, so two
processes sharing a card always run on gloo.

Host metadata (frequency counts, cell sizes, the staging ladder's choices)
goes through ``allgather`` (``all_gather_object``); tensors through
``ring_exchange`` and ``allgather_blocks``. The coordinate solvers under a
mesh across processes (ALS, iALS++, dense ALS) split each half-sweep's
batches of rows with ``balanced_split``, read the whole train matrix
through ``whole_matrix`` and share their solved rows with
``allgather_rows``.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Set up ``torch.distributed`` from the arguments or torchrun's
    environment; a no-op for a single-process run (no address given and
    no ``MASTER_ADDR``) or when the group already exists."""
    if dist.is_initialized():
        return
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr is None:
            return
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", "1"))
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= local else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def multiprocess() -> bool:
    return process_count() > 1


def _comm_device() -> torch.device:
    """Where a collective's tensors must live: the CPU on gloo, the
    process's current card on NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather(x) -> np.ndarray:
    """Every process's ``x`` (a numpy array or scalar), stacked [P, ...] in
    rank order (JAX's ``process_allgather``); [1, ...] in one process."""
    x = np.asarray(x)
    if not multiprocess():
        return x[None]
    out: List = [None] * process_count()
    dist.all_gather_object(out, x)
    return np.stack(out)


def all_reduce_sum(values: Sequence[float]) -> List[float]:
    """Float64 sums of ``values`` over the processes."""
    t = torch.tensor(list(values), dtype=torch.float64)
    if multiprocess():
        t = t.to(_comm_device())
        dist.all_reduce(t)
    return t.cpu().tolist()


def barrier() -> None:
    if multiprocess():
        dist.barrier()


def ring_exchange(send: torch.Tensor) -> torch.Tensor:
    """Send ``send`` to the previous rank and receive the next rank's
    tensor of the same shape and dtype (the ring step of JAX's ``ppermute``
    (j -> j - 1) across processes); the received tensor lands on
    ``send``'s device."""
    world, me = process_count(), process_index()
    dev = _comm_device()
    buf = send.to(dev).contiguous()
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, (me - 1) % world),
           dist.P2POp(dist.irecv, recv, (me + 1) % world)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(send.device)


def allgather_blocks(local: torch.Tensor) -> torch.Tensor:
    """[nb, ...] blocks of every process, concatenated in rank order ([P *
    nb, ...], each process the same nb), on ``local``'s device."""
    if not multiprocess():
        return local
    dev = _comm_device()
    buf = local.to(dev).contiguous()
    out = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(out, buf)
    return torch.cat(out).to(local.device)


def balanced_split(work: Sequence[float], parts: int) -> List[range]:
    """Contiguous runs of ``len(work)`` batches, one a part, balanced by
    work: batch j goes to the part into whose [p W / parts, (p + 1) W /
    parts) its cumulative start falls (W the total). A run may be empty."""
    w = np.asarray(work, np.float64)
    start = np.cumsum(w) - w
    total = float(w.sum())
    owner = (np.minimum((start * parts) // total, parts - 1).astype(np.int64)
             if total > 0 else np.zeros(len(w), np.int64))
    bounds = np.searchsorted(owner, np.arange(parts + 1), side="left")
    return [range(int(bounds[p]), int(bounds[p + 1])) for p in range(parts)]


def allgather_rows(table: torch.Tensor, ids: Sequence[torch.Tensor]) -> None:
    """Share solved rows, in place: process p solved rows ``ids[p]`` of
    ``table`` (every process passes the same list); afterwards every
    process holds every process's rows. A no-op in one process."""
    if not multiprocess():
        return
    dev = _comm_device()
    me = process_index()
    most = max(int(i.numel()) for i in ids)
    buf = torch.zeros((most,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=dev)
    buf[: ids[me].numel()] = table[ids[me]].to(dev)
    out = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(out, buf)
    for p, rows in enumerate(out):
        if p != me and ids[p].numel():
            table[ids[p]] = rows[: ids[p].numel()].to(table.device)


def whole_matrix(mat):
    """The whole rating matrix on every process: ``mat`` itself where every
    process holds the same matrix (or in one process), else the union of
    the processes' host-local rows, each row's entries in their order.
    Raises ValueError where two processes hold entries of one row."""
    if not multiprocess():
        return mat
    h = hashlib.sha256()
    for a in (mat.indptr, mat.indices, mat.values):
        h.update(np.ascontiguousarray(a).tobytes())
    digests = allgather(np.frombuffer(h.digest(), np.uint8))
    if (digests == digests[0]).all():
        return mat
    parts: List = [None] * process_count()
    dist.all_gather_object(parts, (mat.indptr, mat.indices, mat.values,
                                   mat.ncols))
    n_rows = max(len(p[0]) for p in parts) - 1
    held = np.zeros(n_rows, np.int64)
    for indptr, *_ in parts:
        held[: len(indptr) - 1] += np.diff(indptr) > 0
    if (held > 1).any():
        raise ValueError(
            f"{int((held > 1).sum())} rows hold entries on more than one "
            "process: host-local rows must not overlap")
    rows = np.concatenate([np.repeat(np.arange(len(p[0]) - 1), np.diff(p[0]))
                           for p in parts])
    order = np.argsort(rows, kind="stable")
    cols = np.concatenate([p[1] for p in parts])[order]
    vals = np.concatenate([p[2] for p in parts])[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=n_rows))]).astype(np.int64)
    return type(mat)(indptr, cols, vals, max(p[3] for p in parts))


def host_user_range(n_users: int, n_shards: int, shard_id: int
                    ) -> Tuple[int, int]:
    """Contiguous user-row range owned by a shard (the DSGD solvers'
    ownership: block i = rows [i*bu, (i+1)*bu))."""
    bu = -(-n_users // n_shards)
    return shard_id * bu, min((shard_id + 1) * bu, n_users)


def host_local_ratings(train_mat, n_users: int, n_shards: int,
                       shard_id: int):
    """A host's local rating rows (the users it owns): what each process
    loads and stages in a multi-process run, so no host holds the full
    stream."""
    lo, hi = host_user_range(n_users, n_shards, shard_id)
    r, c, v = train_mat.to_coo()
    keep = (r >= lo) & (r < hi)
    return r[keep], c[keep], v[keep]
