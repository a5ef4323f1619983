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
``ring_exchange`` and ``allgather_blocks``.
"""

from __future__ import annotations

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
