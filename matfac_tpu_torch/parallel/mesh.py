"""The device mesh and the factor tables' row sharding (port of
matfac_tpu/parallel/mesh.py).

torch has no ``shard_map`` and no SPMD partitioner, so the port keeps the
mesh's semantics, not its machinery: N shards on the axes of a small
``Mesh`` class, each shard one ``torch.device`` and owned by one process
(rank of ``torch.distributed``, 0 without it). A device may appear more
than once: 8 shards on the CPU are how the tests stand in for JAX's 8
virtual host devices, and 4 shards on one card are how the card runs a
4-shard mesh. The decomposition is JAX's: the "u" axis row-shards uFac
(contiguous user blocks, one per shard), the "i" axis row-shards iFac,
and the DSGD solvers (``parallel/dsgd.py``, ``parallel/block_dsgd.py``)
rotate item blocks between the shards of their axis.

A process holds its factor tables whole (``shard_state`` places them on
the process's first mesh device); the solvers split them into the shards'
blocks for an epoch and gather them back after it, so the rest of the
package (the training loop, the evaluators, the checkpoints) sees plain
tensors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from matfac_tpu_torch.models.base import MFState
from matfac_tpu_torch.parallel import distributed


class Mesh:
    """``devices``: object array of ``torch.device`` in the mesh's shape;
    ``process_of``: int array of the same shape, the rank that owns each
    shard. ``shape`` maps each axis name to its size, as JAX's mesh does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_of: Optional[np.ndarray] = None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_of = (np.zeros(devices.shape, np.int64)
                           if process_of is None
                           else np.asarray(process_of).reshape(devices.shape))
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _along(self, axis: str, a: np.ndarray) -> np.ndarray:
        """The entries of ``a`` along ``axis``, index 0 on the others (a
        solver's shards; the other axes replicate its work, as JAX's
        shard_map over one axis does)."""
        ax = self.axis_names.index(axis)
        idx = tuple(slice(None) if d == ax else 0 for d in range(a.ndim))
        return a[idx]

    def axis_devices(self, axis: str) -> List[torch.device]:
        return list(self._along(axis, self.devices))

    def local_blocks(self, axis: str) -> List[int]:
        """The shards along ``axis`` this process owns, ascending."""
        owner = self._along(axis, self.process_of)
        me = distributed.process_index()
        return [b for b in range(len(owner)) if owner[b] == me]

    def local_shards(self) -> List[int]:
        """The flat indices of every shard this process owns (the
        evaluators split their work over all of the mesh's shards)."""
        me = distributed.process_index()
        return [s for s, p in enumerate(self.process_of.reshape(-1))
                if p == me]

    def home(self) -> torch.device:
        """The process's first mesh device: where its whole factor tables
        and the evaluators' inputs live."""
        flat = self.devices.reshape(-1)
        return flat[self.local_shards()[0]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.reshape(-1))})"


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = ("u", "i"),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over this process's ``devices`` (default: every visible CUDA
    device) times the processes of ``torch.distributed``; each process
    owns a contiguous run of shards, rank r the r-th, and lays out its own
    devices the same way (as one launcher does on every host). ``shape``
    None puts every shard on the first axis; its product must equal the
    global shard count, as in JAX."""
    if devices is None:
        devices = [torch.device("cuda", j)
                   for j in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device: pass devices=[torch.device("
                               "'cpu')] * n for a mesh on the CPU")
    local = [torch.device(d) for d in devices]
    # "cuda" names the current card: give it its index, so that tensors and
    # generators made on a shard's device compare equal
    local = [torch.device("cuda", torch.cuda.current_device())
             if d.type == "cuda" and d.index is None else d for d in local]
    world = distributed.process_count()
    n = world * len(local)
    if shape is None or len(shape) == 0:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    devs = np.empty(n, dtype=object)
    for j in range(n):
        devs[j] = local[j % len(local)]
    owner = np.repeat(np.arange(world), len(local))
    return Mesh(devs.reshape(shape), tuple(axes[: len(shape)]),
                owner.reshape(shape))


def factor_sharding(mesh: Mesh, u_axis: str = "u", i_axis: str = "i"
                    ) -> Tuple[tuple, tuple]:
    """Row-sharding specs of (uFac, iFac), JAX's PartitionSpecs as tuples:
    the axis that splits the rows (None where the mesh has no such axis)
    and None for the replicated factor dim."""
    u_spec = (u_axis if u_axis in mesh.axis_names else None, None)
    i_spec = (i_axis if i_axis in mesh.axis_names else None, None)
    return u_spec, i_spec


def shard_state(state: MFState, mesh: Mesh, u_axis: str = "u",
                i_axis: str = "i") -> MFState:
    """Place a model state for a mesh: every table on the process's first
    mesh device (``Mesh.home``). The row split of ``factor_sharding`` is
    applied by the solvers, which cut the tables into the shards' blocks
    for an epoch."""
    home = mesh.home()
    return MFState(*(t.to(home) for t in state))


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
