"""Scatter-add in a fixed order: the engines' ``.at[].add`` on the card.

JAX sums a batch's colliding rows with XLA's scatter-add, which gives the
same bits on every run (matfac_tpu/solvers/sgd.py calls its engine "the
deterministic analog of hogwild"). ``Tensor.index_add_`` on a CUDA tensor
adds with atomics in no fixed order, so two runs of an epoch differ in the
last bits and the difference grows over the epochs.

``index_add_ordered_`` takes PyTorch's sort-based route on a CUDA tensor,
``index_put_(accumulate=True)``: a stable sort of the indices, then each
row's duplicates added onto the row one after another in their order in
``index``, each add rounded to the table's type. The sum is the same on
every run. Its time grows with the count of a batch's hottest row (the
adds of one row wait on each other). On the CPU it is ``index_add_``
itself, so the CPU parity tests against JAX keep their bits; for a bf16
table that rounds less often than the card's route, which rounds at
every duplicate. There is no atomic route.
"""

from __future__ import annotations

import torch

from matfac_tpu_torch.train.profiler import span


def index_add_ordered_(table: torch.Tensor, dim: int, index: torch.Tensor,
                       source: torch.Tensor) -> torch.Tensor:
    """``table.index_add_(dim, index, source)`` with colliding entries
    summed in a fixed order on every device; returns ``table``. A ``dim``
    other than 0 scatters along it through a view that moves it to the
    front (PyTorch then works on a contiguous copy of the table)."""
    with span("scatter.ordered"):
        if table.device.type == "cpu":
            return table.index_add_(dim, index, source)
        view, src = table.movedim(dim, 0), source.movedim(dim, 0)
        view.index_put_((index,), src, accumulate=True)
        return table
