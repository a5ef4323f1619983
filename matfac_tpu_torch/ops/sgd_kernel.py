"""One DSGD cell's whole stream applied to its two resident factor blocks
(port of matfac_tpu/ops/sgd_kernel.py).

The Pallas ``fused_cell_update`` never lowered on the TPU (Mosaic rejected
its row gathers) and ran only in interpret mode. On the card it is a
one-lane launch of the one-hot cell kernel, ``csrc/block_sgd.cu``: f32, no
collision normalization, no rank mask, batch offset 0, one cluster. The
plain version adds each term with ``index_add_``, as the Pallas body's
``.at[].add`` does; the kernel sums each row's terms first and adds the sum
once, so the two differ by f32 summation order where an id repeats within
a batch.

``fused_cell_update`` takes the tensors' device as the route: a CPU tensor
runs ``fused_cell_plain``; a CUDA tensor launches the kernel or raises.
It returns new blocks, as the JAX function does. A call on the card is one
launch on a persistent one-lane table. It checks the stream's ids (a sync)
and sorts its slices for the kernel, unless the caller staged them once
with ``stage_cell`` and passes them as ``slices=``: then the call neither
syncs nor allocates anything but the new blocks. It counts its launches
in ``fused_cell_update.launches`` and its finished cells in the device
counter ``fused_cell_update.cells`` (``block_sgd_kernel.cells_done``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from matfac_tpu_torch.ops import block_sgd_kernel as bsk


def fused_cell_plain(u_blk, i_blk, u_loc, i_loc, vals, wts, lr, bs: int,
                     u_reg: float, i_reg: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas body's minibatch sequence in plain PyTorch."""
    U, I = u_blk.clone(), i_blk.clone()
    u_loc, i_loc = u_loc.long(), i_loc.long()
    for s in range(u_loc.shape[0] // bs):
        sl = slice(s * bs, (s + 1) * bs)
        u, i, r, w = u_loc[sl], i_loc[sl], vals[sl], wts[sl]
        pu, qi = U[u], I[i]
        coeff = w * (r - (pu * qi).sum(1))
        vmask = (w > 0).to(U.dtype)
        gu = -2.0 * coeff[:, None] * qi + 2.0 * u_reg * vmask[:, None] * pu
        gi = -2.0 * coeff[:, None] * pu + 2.0 * i_reg * vmask[:, None] * qi
        U.index_add_(0, u, -lr * gu)
        I.index_add_(0, i, -lr * gi)
    return U, I


def _one_row(u_loc, i_loc, vals, wts) -> tuple:
    """A cell's stream as the kernel's streams: one row, no collision
    counts, no ranks."""
    S = u_loc.shape[0]
    return tuple(x.reshape(1, S) for x in (u_loc, i_loc, vals, wts)) + \
        (None, None, None)


def stage_cell(u_loc: torch.Tensor, i_loc: torch.Tensor, vals: torch.Tensor,
               wts: torch.Tensor, bs: int, BU: int, BI: int, k: int) -> dict:
    """One cell's stream on the card staged once for
    ``fused_cell_update(..., slices=)``: its ids checked, its slices sorted
    for the one-lane plan of (bs, BU, BI, k)."""
    with torch.cuda.device(u_loc.device):
        range_size = bsk.plan(1, bs, BU, BI, k)["range"]
    return bsk.stage_slices(_one_row(u_loc, i_loc, vals, wts), bs, BU, BI,
                            False, False, range_size)


def fused_cell_update(u_blk: torch.Tensor, i_blk: torch.Tensor,
                      u_loc: torch.Tensor, i_loc: torch.Tensor,
                      vals: torch.Tensor, wts: torch.Tensor, lr, bs: int,
                      u_reg: float, i_reg: float,
                      slices: Optional[dict] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one cell's stream to its blocks, the JAX signature:
    u_blk [BU, k], i_blk [BI, k] f32; u_loc / i_loc [S] int32, vals / wts
    [S] f32 with S % bs == 0; padding entries carry wts == 0. ``slices``:
    the stream as ``stage_cell`` staged it (the CPU route ignores it)."""
    S = u_loc.shape[0]
    if S % bs:
        raise ValueError("S must be a multiple of bs")
    streams = _one_row(u_loc, i_loc, vals, wts)
    BU, BI = u_blk.shape[0], i_blk.shape[0]
    bsk._check(u_blk, i_blk, streams, bs, BU, BI, False, False, slices)
    if bsk._route(u_blk) == "cpu":
        return fused_cell_plain(u_blk, i_blk, u_loc, i_loc, vals, wts, lr,
                                bs, u_reg, i_reg)
    U, I = u_blk.clone(), i_blk.clone()
    lanes = bsk._buf(U.device, "one_lane", 4, torch.int32).view(1, 1, 4)
    bsk.launch(fused_cell_update, U, I, streams, lanes, bs, BU, BI, lr,
               u_reg, i_reg, False, False, False, slices)
    return U, I


fused_cell_update.launches = 0
fused_cell_update.cells = None
