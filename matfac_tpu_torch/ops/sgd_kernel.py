"""One DSGD cell's whole stream applied to its two resident factor blocks
(port of matfac_tpu/ops/sgd_kernel.py).

The Pallas ``fused_cell_update`` never lowered on the TPU (Mosaic rejected
its row gathers) and ran only in interpret mode. On the card it is a
one-lane launch of the one-hot cell kernel, ``csrc/block_sgd.cu``: f32, no
collision normalization, no rank mask, batch offset 0. The plain version
adds each term with ``index_add_``, as the Pallas body's ``.at[].add``
does; the kernel sums each row's terms first and adds the sum once, so the
two differ by f32 summation order where an id repeats within a batch.

``fused_cell_update`` takes the tensors' device as the route: a CPU tensor
runs ``fused_cell_plain``; a CUDA tensor launches the kernel or raises.
It returns new blocks, as the JAX function does, and counts its kernel
launches in ``fused_cell_update.launches``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def fused_cell_update(u_blk: torch.Tensor, i_blk: torch.Tensor,
                      u_loc: torch.Tensor, i_loc: torch.Tensor,
                      vals: torch.Tensor, wts: torch.Tensor, lr, bs: int,
                      u_reg: float, i_reg: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one cell's stream to its blocks, the JAX signature:
    u_blk [BU, k], i_blk [BI, k] f32; u_loc / i_loc [S] int32, vals / wts
    [S] f32 with S % bs == 0; padding entries carry wts == 0."""
    S = u_loc.shape[0]
    if S % bs:
        raise ValueError("S must be a multiple of bs")
    streams = tuple(x.reshape(1, S) for x in (u_loc, i_loc, vals, wts))
    streams += (None, None, None)
    BU, BI = u_blk.shape[0], i_blk.shape[0]
    bsk._check(u_blk, i_blk, streams, bs, BU, BI, False, False)
    if bsk._route(u_blk) == "cpu":
        return fused_cell_plain(u_blk, i_blk, u_loc, i_loc, vals, wts, lr,
                                bs, u_reg, i_reg)
    U, I = u_blk.clone(), i_blk.clone()
    lanes = np.zeros((1, 1, 4), np.int32)
    fused_cell_update.launches += bsk.run_lanes(
        U, I, streams, lanes, [1], S, bs, BU, BI, lr, u_reg, i_reg,
        False, False, False)
    return U, I


fused_cell_update.launches = 0
