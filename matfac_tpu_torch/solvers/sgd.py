"""Minibatched scatter-add SGD (port of matfac_tpu/solvers/sgd.py): the
engine behind ``mf_method`` "sgd", "sgdpar", "sgdu" and "hogsgd".

The rating stream is shuffled once on the host; each epoch visits its
fixed-size batches in a random order, and each batch applies

    e    = r_ui - <p_u o m, q_i>            (m = per-example rank mask)
    p_u -= lr * m * (-2 w e q_i + 2 reg_u p_u)
    q_i -= lr * m * (-2 w e p_u + 2 reg_i q_i)

with every gradient computed at the batch's starting values and summed
into the tables by ``index_add_`` (the scatter-add of the JAX engine): the
deterministic analog of hogwild, modelMF.cpp:83-105's update with
per-occurrence regularization. w is the model's example weight (IFWMF), m
its rank mask (TMF; TMF+Dropout draws one per example from the solver's
generator), and biases train beside the factors for bias models.

Plain PyTorch on the tables' device: JAX computes this engine with XLA
gathers and scatters, not a Pallas kernel. On a CUDA device
``index_add_`` sums colliding rows with atomics in no fixed order, so two
runs of an epoch there need not be bit-identical; on the CPU they are.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.batching import coo_batches
from matfac_tpu_torch.models.base import MFState
from matfac_tpu_torch.solvers.block_sgd import stage_batch_collision_counts


class SGDSolver:
    """The staged rating stream and its epochs.

    ``reg_vec``: per-dim regularization rates [k] replacing u_reg / i_reg
    on both sides (trainSGDParSVD's scheme, modelMF.cpp:496-506), factor
    models only. ``reg_scale_u`` / ``reg_scale_i``: per-entity multipliers
    of the L2 rate ([n_users] / [n_items]), applied per occurrence like the
    scalar rates. ``collision_norm`` (None: ``params.sgd_collision_norm``):
    scale each example's gradient by 1 / the count of its entity within its
    batch, so a hot entity takes the mean of its colliding gradients; the
    counts are static (batch contents never change) and staged once.
    ``seed`` (None: ``params.seed``) seeds the batch-order and rank-mask
    generators; the static shuffle of the stream always uses
    ``params.seed``, as the JAX engine's does."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 batch_size: Optional[int] = None,
                 reg_vec: Optional[np.ndarray] = None,
                 collision_norm: Optional[bool] = None,
                 reg_scale_u: Optional[np.ndarray] = None,
                 reg_scale_i: Optional[np.ndarray] = None,
                 seed: Optional[int] = None, device="cuda"):
        self.model = model
        self.params = params
        self.device = torch.device(device)
        if reg_vec is not None and model.use_bias:
            raise ValueError("per-dim reg_vec is factor-only")
        f32 = lambda a: (None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=self.device))
        self.reg_vec = f32(reg_vec)
        self.reg_scale_u = f32(reg_scale_u)
        self.reg_scale_i = f32(reg_scale_i)
        self.collision_norm = (params.sgd_collision_norm
                               if collision_norm is None else collision_norm)
        b = coo_batches(train_mat, batch_size or params.batch_size,
                        invalid_users, invalid_items)
        # one static host shuffle; each epoch draws only the batch order
        sperm = np.random.default_rng(params.seed).permutation(b.n_total)
        rn, cn, vn = b.rows[sperm], b.cols[sperm], b.valid[sperm]
        idx = lambda a: torch.from_numpy(a.astype(np.int64)).to(self.device)
        self.rows, self.cols = idx(rn), idx(cn)
        self.vals = torch.from_numpy(b.vals[sperm]).to(self.device)
        self.valid = torch.from_numpy(vn).to(self.device)
        self.batch_size = b.batch_size
        self.n_batches = b.n_batches
        self.nnz = b.nnz
        self.inv_nu = self.inv_ni = None
        if self.collision_norm:
            # an element whose entity has no valid occurrence is itself
            # invalid (w = 0), so the clamped count is update-equivalent
            wts = vn.astype(np.float32).reshape(1, -1)
            inv = lambda loc, width: torch.from_numpy(np.where(
                vn > 0, 1.0 / stage_batch_collision_counts(
                    wts, loc.reshape(1, -1), b.batch_size, width).ravel(),
                0.0).astype(np.float32)).to(self.device)
            self.inv_nu = inv(rn, model.n_users)
            self.inv_ni = inv(cn, model.n_items)
        self.seed = params.seed if seed is None else seed
        self._order_gen = torch.Generator().manual_seed(self.seed + 43)
        # sampled ranks are drawn where the indices live
        self._mask_gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 47)

    # ------------------------------------------------------------------
    def batch_order(self) -> torch.Tensor:
        """This epoch's order of the batches, a permutation of
        range(n_batches) from the solver's own generator."""
        return torch.randperm(self.n_batches, generator=self._order_gen)

    def internal_state(self) -> dict:
        """What an exact resume needs besides the tables: both generators."""
        return {"order_gen": self._order_gen.get_state().numpy(),
                "mask_gen": self._mask_gen.get_state().cpu().numpy()}

    def set_internal_state(self, st: dict) -> None:
        as_state = lambda a: torch.from_numpy(np.asarray(a, np.uint8))
        if "order_gen" in st:
            self._order_gen.set_state(as_state(st["order_gen"]))
        if "mask_gen" in st:
            self._mask_gen.set_state(as_state(st["mask_gen"]))

    def epoch(self, state: MFState, lr: float) -> MFState:
        return self.epoch_with(state, lr, self.batch_order())

    def epoch_with(self, state: MFState, lr: float,
                   border: Sequence[int],
                   masks: Optional[Sequence[torch.Tensor]] = None
                   ) -> MFState:
        """One epoch over the batches in ``border``. ``masks``: the rank
        mask of each step, [B, k] 0/1 (step t uses masks[t]), in place of
        the model's, e.g. the draws of the JAX engine; None asks the model
        (a sampled-rank model draws from the solver's mask generator).
        Returns a new state; the given one is left as it was."""
        model = self.model
        p = self.params
        B = self.batch_size
        if self.reg_vec is not None:
            u_reg = i_reg = self.reg_vec[None, :]
        else:
            u_reg, i_reg = float(p.u_reg), float(p.i_reg)
        lr = float(lr)
        U, I = state.u_fac.clone(), state.i_fac.clone()
        bu, bi = state.u_bias.clone(), state.i_bias.clone()
        sampled = getattr(model, "stochastic_rank", False)
        for t, b in enumerate(torch.as_tensor(border).tolist()):
            sl = slice(b * B, (b + 1) * B)
            u, i, r, v = (self.rows[sl], self.cols[sl], self.vals[sl],
                          self.valid[sl])
            w = model.example_weight(u, i) * v
            if masks is not None:
                m = torch.as_tensor(masks[t], dtype=torch.float32,
                                    device=self.device)
            elif sampled:
                m = model.update_rank_mask(u, i, generator=self._mask_gen)
            else:
                m = model.update_rank_mask(u, i)
            side = model.update_side_masks(u, i)
            pu, qi = U[u].float(), I[i].float()
            bu_old, bi_old = bu[u].float(), bi[i].float()
            pred = torch.zeros_like(r)
            if model.use_factors:
                pred = ((pu if m is None else pu * m) * qi).sum(dim=1)
            if model.use_bias:
                pred = pred + bu_old + bi_old
            diff = r - pred
            ru = v if self.reg_scale_u is None else self.reg_scale_u[u] * v
            ri = v if self.reg_scale_i is None else self.reg_scale_i[i] * v
            wd = w * diff
            if model.use_factors:
                gu = -2.0 * wd[:, None] * qi + 2.0 * u_reg * (ru[:, None] * pu)
                gi = -2.0 * wd[:, None] * pu + 2.0 * i_reg * (ri[:, None] * qi)
                if m is not None:
                    gu, gi = gu * m, gi * m
                if side is not None:
                    # per-side gates on the whole gradient, prediction
                    # untouched (othersrc modelMFLoc.cpp:124-159)
                    gu, gi = gu * side[0], gi * side[1]
                if self.collision_norm:
                    gu = gu * self.inv_nu[sl][:, None]
                    gi = gi * self.inv_ni[sl][:, None]
                U.index_add_(0, u, (-lr * gu).to(U.dtype))
                I.index_add_(0, i, (-lr * gi).to(I.dtype))
            if model.use_bias:
                gbu = -2.0 * wd + 2.0 * u_reg * ru * bu_old
                gbi = -2.0 * wd + 2.0 * i_reg * ri * bi_old
                if side is not None:
                    gbu, gbi = gbu * side[0][:, 0], gbi * side[1][:, 0]
                if self.collision_norm:
                    gbu = gbu * self.inv_nu[sl]
                    gbi = gbi * self.inv_ni[sl]
                bu.index_add_(0, u, (-lr * gbu).to(bu.dtype))
                bi.index_add_(0, i, (-lr * gbi).to(bi.dtype))
        return state._replace(u_fac=U, i_fac=I, u_bias=bu, i_bias=bi)
