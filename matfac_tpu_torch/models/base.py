"""Model state and plain MF (port of matfac_tpu/models/base.py).

``MFState`` / ``EvalView`` are NamedTuples of tensors on one device. The
init draws on the CPU from an explicit ``torch.Generator`` and then moves
to ``device``, so a seed gives the same tables on every device. Torch
cannot reproduce ``jax.random``: to start both packages from one state,
build it with numpy and pass it through ``state_from_numpy``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from matfac_tpu_torch.config import Params


class MFState(NamedTuple):
    """Trainable tensors (model.h:37-41 uFac/iFac/uBias/iBias/mu)."""
    u_fac: torch.Tensor    # [n_users, k]
    i_fac: torch.Tensor    # [n_items, k]
    u_bias: torch.Tensor   # [n_users]
    i_bias: torch.Tensor   # [n_items]
    mu: torch.Tensor       # scalar global bias


class EvalView(NamedTuple):
    """Pre-masked tensors: every model predicts
    ``mu + u_bias[u] + i_bias[i] + <u_fac[u], i_fac[i]>``."""
    u_fac: torch.Tensor
    i_fac: torch.Tensor
    u_bias: torch.Tensor
    i_bias: torch.Tensor
    mu: torch.Tensor


def init_state(params: Params, n_users: int, n_items: int,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> MFState:
    """uniform(-0.01, 0.01) factors and biases (Model::Model,
    model.cpp:2331-2362). ``generator`` is a CPU generator; None seeds
    one from ``params.seed``."""
    if generator is None:
        generator = torch.Generator().manual_seed(params.seed)
    dt = getattr(torch, params.dtype)
    k = params.fac_dim

    def uniform(*shape):
        x = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (x * 0.02 - 0.01).to(device=device, dtype=dt)

    return MFState(u_fac=uniform(n_users, k), i_fac=uniform(n_items, k),
                   u_bias=uniform(n_users), i_bias=uniform(n_items),
                   mu=torch.zeros((), dtype=dt, device=device))


def state_from_numpy(u_fac, i_fac, u_bias, i_bias, mu,
                     device="cuda") -> MFState:
    """MFState from host arrays — e.g. ``np.asarray`` of each leaf of a
    JAX state, so both packages start from the same tables."""
    as_t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    return MFState(as_t(u_fac), as_t(i_fac), as_t(u_bias), as_t(i_bias),
                   as_t(mu))


def state_to_numpy(state: MFState):
    """Tuple of host arrays in MFState field order."""
    return tuple(t.detach().cpu().numpy() for t in state)


def rank_mask(ranks: torch.Tensor, k: int) -> torch.Tensor:
    """[n] int ranks -> [n, k] {0,1} mask keeping dims j < rank (the
    per-entity truncation of the rank-adaptive models)."""
    iota = torch.arange(k, device=ranks.device)
    return (iota[None, :] < ranks[:, None]).to(torch.float32)


class ModelMF:
    """Plain MF: estRating = <p_u, q_i> (model.cpp:547-549); SGD update
    weight 1, full rank. The hooks below are the JAX ModelMF's; the
    solvers read them to stage weights and rank masks."""

    name = "mf"
    use_bias = False
    use_factors = True
    # True when the training rank is drawn at random per update: such a
    # model needs an engine that samples ranks, not one that stages static
    # per-pair ranks (the block engine refuses it)
    stochastic_rank = False

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: Optional[np.ndarray] = None,
                 item_freq: Optional[np.ndarray] = None):
        self.params = params
        self.n_users = n_users
        self.n_items = n_items
        self.k = params.fac_dim
        self.user_freq = user_freq
        self.item_freq = item_freq

    # ---- prediction -------------------------------------------------
    def entity_ranks(self):
        """(rank_u [n_users], rank_i [n_items]) inference truncation
        ranks, or None for full rank."""
        return None

    def eval_view(self, state: MFState) -> EvalView:
        """Factors masked to their entity ranks; biases only when the
        model has them."""
        u_fac, i_fac = state.u_fac, state.i_fac
        ranks = self.entity_ranks()
        if ranks is not None:
            r_u, r_i = (r.to(u_fac.device) for r in ranks)
            u_fac = u_fac * rank_mask(r_u, self.k).to(u_fac.dtype)
            i_fac = i_fac * rank_mask(r_i, self.k).to(i_fac.dtype)
        if not self.use_factors:
            u_fac = torch.zeros_like(u_fac)
            i_fac = torch.zeros_like(i_fac)
        if self.use_bias:
            return EvalView(u_fac, i_fac, state.u_bias, state.i_bias,
                            torch.zeros_like(state.mu))
        return EvalView(u_fac, i_fac, torch.zeros_like(state.u_bias),
                        torch.zeros_like(state.i_bias),
                        torch.zeros_like(state.mu))

    # ---- SGD hooks ---------------------------------------------------
    def example_weight(self, u_idx: torch.Tensor, i_idx: torch.Tensor
                       ) -> torch.Tensor:
        """Per-example data-fit weight (1 for plain MF)."""
        return torch.ones(u_idx.shape, dtype=torch.float32,
                          device=u_idx.device)

    def update_rank_mask(self, u_idx: torch.Tensor, i_idx: torch.Tensor,
                         generator: Optional[torch.Generator] = None):
        """[B, k] {0,1} mask of the dims each example predicts and updates
        in training, or None for full rank. A model that samples its ranks
        draws them from ``generator`` (on the indices' device)."""
        return None

    def update_side_masks(self, u_idx: torch.Tensor, i_idx: torch.Tensor):
        """Per-side update gates (m_u, m_i) multiplying the whole user- or
        item-side gradient, or None. A model that overrides this carries
        gates that only the scatter SGD engine honours; the block engine
        refuses it (the JAX solver's test of the override)."""
        return None

    def transform_init_state(self, state: MFState) -> MFState:
        """Applied once to the initial state before training; the
        identity here (a hook for models that zero dims at init)."""
        return state


class ModelMFBias:
    """Bias-only model: estRating = b_u + b_i; factors and the global mean
    are left out of the prediction (modelMFBias.cpp:94-99). Like the JAX
    class it borrows ModelMF's hooks without being a ModelMF."""

    name = "mf_bias"
    use_bias = True
    use_factors = False

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq=None, item_freq=None):
        self.params = params
        self.n_users = n_users
        self.n_items = n_items
        self.k = params.fac_dim

    entity_ranks = ModelMF.entity_ranks
    eval_view = ModelMF.eval_view
    example_weight = ModelMF.example_weight
    update_rank_mask = ModelMF.update_rank_mask
    update_side_masks = ModelMF.update_side_masks
    transform_init_state = ModelMF.transform_init_state
