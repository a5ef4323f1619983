"""The sgd engine's batch step on the CPU (matfac_tpu_torch/ops/sgd_step.py):
``sgd_step_plain`` equals the engine's former eager step bit for bit, and
``SGDSolver.epoch_with`` on CPU tables goes through it once a batch, for
every input the step takes: plain MF, biases, IFWMF weights, a fixed rank
mask (TMF), TMF+Dropout's masks given and drawn, [B, k] and [B, 1] side
gates, collision_norm, reg_vec, reg_scale_* and bf16 tables. The kernel
route is held to it on the card: tests/test_torch_cuda_sgd_step.py."""

import numpy as np
import pytest
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.synthetic import synthetic_data
from matfac_tpu_torch.models import base as tbase
from matfac_tpu_torch.models import longtail as tlt
from matfac_tpu_torch.ops import sgd_step as step_mod
from matfac_tpu_torch.ops.scatter import index_add_ordered_
from matfac_tpu_torch.solvers.sgd import SGDSolver
from matfac_tpu_torch.utils import freq

# case: (model, SGDSolver keywords, Params keywords)
CASES = {
    "mf": ("mf", {}, {}),
    "mf_bias": ("mf_bias", {}, {}),
    "tmf_bias": ("tmf_bias", {}, {}),
    "ifwmf": ("ifwmf", {}, {"rho_rms": 20.0}),
    "tmf": ("tmf", {}, {"rho_rms": 3.0}),
    "tmfdropout_given": ("tmfdropout", {}, {"rho_rms": 3.0}),
    "tmfdropout_drawn": ("tmfdropout", {}, {"rho_rms": 3.0}),
    "mf_loc": ("mf_loc", {}, {}),
    "gates": ("gates", {}, {}),
    "collision_norm": ("mf", {"collision_norm": True}, {}),
    "tmf_bias_collision_norm": ("tmf_bias", {"collision_norm": True}, {}),
    "reg_vec": ("mf", "reg_vec", {}),
    "reg_scale": ("mf", "reg_scale", {}),
    "bf16": ("tmf_bias", {}, {"dtype": "bfloat16"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(name, p, data, iu, ii, uf, if_):
    n, m = data.n_users, data.n_items
    if name == "mf_bias":
        return tbase.ModelMFBias(p, n, m)
    if name == "tmf_bias":
        return tlt.ModelDropoutSigmoidBias(p, n, m, uf, if_)
    if name == "ifwmf":
        return tlt.ModelInvPopMF(p, n, m, uf, if_, iu, ii)
    if name == "tmf":
        return tlt.ModelDropoutSigmoid(p, n, m, uf, if_)
    if name == "tmfdropout":
        return tlt.ModelPoissonDropout(p, n, m, uf, if_)
    if name == "mf_loc":
        return tlt.ModelLocalityMF(p, n, m, freq.head_items_from_freq(uf, 0.8),
                                   freq.head_items_from_freq(if_, 0.8))
    if name == "gates":
        return tlt.ModelSideGatedMF(p, n, m, np.arange(n) % 3 > 0,
                                    np.arange(m) % 2 == 0)
    return tbase.ModelMF(p, n, m)


def _solver(case, k=8, device="cpu", dtype=None):
    """The case's solver and a start whose entries are multiples of 2**-8
    in [-1/4, 1/4]: exact in bf16, and a dot product of two rows is exact
    in f32 in any order of summation. ``dtype``: the tables' type, in
    place of the case's."""
    name, kw, extra = CASES[case]
    if dtype is not None:
        extra = dict(extra, dtype=dtype)
    data, _, _ = synthetic_data(n_users=90, n_items=70, k=3, density=0.3,
                                seed=5, noise=0.05, nonneg=True,
                                power_law=0.8)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    uf, if_ = freq.row_col_freq(data.train_mat)
    p = Params(fac_dim=k, u_reg=0.05, i_reg=0.02, learn_rate=0.05, seed=3,
               batch_size=64, **extra)
    if kw == "reg_scale":
        rng = np.random.default_rng(1)
        kw = dict(reg_scale_u=rng.uniform(0.5, 2.0, data.n_users),
                  reg_scale_i=rng.uniform(0.5, 2.0, data.n_items))
    elif kw == "reg_vec":
        kw = dict(reg_vec=np.linspace(0.01, 0.1, k))
    model = _model(name, p, data, iu, ii, uf, if_)
    s = SGDSolver(model, p, data.train_mat, iu, ii, device=device, **kw)
    g = torch.Generator().manual_seed(4)
    dt = getattr(torch, p.dtype)
    rnd = lambda *shape: (torch.randint(-64, 65, shape, generator=g)
                          / 256).to(device=device, dtype=dt)
    state = tbase.MFState(rnd(data.n_users, k), rnd(data.n_items, k),
                          rnd(data.n_users), rnd(data.n_items),
                          torch.zeros((), dtype=dt, device=device))
    return s, state


def _masks(s, border):
    """TMF+Dropout's masks of each step, drawn ahead (the ``masks=`` of
    ``epoch_with``), or None for the other cases."""
    if not getattr(s.model, "stochastic_rank", False):
        return None
    g = torch.Generator(device=s.device).manual_seed(11)
    B = s.batch_size
    return [s.model.update_rank_mask(s.rows[b * B:(b + 1) * B],
                                     s.cols[b * B:(b + 1) * B], generator=g)
            for b in border]


def _eager_epoch(s, state, lr, border, masks=None):
    """``SGDSolver.epoch_with`` as the engine ran it before its step moved
    to ops/sgd_step.py: the eager chain, line for line."""
    model = s.model
    p = s.params
    B = s.batch_size
    if s.reg_vec is not None:
        u_reg = i_reg = s.reg_vec[None, :]
    else:
        u_reg, i_reg = float(p.u_reg), float(p.i_reg)
    lr = float(lr)
    U, I = state.u_fac.clone(), state.i_fac.clone()
    bu, bi = state.u_bias.clone(), state.i_bias.clone()
    sampled = getattr(model, "stochastic_rank", False)
    for t, b in enumerate(torch.as_tensor(border).tolist()):
        sl = slice(b * B, (b + 1) * B)
        u, i, r, v = (s.rows[sl], s.cols[sl], s.vals[sl], s.valid[sl])
        up, ip = ((s.step.u_plans[b], s.step.i_plans[b])
                  if s.step.u_plans else (None, None))
        w = model.example_weight(u, i) * v
        if masks is not None:
            m = torch.as_tensor(masks[t], dtype=torch.float32,
                                device=s.device)
        elif sampled:
            m = model.update_rank_mask(u, i, generator=s._mask_gen)
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
        ru = v if s.reg_scale_u is None else s.reg_scale_u[u] * v
        ri = v if s.reg_scale_i is None else s.reg_scale_i[i] * v
        wd = w * diff
        if model.use_factors:
            gu = -2.0 * wd[:, None] * qi + 2.0 * u_reg * (ru[:, None] * pu)
            gi = -2.0 * wd[:, None] * pu + 2.0 * i_reg * (ri[:, None] * qi)
            if m is not None:
                gu, gi = gu * m, gi * m
            if side is not None:
                gu, gi = gu * side[0], gi * side[1]
            if s.collision_norm:
                gu = gu * s.inv_nu[sl][:, None]
                gi = gi * s.inv_ni[sl][:, None]
            index_add_ordered_(U, 0, u, (-lr * gu).to(U.dtype), up)
            index_add_ordered_(I, 0, i, (-lr * gi).to(I.dtype), ip)
        if model.use_bias:
            gbu = -2.0 * wd + 2.0 * u_reg * ru * bu_old
            gbi = -2.0 * wd + 2.0 * i_reg * ri * bi_old
            if side is not None:
                gbu, gbi = gbu * side[0][:, 0], gbi * side[1][:, 0]
            if s.collision_norm:
                gbu = gbu * s.inv_nu[sl]
                gbi = gbi * s.inv_ni[sl]
            index_add_ordered_(bu, 0, u, (-lr * gbu).to(bu.dtype), up)
            index_add_ordered_(bi, 0, i, (-lr * gbi).to(bi.dtype), ip)
    return state._replace(u_fac=U, i_fac=I, u_bias=bu, i_bias=bi)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_step_equals_the_eager_step(case):
    """One batch through ``sgd_step_plain``, given the hooks' outputs,
    equals the eager chain's batch on the same tables, bit for bit."""
    s, state = _solver(case)
    lr = 0.05
    model, B = s.model, s.batch_size
    for b in (0, s.n_batches - 1):
        masks = _masks(s, [b]) if case != "tmfdropout_drawn" else None
        gen0 = s._mask_gen.get_state()
        want = _eager_epoch(s, state, lr, [b], masks)
        s._mask_gen.set_state(gen0)
        sl = slice(b * B, (b + 1) * B)
        u, i, r, v = s.rows[sl], s.cols[sl], s.vals[sl], s.valid[sl]
        w = model.example_weight(u, i) * v
        if masks is not None:
            m = masks[0]
        elif getattr(model, "stochastic_rank", False):
            m = model.update_rank_mask(u, i, generator=s._mask_gen)
        else:
            m = model.update_rank_mask(u, i)
        got = tuple(t.clone() for t in state)
        reg = (s.reg_vec[None, :],) * 2 if s.reg_vec is not None else \
            (float(s.params.u_reg), float(s.params.i_reg))
        step_mod.sgd_step_plain(
            *got[:4], u, i, r, v, w, m, model.update_side_masks(u, i),
            s.inv_nu[sl] if s.collision_norm else None,
            s.inv_ni[sl] if s.collision_norm else None, s.reg_scale_u,
            s.reg_scale_i, *reg, lr, model.use_factors, model.use_bias)
        assert _same(got, want)
        moved = got[2] if not model.use_factors else got[0]
        assert not torch.equal(moved, state[2] if not model.use_factors
                               else state[0])


@pytest.mark.parametrize("case", list(CASES))
def test_a_cpu_epoch_goes_through_the_plain_step(case, monkeypatch):
    """``epoch_with`` on CPU tables calls ``sgd_step_plain`` once a batch
    (the kernel route never) and equals the eager epoch bit for bit, the
    drawn masks included."""
    s, state = _solver(case)
    border = s.batch_order()
    masks = _masks(s, border.tolist()) if case != "tmfdropout_drawn" \
        else None
    calls = []
    real = step_mod.sgd_step_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(step_mod, "sgd_step_plain", counted)
    launches = step_mod.SGDStep.launches
    gen0 = s._mask_gen.get_state()
    got = s.epoch_with(state, 0.05, border, masks)
    s._mask_gen.set_state(gen0)
    want = _eager_epoch(s, state, 0.05, border, masks)
    assert len(calls) == s.n_batches
    assert step_mod.SGDStep.launches == launches
    assert _same(got, want)
    assert not _same(got, state)
