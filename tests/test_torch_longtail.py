"""The port's long-tail models (matfac_tpu_torch.models.longtail: IFWMF and
TMF), the JAX ModelMF hooks of its base model, the weighted objective and
the loop's objective weights, against the JAX package."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.eval.metrics import Evaluator as JEvaluator
from matfac_tpu.models import longtail as jlt
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.train.loop import TrainLoop as JTrainLoop
from matfac_tpu.utils import freq
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.models import longtail as tlt
from matfac_tpu_torch.models.base import ModelMF, state_from_numpy
from matfac_tpu_torch.train.loop import TrainLoop


def _data(n_users=50, n_items=40):
    data, _, _ = synthetic_data(n_users=n_users, n_items=n_items, k=3,
                                density=0.3, seed=4, noise=0.05,
                                nonneg=True)
    iu, ii = freq.invalid_users_items(data.train_mat, n_users, n_items)
    uf, if_ = freq.row_col_freq(data.train_mat)
    return data, iu, ii, uf, if_


def _pair(algo, params, data, iu, ii, uf, if_):
    if algo == "ifwmf":
        return tuple(m(params, data.n_users, data.n_items, uf, if_, iu, ii)
                     for m in (jlt.ModelInvPopMF, tlt.ModelInvPopMF))
    if algo == "tmf":
        return tuple(m(params, data.n_users, data.n_items, uf, if_)
                     for m in (jlt.ModelDropoutSigmoid,
                               tlt.ModelDropoutSigmoid))
    return (JModelMF(params, data.n_users, data.n_items),
            ModelMF(params, data.n_users, data.n_items))


@pytest.mark.parametrize("rho,alpha,k", [(1.0, 0.0, 8), (3.0, 0.5, 16),
                                         (0.0, 0.0, 4)])
def test_tmf_rank_tables_match_jax(rho, alpha, k):
    data, iu, ii, uf, if_ = _data()
    p = Params(fac_dim=k, rho_rms=rho, alpha=alpha)
    j, t = _pair("tmf", p, data, iu, ii, uf, if_)
    assert (t.mean_freq, t.std_freq) == (j.mean_freq, j.std_freq)
    for got, want in zip(t.entity_ranks(), j.entity_ranks()):
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(),
                                                           np.asarray(want))
    u = np.arange(data.n_users) % data.n_users
    i = np.arange(data.n_users) % data.n_items
    assert np.array_equal(
        t.pair_rank(torch.from_numpy(u), torch.from_numpy(i)).numpy(),
        np.asarray(j.pair_rank(jnp.asarray(u), jnp.asarray(i))))
    assert np.array_equal(
        t.update_rank_mask(torch.from_numpy(u), torch.from_numpy(i)).numpy(),
        np.asarray(j.update_rank_mask(None, jnp.asarray(u), jnp.asarray(i))))


def test_tmf_refuses_a_negative_rho_like_jax():
    data, iu, ii, uf, if_ = _data()
    p = Params(fac_dim=4, rho_rms=-1.0)
    for cls in (jlt.ModelDropoutSigmoid, tlt.ModelDropoutSigmoid):
        with pytest.raises(ValueError, match="rho_rms >= 0"):
            cls(p, data.n_users, data.n_items, uf, if_)


@pytest.mark.parametrize("with_invalid", [False, True])
def test_ifwmf_weights_match_jax(with_invalid):
    data, iu, ii, uf, if_ = _data()
    if not with_invalid:
        iu, ii = None, None
    p = Params(fac_dim=4, rho_rms=250.0)
    j = jlt.ModelInvPopMF(p, data.n_users, data.n_items, uf, if_, iu, ii)
    t = tlt.ModelInvPopMF(p, data.n_users, data.n_items, uf, if_, iu, ii)
    r, c, _ = data.train_mat.to_coo()
    got = t.example_weight(torch.from_numpy(r), torch.from_numpy(c))
    want = np.asarray(j.example_weight(jnp.asarray(r), jnp.asarray(c)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert 0.0 < float(got.min()) < float(got.max()) <= 1.0


@pytest.mark.parametrize("algo", ["mf", "tmf"])
def test_eval_view_matches_jax(algo):
    """The masked eval view: TMF's entity ranks truncate both factor
    tables; plain MF's view is the raw factors with zero biases."""
    data, iu, ii, uf, if_ = _data()
    p = Params(fac_dim=8, seed=3)
    j, t = _pair(algo, p, data, iu, ii, uf, if_)
    sj = j_init_state(p, data.n_users, data.n_items)
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    for got, want in zip(t.eval_view(st), j.eval_view(sj)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    if algo == "tmf":
        assert not torch.equal(t.eval_view(st).u_fac, st.u_fac)


@pytest.mark.parametrize("algo", ["ifwmf", "tmf", "mf"])
def test_objective_takes_the_jax_weights_argument(algo):
    """Evaluator.objective(view, state, weights) positionally, as JAX's
    TrainLoop calls it: the IFWMF weighted SSE plus the penalty of the raw
    (unmasked) factors, at the loop's obj_weights."""
    data, iu, ii, uf, if_ = _data()
    p = Params(fac_dim=8, seed=3, rho_rms=250.0, u_reg=0.05, i_reg=0.02)
    j, t = _pair(algo, p, data, iu, ii, uf, if_)
    sj = j_init_state(p, data.n_users, data.n_items)
    sj = sj._replace(u_fac=sj.u_fac * 40.0, i_fac=sj.i_fac * 40.0)
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    jev = JEvaluator(data, iu, ii, p)
    tev = Evaluator(data, iu, ii, p, device="cpu")
    jloop = JTrainLoop(j, None, jev, p, log_fn=lambda s: None)
    tloop = TrainLoop(t, None, tev, p, log_fn=lambda s: None)
    assert (tloop.obj_weights is None) == (jloop.obj_weights is None) == \
        (algo != "ifwmf")
    want = jev.objective(j.eval_view(sj), sj, jloop.obj_weights)
    got = tev.objective(t.eval_view(st), st, tloop.obj_weights)
    assert got == pytest.approx(want, rel=1e-5)
    assert tloop._objective(st) == pytest.approx(jloop._objective(sj),
                                                 rel=1e-5)
    if algo == "ifwmf":   # the weights change the value
        plain = tev.objective(t.eval_view(st), st)
        assert plain > got * (1 + 1e-4)


def test_model_mf_has_the_jax_hooks():
    """The hooks the block engine and the long-tail models read:
    frequency arguments, stochastic_rank, entity_ranks, update_side_masks
    and a view masked by entity_ranks."""
    jsig = inspect.signature(JModelMF.__init__).parameters
    tsig = inspect.signature(ModelMF.__init__).parameters
    assert list(tsig) == list(jsig)
    assert all(tsig[n].default == jsig[n].default for n in tsig)
    p = Params(fac_dim=4)
    uf = np.arange(5, dtype=np.int64)
    m = ModelMF(p, 5, 3, user_freq=uf, item_freq=None)
    assert m.user_freq is uf and m.item_freq is None
    assert ModelMF.stochastic_rank is JModelMF.stochastic_rank is False
    assert m.entity_ranks() is None
    idx = torch.arange(3)
    assert m.update_side_masks(idx, idx) is None
    assert torch.equal(m.example_weight(idx, idx), torch.ones(3))

    class Ranked(ModelMF):
        def entity_ranks(self):
            return torch.tensor([1, 2, 3, 4, 0]), torch.tensor([4, 4, 2])

    st = state_from_numpy(np.ones((5, 4), np.float32),
                          np.ones((3, 4), np.float32), np.ones(5, np.float32),
                          np.ones(3, np.float32), np.float32(1.0),
                          device="cpu")
    view = Ranked(p, 5, 3).eval_view(st)
    assert view.u_fac.sum(1).tolist() == [1, 2, 3, 4, 0]
    assert view.i_fac.sum(1).tolist() == [4, 4, 2]
    assert float(view.u_bias.abs().sum() + view.mu.abs()) == 0.0


@pytest.mark.parametrize("k", [1, 4, 8, 16])
def test_poisson_cdf_ranks_and_table_match_jax(k):
    """poisson_cdf_ranks and the CRN quantile table, exactly."""
    assert np.array_equal(tlt.poisson_cdf_ranks(k), jlt.poisson_cdf_ranks(k))
    for cut in (0.5, 0.9):
        assert np.array_equal(tlt.poisson_cdf_ranks(k, cut),
                              jlt.poisson_cdf_ranks(k, cut))
    data, iu, ii, uf, if_ = _data()
    j = jlt.ModelPoissonDropout(Params(fac_dim=k), data.n_users,
                                data.n_items, uf, if_)
    got = tlt.poisson_cdf_table(k)
    assert got.dtype == np.float32 and np.array_equal(got,
                                                      j.poisson_cdf_table())


@pytest.mark.parametrize("rho,alpha,k", [(1.0, 0.0, 8), (3.0, 0.5, 16)])
def test_poisson_dropout_tables_match_jax(rho, alpha, k):
    """TMF+Dropout's lambda tables (TMF's sigmoid ranks), its CDF-truncated
    inference ranks, pair lambdas and its eval view, exactly."""
    data, iu, ii, uf, if_ = _data()
    p = Params(fac_dim=k, rho_rms=rho, alpha=alpha, seed=3)
    j = jlt.ModelPoissonDropout(p, data.n_users, data.n_items, uf, if_)
    t = tlt.ModelPoissonDropout(p, data.n_users, data.n_items, uf, if_)
    assert t.stochastic_rank and t.name == j.name == "tmf_dropout"
    assert np.array_equal(t.cdf_ranks, j.cdf_ranks)
    for got, want in zip(t.entity_lambdas() + t.entity_ranks(),
                         j.entity_lambdas() + j.entity_ranks()):
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(),
                                                           np.asarray(want))
    u = np.arange(data.n_users)
    i = u % data.n_items
    assert np.array_equal(
        t.pair_lambda(torch.from_numpy(u), torch.from_numpy(i)).numpy(),
        np.asarray(j.pair_lambda(jnp.asarray(u), jnp.asarray(i))))
    sj = j_init_state(p, data.n_users, data.n_items)
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    for got, want in zip(t.eval_view(st), j.eval_view(sj)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_poisson_update_masks_are_clipped_poisson_draws():
    """update_rank_mask draws clip(Poisson(pair lambda), 1, k) per example
    from the generator it is given: prefix masks, reproducible from the
    generator's seed, and the clipped-Poisson mean per lambda within 4
    standard errors (the JAX key draws cannot be reproduced by torch)."""
    data, iu, ii, uf, if_ = _data()
    p = Params(fac_dim=8, rho_rms=3.0)
    t = tlt.ModelPoissonDropout(p, data.n_users, data.n_items, uf, if_)
    u = torch.arange(data.n_users).repeat(400)
    i = u % data.n_items
    draw = lambda: t.update_rank_mask(
        u, i, generator=torch.Generator().manual_seed(5))
    m = draw()
    assert torch.equal(m, draw())
    r = m.sum(1)
    assert torch.equal(m, (torch.arange(8) < r[:, None]).float())
    assert int(r.min()) >= 1 and int(r.max()) <= 8
    lam = t.pair_lambda(u, i)
    rng = np.random.default_rng(0)
    for L in torch.unique(lam).tolist():
        x = r[lam == L].numpy()
        ref = np.clip(rng.poisson(L, 200_000), 1, 8)
        se = ref.std() / np.sqrt(len(x)) + 1e-9
        assert abs(x.mean() - ref.mean()) < 4 * se + 1e-3, L


def test_model_mf_bias_and_the_init_hook_match_jax():
    """ModelMFBias: bias-only prediction, ModelMF's hooks (no rank mask, no
    side gates, weight 1), the identity transform_init_state; its eval view
    equals JAX's."""
    from matfac_tpu.models.base import ModelMFBias as JModelMFBias
    from matfac_tpu_torch.models.base import ModelMFBias
    p = Params(fac_dim=4, seed=2)
    j, t = JModelMFBias(p, 7, 5), ModelMFBias(p, 7, 5)
    assert (t.name, t.use_bias, t.use_factors) == (j.name, j.use_bias,
                                                   j.use_factors)
    idx = torch.arange(5)
    assert t.update_rank_mask(idx, idx) is None
    assert t.update_side_masks(idx, idx) is None
    assert torch.equal(t.example_weight(idx, idx), torch.ones(5))
    sj = j_init_state(p, 7, 5)
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    assert t.transform_init_state(st) is st
    assert ModelMF(p, 7, 5).transform_init_state(st) is st
    for got, want in zip(t.eval_view(st), j.eval_view(sj)):
        assert np.array_equal(got.numpy(), np.asarray(want))
