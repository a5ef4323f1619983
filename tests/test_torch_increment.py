"""The port's incremental-rank MF (matfac_tpu_torch.models.increment)
against the JAX package: one epoch and the probe RMSE on the same inputs,
and train_increment / train_model(algo="increment") from JAX's initial
state with JAX's per-epoch batch permutations injected through ``order=``:
the same rank tables and growth history, factors within 1e-5."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.batching import coo_batches
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.models import increment as jinc
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.train.loop import train_model as j_train_model
from matfac_tpu.utils import freq
from matfac_tpu_torch.models import increment as tinc
from matfac_tpu_torch.models.base import state_from_numpy
from matfac_tpu_torch.train import loop as tloop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(k=8, lr=0.02, max_iter=12):
    """The JAX othersrc tests' data with the val split as the probe set."""
    data, _, _ = synthetic_data(n_users=80, n_items=60, k=3, density=0.3,
                                seed=4, noise=0.05, power_law=0.8,
                                nonneg=True)
    data.graph_mat = data.val_mat
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    p = Params(fac_dim=k, u_reg=0.01, i_reg=0.01, learn_rate=lr,
               max_iter=max_iter, seed=2, batch_size=128)
    return data, p, iu, ii


def _jax_orders(data, p, iu, ii):
    """order(epoch) -> the batch permutation JAX's epoch draws: the key
    chain PRNGKey(seed), one split an epoch, permutation(ek, n_batches)."""
    n_batches = coo_batches(data.train_mat, p.batch_size, iu, ii).n_batches
    key, borders = jax.random.PRNGKey(p.seed), []
    for _ in range(p.max_iter):
        key, ek = jax.random.split(key)
        borders.append(np.asarray(jax.random.permutation(ek, n_batches)))
    return lambda it: borders[it]


def _jax_init(monkeypatch, p, data):
    """Start the port from the JAX package's initial state."""
    js = j_init_state(p, data.n_users, data.n_items)
    monkeypatch.setattr(
        tinc, "init_state", lambda params, n, m, device: state_from_numpy(
            *(np.asarray(a) for a in js), device=device))


def _ranked_state(p, n, m, seed):
    rng = np.random.default_rng(seed)
    js = j_init_state(p, n, m, seed=seed)
    ru = rng.integers(1, p.fac_dim + 1, n).astype(np.int32)
    ri = rng.integers(1, p.fac_dim + 1, m).astype(np.int32)
    return js, ru, ri


def test_epoch_matches_jax():
    """One epoch at random rank tables and one batch order: JAX's scan and
    the port's loop give the same factors (rtol 1e-5 / atol 1e-6)."""
    data, p, iu, ii = _data()
    b = coo_batches(data.train_mat, p.batch_size, iu, ii)
    sperm = np.random.default_rng(p.seed).permutation(b.n_total)
    arrs = [a[sperm] for a in (b.rows, b.cols, b.vals, b.valid)]
    js, ru, ri = _ranked_state(p, data.n_users, data.n_items, 5)
    st = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    key = jax.random.PRNGKey(7)
    border = np.asarray(jax.random.permutation(key, b.n_batches))
    want = jinc._build_epoch(b.n_total, b.n_batches, b.batch_size,
                             p.u_reg, p.i_reg, p.fac_dim)(
        js, *(jnp.asarray(a) for a in arrs), jnp.asarray(ru),
        jnp.asarray(ri), jnp.float32(p.learn_rate), key)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = tinc.increment_epoch(
        st, t(arrs[0].astype(np.int64)), t(arrs[1].astype(np.int64)),
        t(arrs[2]), t(arrs[3]), t(ru).long(), t(ri).long(), p.learn_rate,
        p.u_reg, p.i_reg, b.batch_size, border)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert not np.allclose(got.u_fac.numpy(), st.u_fac.numpy())


def test_probe_rmse_matches_jax():
    """Per-entity probe RMSE at the pair ranks, -1 where an entity has no
    probe entry (both sides have some here)."""
    data, p, iu, ii = _data()
    r, c, v = data.val_mat.to_coo()
    js, ru, ri = _ranked_state(p, data.n_users, data.n_items, 6)
    want = jinc._build_probe_rmse(data.n_users, data.n_items, p.fac_dim)(
        js, jnp.asarray(r.astype(np.int32)), jnp.asarray(c.astype(np.int32)),
        jnp.asarray(v), jnp.ones(len(r), jnp.float32), jnp.asarray(ru),
        jnp.asarray(ri))
    st = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = tinc.probe_rmse(st, t(r.astype(np.int64)), t(c.astype(np.int64)),
                          t(v), t(ru).long(), t(ri).long(), data.n_users,
                          data.n_items)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert (w < 0).any() and (w > 0).any()
        np.testing.assert_array_equal(g.numpy() < 0, w < 0)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,lr,max_iter", [(8, 0.02, 12), (16, 0.01, 16),
                                           (3, 0.02, 11)])
def test_train_increment_matches_jax(k, lr, max_iter, monkeypatch):
    """train_increment from JAX's initial state with JAX's permutations:
    the rank tables and the growth history equal, the factors within
    1e-5, and the growth checks both grew and froze entities."""
    data, p, iu, ii = _data(k, lr, max_iter)
    _jax_init(monkeypatch, p, data)
    logs_j, logs_t = [], []
    rep_j, model_j = jinc.train_increment(data, p, iu, ii,
                                          log_fn=logs_j.append)
    rep_t, model_t = tinc.train_increment(
        data, p, iu, ii, log_fn=logs_t.append, device="cpu",
        order=_jax_orders(data, p, iu, ii))
    assert rep_t.history == rep_j.history
    assert logs_t == logs_j
    assert len(rep_t.history) == (max_iter - 1) // tinc.INC_ITER
    for got, want in ((rep_t.rank_u, rep_j.rank_u),
                      (rep_t.rank_i, rep_j.rank_i),
                      (model_t.rank_u.numpy(), model_j.rank_u),
                      (model_t.rank_i.numpy(), model_j.rank_i)):
        np.testing.assert_array_equal(got, np.asarray(want))
    ranks = np.concatenate([rep_t.rank_u, rep_t.rank_i])
    assert sum(h[1] + h[2] for h in rep_t.history) > 0
    assert len(np.unique(ranks)) > 1
    for got, want in zip(rep_t.state[:2], rep_j.state[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    for got, want in zip(model_t.eval_view(rep_t.state)[:2],
                         model_j.eval_view(rep_j.state)[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_train_model_increment_matches_jax(monkeypatch):
    """train_model(algo="increment") as JAX's front door reports it: the
    final state as best, val RMSE, epoch max_iter - 1, "max_iter", no
    history, and ``.increment`` carrying the rank tables and growth."""
    data, p, iu, ii = _data()
    _jax_init(monkeypatch, p, data)
    monkeypatch.setattr(tloop, "train_increment", functools.partial(
        tinc.train_increment, order=_jax_orders(data, p, iu, ii)))
    rep_j, model_j, *_ = j_train_model(data, p, algo="increment",
                                       log_fn=lambda s: None)
    rep_t, model_t, ev, _ = tloop.train_model(data, p, algo="increment",
                                              device="cpu",
                                              log_fn=lambda s: None)
    assert model_t.name == model_j.name == "increment"
    assert (rep_t.best_iter, rep_t.stop_reason, rep_t.history) == \
        (rep_j.best_iter, rep_j.stop_reason, rep_j.history) == \
        (p.max_iter - 1, "max_iter", [])
    np.testing.assert_allclose(rep_t.best_metric, rep_j.best_metric,
                               rtol=1e-5)
    assert rep_t.best_metric == ev.rmse(model_t.eval_view(rep_t.state),
                                        "val")
    assert rep_t.increment.history == rep_j.increment.history
    np.testing.assert_array_equal(rep_t.increment.rank_u,
                                  rep_j.increment.rank_u)
    np.testing.assert_array_equal(rep_t.increment.rank_i,
                                  rep_j.increment.rank_i)


def test_default_order_is_seeded():
    """Without ``order`` the batch orders come from a generator seeded
    with params.seed: two runs are identical, another seed differs."""
    data, p, iu, ii = _data(max_iter=6)
    run = lambda q: tinc.train_increment(data, q, iu, ii,
                                         log_fn=lambda s: None,
                                         device="cpu")[0].state.u_fac
    assert torch.equal(run(p), run(p))
    assert not torch.equal(run(p), run(p.replace(seed=3)))
