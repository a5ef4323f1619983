"""The port's scatter SGD engine (matfac_tpu_torch.solvers.sgd, the
default ``mf_method``) and its COO staging (data.batching) against the JAX
package: the staged stream and collision counts bit for bit, and epochs
with the JAX engine's batch order and per-step Poisson masks injected."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.batching import coo_batches as j_coo_batches
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.models import base as jbase
from matfac_tpu.models import longtail as jlt
from matfac_tpu.solvers.sgd import SGDSolver as JSGDSolver
from matfac_tpu.utils import freq
from matfac_tpu_torch.data.batching import coo_batches
from matfac_tpu_torch.models import base as tbase
from matfac_tpu_torch.models import longtail as tlt
from matfac_tpu_torch.models.base import state_from_numpy
from matfac_tpu_torch.solvers.sgd import SGDSolver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(n_users=90, n_items=70, seed=5):
    data, _, _ = synthetic_data(n_users=n_users, n_items=n_items, k=3,
                                density=0.3, seed=seed, noise=0.05,
                                nonneg=True, power_law=0.8)
    iu, ii = freq.invalid_users_items(data.train_mat, n_users, n_items)
    uf, if_ = freq.row_col_freq(data.train_mat)
    return data, iu, ii, uf, if_


def _models(algo, p, data, iu, ii, uf, if_):
    n, m = data.n_users, data.n_items
    if algo == "ifwmf":
        return (jlt.ModelInvPopMF(p, n, m, uf, if_, iu, ii),
                tlt.ModelInvPopMF(p, n, m, uf, if_, iu, ii))
    if algo == "tmf":
        return (jlt.ModelDropoutSigmoid(p, n, m, uf, if_),
                tlt.ModelDropoutSigmoid(p, n, m, uf, if_))
    if algo == "tmfdropout":
        return (jlt.ModelPoissonDropout(p, n, m, uf, if_),
                tlt.ModelPoissonDropout(p, n, m, uf, if_))
    if algo == "mf_bias":
        return jbase.ModelMFBias(p, n, m), tbase.ModelMFBias(p, n, m)
    return jbase.ModelMF(p, n, m), tbase.ModelMF(p, n, m)


def jax_draws(solver, jmodel, key):
    """(border, masks) of one JAX epoch from its key, as JAX's SGDSolver
    draws them (solvers/sgd.py:152-237): a batch permutation from the
    first half of split(key), and for a sampled-rank model one Poisson
    mask per step from split(mask_key, n_batches), on that step's batch;
    masks=None for every other model (the port's model gives the same)."""
    k_ord, mask_key = jax.random.split(key)
    border = np.asarray(jax.random.permutation(k_ord, solver.n_batches))
    if not getattr(jmodel, "stochastic_rank", False):
        return border, None
    keys = jax.random.split(mask_key, solver.n_batches)
    B = solver.batch_size
    rows, cols = np.asarray(solver.rows), np.asarray(solver.cols)
    masks = [np.asarray(jmodel.update_rank_mask(
        keys[t], jnp.asarray(rows[b * B:(b + 1) * B].astype(np.int32)),
        jnp.asarray(cols[b * B:(b + 1) * B].astype(np.int32))))
        for t, b in enumerate(border)]
    return border, masks


@pytest.mark.parametrize("multiple_of", [1, 3])
@pytest.mark.parametrize("invalid", [False, True])
@pytest.mark.parametrize("batch_size", [7, 64, 10_000])
def test_coo_batches_match_jax(batch_size, invalid, multiple_of):
    data, iu, ii, _, _ = _data()
    if invalid:
        iu, ii = iu.copy(), ii.copy()
        iu[::7] = True
        ii[::5] = True
    else:
        iu = ii = None
    j = j_coo_batches(data.train_mat, batch_size, iu, ii, multiple_of)
    t = coo_batches(data.train_mat, batch_size, iu, ii, multiple_of)
    for f in ("rows", "cols", "vals", "valid"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (t.n_total, t.n_batches, t.nnz, t.batch_size) == (
        j.n_total, j.n_batches, j.nnz, j.batch_size)


@pytest.mark.parametrize("collision_norm", [False, True])
def test_staged_stream_and_collision_counts_match_jax(collision_norm):
    """The static host shuffle (default_rng(seed).permutation), the
    padded stream and the per-element 1 / collision counts, bit for bit."""
    data, iu, ii, uf, if_ = _data()
    p = Params(fac_dim=4, seed=3, batch_size=64)
    jm, tm = _models("mf", p, data, iu, ii, uf, if_)
    j = JSGDSolver(jm, p, data.train_mat, iu, ii,
                   collision_norm=collision_norm)
    t = SGDSolver(tm, p, data.train_mat, iu, ii,
                  collision_norm=collision_norm, device="cpu")
    assert (t.n_batches, t.batch_size, t.nnz) == (j.n_batches, j.batch_size,
                                                  j.nnz)
    for a, b in ((t.rows, j.rows), (t.cols, j.cols), (t.vals, j.vals),
                 (t.valid, j.valid)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if collision_norm:
        assert np.array_equal(t.inv_nu.numpy(), np.asarray(j.inv_nu))
        assert np.array_equal(t.inv_ni.numpy(), np.asarray(j.inv_ni))
        assert float(t.inv_nu.min()) < 1.0   # collisions do occur
    else:
        assert t.inv_nu is None and t.inv_ni is None


# (algo, collision_norm, extra Params, solver options)
CASES = {
    "mf": ("mf", True, {}, {}),
    "mf_no_cn": ("mf", False, {}, {}),
    "ifwmf": ("ifwmf", True, dict(rho_rms=250.0), {}),
    "tmf": ("tmf", True, dict(rho_rms=3.0), {}),
    "tmf_no_cn": ("tmf", False, dict(rho_rms=3.0), {}),
    "tmfdropout": ("tmfdropout", True, dict(rho_rms=3.0), {}),
    "tmfdropout_no_cn": ("tmfdropout", False, dict(rho_rms=3.0), {}),
    "mf_bias": ("mf_bias", True, {}, {}),
    "mf_bias_no_cn": ("mf_bias", False, {}, {}),
    "reg_scale": ("mf", True, {}, "reg_scale"),
    "reg_scale_bias": ("mf_bias", True, {}, "reg_scale"),
    "reg_vec": ("mf", True, {}, "reg_vec"),
    "bf16": ("mf", True, dict(dtype="bfloat16"), {}),
    "bf16_bias": ("mf_bias", True, dict(dtype="bfloat16"), {}),
}


def _sequential_bf16_scatter(self, dim, index, src):
    """index_add_ as XLA's CPU scatter-add computes it on bf16 tables: one
    element after another, each sum rounded to bf16."""
    for n, row in enumerate(index.tolist()):
        self[row] = (self[row].float() + src[n].float()).to(self.dtype)
    return self


def _run_case(case):
    algo, cn, extra, opt = CASES[case]
    data, iu, ii, uf, if_ = _data()
    p = Params(fac_dim=8, u_reg=0.05, i_reg=0.02, learn_rate=0.05, seed=3,
               batch_size=64, **extra)
    jm, tm = _models(algo, p, data, iu, ii, uf, if_)
    kw = {}
    if opt == "reg_scale":
        rng = np.random.default_rng(1)
        kw = dict(reg_scale_u=rng.uniform(0.5, 2.0, data.n_users),
                  reg_scale_i=rng.uniform(0.5, 2.0, data.n_items))
    elif opt == "reg_vec":
        kw = dict(reg_vec=np.linspace(0.01, 0.1, 8))
    j = JSGDSolver(jm, p, data.train_mat, iu, ii, collision_norm=cn, **kw)
    t = SGDSolver(tm, p, data.train_mat, iu, ii, collision_norm=cn,
                  device="cpu", **kw)
    sj = jbase.init_state(p, data.n_users, data.n_items, seed=4)
    # through f32 (numpy has no bfloat16): exact for bf16 tables
    st = state_from_numpy(*(np.asarray(a, np.float32) for a in sj),
                          device="cpu")
    st = st._replace(**{f: getattr(st, f).to(getattr(torch, p.dtype))
                        for f in st._fields})
    key = jax.random.PRNGKey(9)
    for _ in range(2):
        key, ek = jax.random.split(key)
        border, masks = jax_draws(j, jm, ek)
        sj = j.epoch(sj, p.learn_rate, ek)
        st = t.epoch_with(st, p.learn_rate, border, masks)
    moved = st.u_bias if algo == "mf_bias" else st.u_fac
    start = jbase.init_state(p, data.n_users, data.n_items, seed=4)
    assert not np.allclose(moved.float().numpy(),
                           np.asarray(start.u_bias if algo == "mf_bias"
                                      else start.u_fac, np.float32))
    for got, want in zip(st, sj):
        assert str(got.dtype) == f"torch.{want.dtype}"
    return [(got.float().numpy(), np.asarray(want, np.float32), name)
            for got, want, name in zip(st, sj, st._fields)]


@pytest.mark.parametrize("case", list(CASES))
def test_epochs_match_jax_with_its_draws(case, monkeypatch):
    """Two epochs through epoch_with, fed the JAX engine's batch order and
    per-step masks: factors and biases at rtol 1e-5 / atol 1e-6 (f32 sums
    over k and colliding scatters in another order). bf16 tables stay
    bf16; with XLA's scatter order (each add rounded to bf16 in element
    order) they equal JAX's bit for bit, and with index_add_'s own they
    stay within two bf16 ulps of the table's largest value (the roundings
    of colliding adds differ, nothing else)."""
    if CASES[case][2].get("dtype") != "bfloat16":
        for got, want, name in _run_case(case):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        return
    for got, want, name in _run_case(case):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max() + 1e-30)) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp,
                                   err_msg=name)
    monkeypatch.setattr(torch.Tensor, "index_add_", _sequential_bf16_scatter)
    for got, want, name in _run_case(case):
        assert np.array_equal(got, want), name


def test_epoch_draws_from_its_generators_and_leaves_the_state():
    """epoch() draws the batch order (and TMF+Dropout's masks) from the
    solver's generators: the same draws after set_internal_state, a new
    state returned and the given one untouched; reg_vec refuses bias
    models as in JAX."""
    data, iu, ii, uf, if_ = _data()
    p = Params(fac_dim=8, seed=3, batch_size=64, rho_rms=3.0)
    _, tm = _models("tmfdropout", p, data, iu, ii, uf, if_)
    a = SGDSolver(tm, p, data.train_mat, iu, ii, device="cpu")
    b = SGDSolver(tm, p, data.train_mat, iu, ii, device="cpu")
    st = tbase.init_state(p, data.n_users, data.n_items, device="cpu")
    before = st.u_fac.clone()
    a.epoch(st, 0.05)
    b.set_internal_state(a.internal_state())
    x, y = a.epoch(st, 0.05), b.epoch(st, 0.05)
    assert torch.equal(st.u_fac, before)
    assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert not torch.equal(x.u_fac, a.epoch(st, 0.05).u_fac)
    for cls, model in ((JSGDSolver, jbase.ModelMFBias(p, 90, 70)),
                       (SGDSolver, tbase.ModelMFBias(p, 90, 70))):
        with pytest.raises(ValueError, match="factor-only"):
            cls(model, p, data.train_mat, iu, ii, reg_vec=np.ones(8),
                **({"device": "cpu"} if cls is SGDSolver else {}))
