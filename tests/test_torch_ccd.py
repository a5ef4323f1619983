"""The port's CCD / CCD++ (matfac_tpu_torch.solvers.ccd) against the JAX
package's on the CPU: the same seeded inputs, at JAX's own fixtures
(tests/test_solvers.py's ``setup_reg`` and ``setup``), with JAX's draws
(each epoch's permutation of the dims) injected through ``epoch_with``.
Tolerance 2e-3 after three epochs: JAX's own engine-to-engine class
(tests/test_solvers.py:452), the sums taken in another order and
precision (the port reduces each segment in float64)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params as JParams
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.solvers import ccd as jccd
from matfac_tpu.utils import freq as jfreq
from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import ModelMF, state_from_numpy
from matfac_tpu_torch.solvers import ccd

NOISE = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    """JAX's ``setup`` data (tests/test_solvers.py:26-36)."""
    data, _, _ = synthetic_data(n_users=150, n_items=100, k=4, density=0.3,
                                seed=9, noise=NOISE)
    iu, ii = jfreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    return data, iu, ii


def _pair(data, **kw):
    """JAX's ``setup_reg`` Params (reg 0.05, tests/test_solvers.py:119-128)
    unless overridden: (JAX Params, port Params, JAX model, port model)."""
    kw = dict(dict(fac_dim=4, u_reg=0.05, i_reg=0.05, seed=5), **kw)
    jp, tp = JParams(**kw), Params(**kw)
    return (jp, tp, JModelMF(jp, data.n_users, data.n_items),
            ModelMF(tp, data.n_users, data.n_items))


def _states(jp, data, seed=0):
    js = j_init_state(jp, data.n_users, data.n_items, seed=seed)
    return js, state_from_numpy(*(np.asarray(a) for a in js), device="cpu")


def jax_draws(solver, key):
    """The draws JAX's epoch makes from its key: CCD++ one permutation of
    the dims (ccd.py:634), CCD one for the user and one for the item sweep
    from the key's split (ccd.py:759, :852-855)."""
    k = solver.model.k
    if isinstance(solver, ccd.CCDSolver):
        k_u, k_i = jax.random.split(key)
        return (np.asarray(jax.random.permutation(k_u, k)),
                np.asarray(jax.random.permutation(k_i, k)))
    return np.asarray(jax.random.permutation(key, k))


def run_both(js_, ts_, js, ts, n, seed=3):
    key = jax.random.PRNGKey(seed)
    for _ in range(n):
        key, ek = jax.random.split(key)
        js = js_.epoch(js, 0.0, ek)
        ts = ts_.epoch_with(ts, 0.0, jax_draws(ts_, ek))
    return js, ts


def _close(ts, js, rtol, atol):
    np.testing.assert_allclose(ts.u_fac.numpy(), np.asarray(js.u_fac),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(ts.i_fac.numpy(), np.asarray(js.i_fac),
                               rtol=rtol, atol=atol)


def _real(res, n):
    """The first n entries of a staged residual (JAX pads with zeros)."""
    return np.asarray(res)[:n]


# ----------------------------------------------------------------------
# the segment sums
# ----------------------------------------------------------------------

def test_segment_sums_match_a_float64_oracle_and_jax():
    """JAX's case (tests/test_solvers.py:480-495): 64k entries in 37 sorted
    segments of values around 3, prefixes up to ~2e5; the port's sums hold
    the float64 oracle at atol 5e-3 (as JAX's compensated scan does), and
    JAX's at the same tolerance."""
    rng = np.random.default_rng(0)
    n, n_seg, block = 64 * 1024, 37, 1024
    seg = np.sort(rng.integers(0, n_seg, n))
    x = rng.normal(3.0, 1.0, (n, 2)).astype(np.float32)
    bounds = np.searchsorted(seg, np.arange(n_seg + 1))
    xt = torch.from_numpy(x)
    got = ccd.segment_sums((xt[:, 0], xt[:, 1]), torch.from_numpy(bounds))
    assert got.dtype == torch.float32 and got.shape == (n_seg, 2)
    want = np.zeros((n_seg, 2))
    np.add.at(want, seg, x.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    j = np.asarray(jccd._sorted_segment_sum2(
        jnp.asarray(x), jnp.asarray(bounds.astype(np.int32)), block))
    np.testing.assert_allclose(got.numpy(), j, atol=5e-3)
    # one rounding of the float64 sum
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_segment_sums_keep_empty_segments_zero():
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    got = ccd.segment_sums((x[:, 0], x[:, 1]),
                           torch.tensor([0, 2, 2, 6, 6]))
    assert got.tolist() == [[2.0, 4.0], [0.0, 0.0], [28.0, 32.0],
                            [0.0, 0.0]]


def test_chol_solve_unrolled_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(50, 3, 3)).astype(np.float32)
    G = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    want = np.asarray(jccd._chol_solve_unrolled(jnp.asarray(G),
                                                jnp.asarray(b)))
    got = ccd._chol_solve_unrolled(torch.from_numpy(G), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.linalg.solve(G, b[:, :, None])[:, :, 0], rtol=1e-3,
        atol=1e-4)


# ----------------------------------------------------------------------
# CCDPPSolver / CCDSolver against JAX
# ----------------------------------------------------------------------

CASES = {
    "sorted": dict(engine="sorted"),
    "scatter": dict(engine="scatter"),
    "g2": dict(group_dims=2),
    "g4": dict(group_dims=4),
    "freqadap": dict(freq_adaptive=True),
    "freqadap_g2": dict(freq_adaptive=True, group_dims=2),
    "inner2": dict(n_inner=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ccdpp_matches_jax(setup, case):
    """Both of JAX's engines, rank-g sweeps (g = 2, 4), the freq-adaptive
    truncation (threshold at the median item frequency; rank-1 and
    g = 2), two inner alternations: three epochs with JAX's dims at 2e-3,
    and the carried residual too."""
    data, iu, ii = setup
    jp, tp, jm, tm = _pair(data)
    kw = dict(CASES[case])
    if kw.get("freq_adaptive"):
        freq = np.resize(data.train_mat.col_degrees().astype(np.float64),
                         data.n_items)
        kw.update(freq_thresh=float(np.median(freq)), item_freq=freq)
    js_ = jccd.CCDPPSolver(jm, jp, data.train_mat, iu, ii, **kw)
    ts_ = ccd.CCDPPSolver(tm, tp, data.train_mat, iu, ii, device="cpu",
                          **kw)
    js, ts = run_both(js_, ts_, *_states(jp, data), 3)
    _close(ts, js, 2e-3, 2e-3)
    n = ts_.vals.shape[0]
    np.testing.assert_allclose(ts_.res.numpy(), _real(js_.res, n),
                               rtol=2e-3, atol=2e-3)
    if kw.get("freq_adaptive"):
        rare = (kw["item_freq"] < kw["freq_thresh"]) & ~ii
        assert rare.any()
        assert (ts.i_fac[torch.from_numpy(rare)][:, 1:] == 0).all()
        assert ts.i_fac[torch.from_numpy(rare)][:, 0].abs().max() > 0


def test_ccd_matches_jax(setup):
    """Per-entity CCD (JAX's default engine "scatter"; and "sorted"): the
    user sweep, then the item sweep, each with its own JAX permutation;
    three epochs at 2e-3."""
    data, iu, ii = setup
    jp, tp, jm, tm = _pair(data)
    for engine in ("scatter", "sorted"):
        js_ = jccd.CCDSolver(jm, jp, data.train_mat, iu, ii, engine=engine)
        ts_ = ccd.CCDSolver(tm, tp, data.train_mat, iu, ii, engine=engine,
                            device="cpu")
        assert ts_.n_inner == 1 and ts_.engine == engine
        js, ts = run_both(js_, ts_, *_states(jp, data), 3)
        _close(ts, js, 2e-3, 2e-3)
        np.testing.assert_allclose(
            ts_.res.numpy(), _real(js_.res, ts_.vals.shape[0]), rtol=2e-3,
            atol=2e-3)
    assert ccd.CCDSolver(tm, tp, data.train_mat, iu, ii,
                         device="cpu").engine == "scatter"


@pytest.mark.parametrize("solver", ["ccdpp", "ccdpp_g2", "ccd"])
def test_residual_stays_ratings_minus_predictions(setup, solver):
    """The invariant the reference keeps in its two CSR views
    (modelMF.cpp:1094-1116): after two epochs res = r - <u, v> on every
    staged entry (tests/test_solvers.py:140's check)."""
    data, iu, ii = setup
    jp, tp, jm, tm = _pair(data)
    cls, kw = {"ccdpp": (ccd.CCDPPSolver, {}),
               "ccdpp_g2": (ccd.CCDPPSolver, dict(group_dims=2)),
               "ccd": (ccd.CCDSolver, {})}[solver]
    s = cls(tm, tp, data.train_mat, iu, ii, device="cpu", **kw)
    _, st = _states(jp, data)
    for _ in range(2):
        st = s.epoch(st, 0.0)
    want = s.vals - (st.u_fac[s.rows] * st.i_fac[s.cols]).sum(dim=1)
    np.testing.assert_allclose(s.res.numpy(), want.numpy(), atol=5e-4)


def test_first_epoch_zeroes_u_and_starts_from_the_ratings(setup):
    """At the first epoch u = 0 and res = the ratings (ccd.py:650-656);
    the state given is left as it was."""
    data, iu, ii = setup
    jp, tp, jm, tm = _pair(data)
    s = ccd.CCDPPSolver(tm, tp, data.train_mat, iu, ii, device="cpu")
    _, st = _states(jp, data)
    before = st.u_fac.clone()
    calls = []
    orig = s._dim_sweep
    s._dim_sweep = lambda u, i, res, kk: (calls.append(
        (u.abs().max().item(), torch.equal(res, s.vals))) or
        orig(u, i, res, kk))
    s.epoch_with(st, 0.0, [2, 0, 1, 3])
    assert calls[0] == (0.0, True)
    assert torch.equal(st.u_fac, before)
    assert s.internal_state().keys() == {"gen", "res"}


def test_guards_match_jax(setup):
    data, iu, ii = setup
    jp, tp, jm, tm = _pair(data)
    for mod, m, p, kw in ((jccd, jm, jp, {}),
                          (ccd, tm, tp, dict(device="cpu"))):
        with pytest.raises(ValueError, match="needs engine='sorted'"):
            mod.CCDPPSolver(m, p, data.train_mat, iu, ii, engine="scatter",
                            group_dims=2, **kw)
        with pytest.raises(ValueError, match="not divisible"):
            mod.CCDPPSolver(m, p, data.train_mat, iu, ii, group_dims=3,
                            **kw)


# ----------------------------------------------------------------------
# resume
# ----------------------------------------------------------------------

def test_set_internal_state_loads_a_jax_padded_residual(setup):
    """JAX's sorted engine stages its residual padded with zeros to a
    multiple of ``seg_block``: after one JAX epoch, its residual (and
    tables) loaded into the port continue like JAX's second epoch; a
    residual longer or shorter than the port's staged length is cropped
    or padded."""
    data, iu, ii = setup
    jp, tp, jm, tm = _pair(data)
    js_ = jccd.CCDPPSolver(jm, jp, data.train_mat, iu, ii)
    ts_ = ccd.CCDPPSolver(tm, tp, data.train_mat, iu, ii, device="cpu")
    n = ts_.vals.shape[0]
    js, _ = _states(jp, data)
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    js = js_.epoch(js, 0.0, k1)
    jres = np.asarray(js_.internal_state()["res"])
    assert len(jres) > n and len(jres) % 4096 == 0
    assert not jres[n:].any()
    ts_.set_internal_state({"res": jres})
    assert ts_.res.shape == (n,) and ts_._initialized
    ts = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    js = js_.epoch(js, 0.0, k2)
    ts = ts_.epoch_with(ts, 0.0, jax_draws(ts_, k2))
    _close(ts, js, 1e-4, 1e-5)
    ts_.set_internal_state({"res": jres[: n - 3]})
    assert ts_.res.shape == (n,) and not ts_.res[n - 3:].any()


def test_ccdpp_resume_is_bit_exact(tmp_path):
    """train_model(mf_method="ccd++") stopped at epoch 3 and resumed to 6
    equals the uninterrupted run bit for bit on the CPU: the residual and
    the dims' generator are in the loop checkpoint."""
    from matfac_tpu_torch.train.loop import train_model
    data, _, _ = synthetic_data(n_users=100, n_items=80, k=3, density=0.3,
                                seed=3, noise=0.05, nonneg=True)
    p = Params(fac_dim=4, u_reg=0.05, i_reg=0.05, max_iter=6, seed=1,
               disp_iter=1000, save_iter=1, ccd_group_dims=2)
    run = lambda prefix, params, resume: train_model(
        data, params, mf_method="ccd++", device="cpu",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=3), False)
    res = run("part", p, True)
    assert all(torch.equal(a, b) for a, b in zip(full.state, res.state))
    assert torch.equal(full.solver.res, res.solver.res)
    assert full.best_metric == res.best_metric
