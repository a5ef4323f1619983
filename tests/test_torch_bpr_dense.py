"""The port's dense-stripe BPR engine (matfac_tpu_torch.solvers.bpr_dense,
``bpr_engine="dense"``) against the JAX package's DenseBPRSolver: the
staged arrays bit for bit, epochs with JAX's draws injected (row_of and the
negatives, or the panel tiles) at JAX's own replica tolerance atol 2e-5 /
rtol 2e-4 (tests/test_bpr_dense.py: bf16 score operands, f32 sums in
another order, the -60 fold's rounding), the loss at rtol 1e-5 and the
inversions exactly; and train_model(algo="bpr", bpr_engine="dense") against
JAX's front door on the JAX key chain's draws."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import leave_one_out_data
from matfac_tpu.models.base import MFState as JState
from matfac_tpu.models.bpr import ModelMFBPR as JModelMFBPR
from matfac_tpu.solvers.bpr_dense import DenseBPRSolver as JDense
from matfac_tpu.train.loop import train_model as j_train_model
from matfac_tpu.utils import freq
from matfac_tpu_torch.models.base import state_from_numpy
from matfac_tpu_torch.models.bpr import ModelBPRPoissonDropout, ModelMFBPR
from matfac_tpu_torch.solvers.bpr import BPRSolver
from matfac_tpu_torch.solvers.bpr_dense import DenseBPRSolver
from matfac_tpu_torch.train.loop import train_model

ATOL, RTOL = 2e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lo_data():
    """JAX's dense-engine fixture, with explicit zeros (not positives) and
    never-rated items, so the mask carries every kind of column."""
    data = leave_one_out_data(n_users=80, n_items=50, per_user=14, seed=6,
                              structured=True)
    data.train_mat.values[::5] = 0.0
    return data


def _params(**kw):
    base = dict(fac_dim=8, u_reg=0.01, i_reg=0.01, seed=3)
    base.update(kw)
    return Params(**base)


def _pair(data, p, **kw):
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    js = JDense(JModelMFBPR(p, data.n_users, data.n_items), p,
                data.train_mat, iu, ii, **kw)
    ts = DenseBPRSolver(ModelMFBPR(p, data.n_users, data.n_items), p,
                        data.train_mat, iu, ii, device="cpu", **kw)
    return js, ts


def jax_draws(js, key):
    """(row_of, js | tiles) the JAX epoch draws from ``key``
    (``k_ord, k_neg = split(key)``)."""
    k_ord, k_neg = jax.random.split(key)
    row_of = jax.random.permutation(k_ord, jnp.arange(js.NU,
                                                      dtype=jnp.int32))
    if js.panel_q is not None:
        d = jax.random.randint(k_neg, (js.NU, js.nb), 0,
                               js.ni_pad // js.panel_q, dtype=jnp.int32)
    else:
        d = jax.random.randint(k_neg, (js.NU, js.n_negs, js.S), 0,
                               js.n_items_real, dtype=jnp.int32)
    as_t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    return as_t(row_of), as_t(d)


def _start(data, k, seed=4, scale=0.1):
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.normal(0, scale, (data.n_users, k)),
        rng.normal(0, scale, (data.n_items, k)),
        np.zeros(data.n_users), np.zeros(data.n_items), np.asarray(0.0)))


@pytest.mark.parametrize("kw", [dict(bu=32), dict(bu=256),
                                dict(bu=32, panel_q=8),
                                dict(panel_q=16)])
def test_staged_arrays_match_jax(lo_data, kw):
    """The user relabel, positive slots, occurrence counts and the int8
    stripe mask, bit for bit."""
    js, ts = _pair(lo_data, _params(), **kw)
    for f in ("ni_pad", "bu", "NU", "n_users_pad", "S", "nb", "n_pos",
              "pad_frac", "n_items_real"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.u_perm, js.u_perm)
    for f in ("u_perm_dev", "u_perm_inv_dev", "u_locs", "ipos", "wpos",
              "cnt_u", "cnt_i", "cnt_neg", "W_rows"):
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        np.testing.assert_array_equal(got, want, err_msg=f)
    if ts.panel_q is None:
        assert ts.cnt_ip is None and js.cnt_ip is None
    else:
        np.testing.assert_array_equal(ts.cnt_ip.numpy(),
                                      np.asarray(js.cnt_ip))
    assert ts.W_rows.dtype == torch.int8
    # every kind of column: rated, never-rated items, padding
    assert 0 < float(ts.W_rows.float().mean()) < 1


@pytest.mark.parametrize("cn", [False, True])
@pytest.mark.parametrize("kw", [dict(n_negs=1), dict(n_negs=2),
                                dict(panel_q=8)])
def test_epoch_matches_jax_with_its_draws(lo_data, kw, cn):
    """Two epochs, each fed the JAX epoch's draws; the second starts from
    the views the first handed back (the resident tables)."""
    p = _params()
    js, ts = _pair(lo_data, p, bu=32, collision_norm=cn, **kw)
    leaves = _start(lo_data, p.fac_dim)
    jst = JState(*(jnp.asarray(a) for a in leaves))
    tst = state_from_numpy(*leaves, device="cpu")
    lr = 0.5 if cn else 0.05
    for key in (jax.random.PRNGKey(11), jax.random.PRNGKey(12)):
        jst = js.epoch(jst, lr, key)
        tst = ts.epoch_with(tst, lr, *jax_draws(js, key))
        assert float(ts.last_loss) == pytest.approx(float(js.last_loss),
                                                    rel=1e-5)
        assert int(ts.last_inversions) == int(js.last_inversions) > 0
    for got, want in ((tst.u_fac, jst.u_fac), (tst.i_fac, jst.i_fac)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    assert np.abs(tst.u_fac.numpy() - leaves[0]).max() > 100 * ATOL
    assert ts._resident is not None and tst.u_fac is ts._last_u_view


def test_rated_negatives_self_cancel(lo_data):
    """Every column marked rated: each pair's coefficient is ~sigmoid(-60)
    ~ 9e-27, so only the regularization moves the factors: every entry
    shrinks toward zero (by at most half here), as JAX's test of the same
    fold expects; and the same epoch as JAX's."""
    p = _params()
    js, ts = _pair(lo_data, p, bu=32)
    js.W_rows = jnp.ones_like(js.W_rows)
    ts.W_rows = torch.ones_like(ts.W_rows)
    leaves = _start(lo_data, p.fac_dim, scale=0.01)
    key = jax.random.PRNGKey(0)
    jout = js.epoch(JState(*(jnp.asarray(a) for a in leaves)), 0.1, key)
    out = ts.epoch_with(state_from_numpy(*leaves, device="cpu"), 0.1,
                        *jax_draws(js, key))
    for new, old in ((out.u_fac.numpy(), leaves[0]),
                     (out.i_fac.numpy(), leaves[1])):
        assert (new * old >= 0).all()
        assert (np.abs(new) <= np.abs(old)).all()
        assert (np.abs(new) >= 0.5 * np.abs(old)).all()
        assert (np.abs(new) < np.abs(old)).any()
    np.testing.assert_allclose(out.u_fac.numpy(), np.asarray(jout.u_fac),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.i_fac.numpy(), np.asarray(jout.i_fac),
                               rtol=RTOL, atol=ATOL)


def test_draws_have_jax_shapes_and_ranges(lo_data):
    """The solver's own draws: a stripe permutation, negatives over the real
    catalog (not the padded one), tiles over the padded one; reproducible
    from the generator's state."""
    js, ts = _pair(lo_data, _params(), bu=32, n_negs=3)
    state = ts.internal_state()
    row_of, j = ts.draw()
    assert sorted(row_of.tolist()) == list(range(ts.NU))
    assert tuple(j.shape) == (ts.NU, 3, ts.S)
    assert int(j.min()) >= 0 and int(j.max()) < lo_data.n_items
    ts.set_internal_state(state)
    again = ts.draw()
    assert torch.equal(again[0], row_of) and torch.equal(again[1], j)
    _, tp = _pair(lo_data, _params(), bu=32, panel_q=8)
    _, tiles = tp.draw()
    assert tuple(tiles.shape) == (tp.NU, tp.nb)
    assert int(tiles.max()) < tp.ni_pad // 8


def test_guards_match_jax(lo_data):
    """A rank-masked model, a mask over budget and a panel width that does
    not divide the padded catalog raise ValueError, as in JAX."""
    p = _params(rho_rms=1.0, alpha=0.0)
    iu, ii = freq.invalid_users_items(lo_data.train_mat, lo_data.n_users,
                                      lo_data.n_items)
    uf = lo_data.train_mat.row_degrees().astype(np.float32)
    itf = np.pad(lo_data.train_mat.col_degrees().astype(np.float32),
                 (0, lo_data.n_items))[: lo_data.n_items]
    for sample in (True, False):
        hybrid = ModelBPRPoissonDropout(p, lo_data.n_users, lo_data.n_items,
                                        uf, itf, sample_poisson=sample)
        with pytest.raises(ValueError, match="rank masks"):
            DenseBPRSolver(hybrid, p, lo_data.train_mat, iu, ii, bu=32,
                           device="cpu")
    model = ModelMFBPR(p, lo_data.n_users, lo_data.n_items)
    with pytest.raises(ValueError, match="budget"):
        DenseBPRSolver(model, p, lo_data.train_mat, iu, ii, bu=32,
                       dense_budget_bytes=1000, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        DenseBPRSolver(model, p, lo_data.train_mat, iu, ii, panel_q=48,
                       device="cpu")


def test_views_do_not_alias_the_resident_tables(lo_data):
    """A state handed back stays as it was after the next epoch updates the
    resident tables in place; a foreign state is staged afresh and left
    untouched."""
    p = _params()
    _, ts = _pair(lo_data, p, bu=32)
    leaves = _start(lo_data, p.fac_dim)
    s0 = state_from_numpy(*leaves, device="cpu")
    s1 = ts.epoch(s0, 0.05)
    assert np.array_equal(s0.u_fac.numpy(), leaves[0])
    assert np.array_equal(s0.i_fac.numpy(), leaves[1])
    keep = [t.clone() for t in s1[:2]]
    ts.epoch(s1, 0.05)
    assert torch.equal(keep[0], s1.u_fac) and torch.equal(keep[1], s1.i_fac)


# ----------------------------------------------------------------------
# the front door
# ----------------------------------------------------------------------

def _jax_loop_draw(self):
    """Stand-in for DenseBPRSolver.draw: TrainLoopHR's key chain
    (PRNGKey(seed), one split an epoch) into the JAX epoch's draws."""
    if not hasattr(self, "_jkey"):
        self._jkey = jax.random.PRNGKey(self.params.seed)
    self._jkey, ek = jax.random.split(self._jkey)
    return jax_draws(self, ek)


def _front_params(**kw):
    base = dict(fac_dim=8, u_reg=0.001, i_reg=0.001, learn_rate=0.3,
                max_iter=10, seed=2, disp_iter=1000, save_iter=1,
                eval_user_block=128, eval_item_block=128,
                bpr_engine="dense", rho_rms=1.0, alpha=0.0)
    base.update(kw)
    return Params(**base)


@pytest.mark.parametrize("mf_method", ["train", "auto", "hog"])
def test_train_model_dense_matches_jax(lo_data, monkeypatch, mf_method):
    """train_model(algo="bpr", bpr_engine="dense") on the JAX key chain's
    draws: the same stop reason, best epoch and HR@10 (NDCG for hog)
    history; losses at rtol 1e-4 and the best state at JAX's replica
    tolerance after ten epochs."""
    p = _front_params()
    monkeypatch.setattr(DenseBPRSolver, "draw", _jax_loop_draw)
    leaves = _start(lo_data, p.fac_dim, 5, scale=0.01)
    rep_j, *_ = j_train_model(
        lo_data, p, algo="bpr", mf_method=mf_method, log_fn=lambda s: None,
        init_state_override=JState(*(jnp.asarray(a) for a in leaves)))
    rep_t, *_ = train_model(
        lo_data, p, algo="bpr", mf_method=mf_method, device="cpu",
        log_fn=lambda s: None,
        init_state_override=state_from_numpy(*leaves, device="cpu"))
    assert isinstance(rep_t.solver, DenseBPRSolver)
    assert rep_t.stop_reason == rep_j.stop_reason
    assert rep_t.best_iter == rep_j.best_iter
    assert len(rep_t.history) == len(rep_j.history) == p.max_iter
    np.testing.assert_allclose([h.val_rmse for h in rep_t.history],
                               [h.val_rmse for h in rep_j.history],
                               rtol=1e-5)
    np.testing.assert_allclose([h.objective for h in rep_t.history],
                               [h.objective for h in rep_j.history],
                               rtol=1e-4)
    for got, want in zip(rep_t.best_state[:2], rep_j.best_state[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_dense_training_lifts_hr(lo_data):
    """The solver's own draws: val HR@10 rises past JAX's own threshold for
    this engine on this data (0.55, tests/test_bpr_dense.py)."""
    rep, *_ = train_model(lo_data, _front_params(max_iter=20), algo="bpr",
                          device="cpu", log_fn=lambda s: None)
    assert isinstance(rep.solver, DenseBPRSolver)
    assert rep.best_metric > 0.55, rep.best_metric


@pytest.mark.parametrize("mf_method", ["train", "sigmoid"])
def test_hybrid_with_the_dense_engine_falls_back(lo_data, mf_method):
    """The hybrid's per-triple masks do not factor through C: both front
    doors log the fallback and train on the stream engine."""
    p = _front_params(max_iter=2)
    logs_t, logs_j = [], []
    rep, *_ = train_model(lo_data, p, algo="bpr_poisson",
                          mf_method=mf_method, device="cpu",
                          log_fn=logs_t.append)
    j_train_model(lo_data, p, algo="bprpoissondropout", mf_method=mf_method,
                  log_fn=logs_j.append)
    assert isinstance(rep.solver, BPRSolver)
    for logs in (logs_t, logs_j):
        assert any("falling back to the stream engine" in s for s in logs)


def test_posneg_stays_on_the_stream_engine(lo_data):
    """Posneg mode never builds the dense engine, as in JAX."""
    rep, *_ = train_model(lo_data, _front_params(max_iter=1), algo="bpr",
                          mf_method="posneg", device="cpu",
                          log_fn=lambda s: None)
    assert isinstance(rep.solver, BPRSolver) and rep.solver.mode == "posneg"


def test_dense_resume_is_exact(lo_data, tmp_path):
    """The generator is part of the checkpoint: a run stopped at epoch 3 and
    resumed reaches the uninterrupted run's state."""
    p = _front_params(max_iter=6, learn_rate=0.1)
    run = lambda prefix, params, resume: train_model(
        lo_data, params, algo="bpr", device="cpu",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=3), False)
    res = run("part", p, True)
    assert torch.equal(full.state.u_fac, res.state.u_fac)
    assert torch.equal(full.state.i_fac, res.state.i_fac)
    assert [h.val_rmse for h in full.history[3:]] == \
        [h.val_rmse for h in res.history]
