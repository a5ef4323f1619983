"""The port's SVD init, its two metrics and mf_method="sgdparsvd"
(matfac_tpu_torch.ops.svd_init, Evaluator.objective_sing /
full_low_rank_err, train_model) against the JAX package.

Tolerances: singular values at rtol 1e-4 with JAX's test matrix omega;
singular vectors, which either package may return with the other sign,
through |u_torch^T u_jax| = 1 per dim at atol 1e-3 and the reconstruction
U S V^T at atol 1e-4 of its largest entry; the metrics at rtol 1e-5;
train_model with JAX's SVD output and batch orders injected at rtol 1e-5
(f32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.eval.metrics import Evaluator as JEvaluator
from matfac_tpu.models.base import EvalView as JView
from matfac_tpu.models.base import MFState as JState
from matfac_tpu.ops import svd_init as jsvd
from matfac_tpu.train.loop import train_model as j_train_model
from matfac_tpu.utils import freq
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.models.base import EvalView, MFState, state_from_numpy
from matfac_tpu_torch.ops import svd_init as tsvd
from matfac_tpu_torch.solvers.sgd import SGDSolver
from matfac_tpu_torch.train import loop as tloop
from matfac_tpu_torch.train.loop import train_model

from test_torch_train import _jax_model, _jax_sgd_epoch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lr_data():
    """A rank-5 synthetic matrix with its ground-truth factors."""
    return synthetic_data(n_users=120, n_items=90, k=5, density=0.3,
                          seed=3, noise=0.05, nonneg=True, power_law=0.5)


def _jax_omega(mat, rank, seed=0, oversample=8):
    rr = min(rank + oversample, min(mat.nrows, mat.ncols))
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (mat.ncols, rr)))


@pytest.mark.parametrize("rank", [4, 6])
@pytest.mark.parametrize("mode", ["plain", "pure_svd", "sparsity_only"])
def test_svd_init_matches_jax_with_its_omega(lr_data, mode, rank):
    data, _, _ = lr_data
    mat = data.train_mat
    kw = {"plain": {}, "pure_svd": dict(pure_svd=True),
          "sparsity_only": dict(sparsity_only=True)}[mode]
    ju, jv, js = jsvd.svd_init(mat, rank, **kw)
    tu, tv, ts = tsvd.svd_init(mat, rank, omega=_jax_omega(mat, rank),
                               device="cpu", **kw)
    for got, want in ((tu, ju), (tv, jv), (ts, js)):
        assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(ts, js, rtol=1e-4)
    assert (np.diff(ts) <= 0).all() and ts[-1] > 0
    # sign-invariant: each left / right vector against JAX's
    vt = tv / ts[None, :] if mode == "pure_svd" else tv
    vj = jv / js[None, :] if mode == "pure_svd" else jv
    np.testing.assert_allclose(np.abs((tu * ju).sum(0)), 1.0, atol=1e-3)
    np.testing.assert_allclose(np.abs((vt * vj).sum(0)), 1.0, atol=1e-3)
    rec_t = (tu * ts[None, :]) @ vt.T
    rec_j = (ju * js[None, :]) @ vj.T
    np.testing.assert_allclose(rec_t, rec_j, rtol=0,
                               atol=1e-4 * np.abs(rec_j).max())


def test_svd_init_recovers_the_top_singular_values(lr_data):
    """The port's own omega (a generator seeded by ``seed``): the leading
    singular values of the dense train matrix, as numpy's exact SVD gives
    them, and the same factors for the same seed."""
    data, _, _ = lr_data
    mat = data.train_mat
    dense = np.zeros((mat.nrows, mat.ncols), np.float64)
    r, c, v = mat.to_coo()
    dense[r, c] = v
    exact = np.linalg.svd(dense, compute_uv=False)[:4]
    u, i, s = tsvd.svd_init(mat, 4, seed=5, device="cpu")
    np.testing.assert_allclose(s, exact, rtol=1e-4)
    again = tsvd.svd_init(mat, 4, seed=5, device="cpu")
    for a, b in zip((u, i, s), again):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(u.T @ u, np.eye(4), atol=1e-5)


def _views(data, seed, k, bias=True):
    rng = np.random.default_rng(seed)
    leaves = tuple(np.asarray(a, np.float32) for a in (
        rng.normal(0, 0.5, (data.n_users, k)),
        rng.normal(0, 0.5, (data.n_items, k)),
        rng.normal(0, 0.2, data.n_users) * bias,
        rng.normal(0, 0.2, data.n_items) * bias,
        np.asarray(0.3 * bias)))
    return (JView(*(jnp.asarray(a) for a in leaves)),
            EvalView(*(torch.from_numpy(a.copy()) for a in leaves)), leaves)


def _evaluators(data, p):
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    iu, ii = iu.copy(), ii.copy()
    iu[::11] = True    # invalid entities drop out of every sum
    ii[::13] = True
    return (JEvaluator(data, iu, ii, p),
            Evaluator(data, iu, ii, p, device="cpu"))


def test_objective_sing_matches_jax(lr_data):
    data, _, _ = lr_data
    p = Params(fac_dim=5, u_reg=0.3, i_reg=0.7)
    jev, tev = _evaluators(data, p)
    jv, tv, leaves = _views(data, 1, 5, bias=False)
    sing = np.asarray([9.0, 4.0, 2.5, 1.0, 0.25], np.float32)
    want = jev.objective_sing(jv, JState(*jv), sing)
    got = tev.objective_sing(tv, MFState(*tv), sing)
    assert got == pytest.approx(want, rel=1e-5)
    # no u_reg / i_reg scaling: the penalty does not move with them
    p2 = Params(fac_dim=5, u_reg=3.0, i_reg=0.01)
    assert Evaluator(data, tev.invalid_users, tev.invalid_items, p2,
                     device="cpu").objective_sing(tv, MFState(*tv), sing) \
        == pytest.approx(got, rel=1e-12)


@pytest.mark.parametrize("exclude_rated", [True, False])
@pytest.mark.parametrize("user_block", [512, 16])
def test_full_low_rank_err_matches_jax(lr_data, exclude_rated, user_block):
    data, u0, i0 = lr_data
    p = Params(fac_dim=5)
    jev, tev = _evaluators(data, p)
    jv, tv, _ = _views(data, 2, 5)
    want = jev.full_low_rank_err(jv, u0, i0, exclude_rated=exclude_rated,
                                 user_block=user_block)
    got = tev.full_low_rank_err(tv, u0, i0, exclude_rated=exclude_rated,
                                user_block=user_block)
    assert got == pytest.approx(want, rel=1e-5)
    # the ground truth recovers itself
    truth = EvalView(torch.from_numpy(np.asarray(u0, np.float32)),
                     torch.from_numpy(np.asarray(i0, np.float32)),
                     torch.zeros(data.n_users), torch.zeros(data.n_items),
                     torch.zeros(()))
    assert tev.full_low_rank_err(truth, u0, i0, exclude_rated) < 1e-6


# ----------------------------------------------------------------------
# the front door
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sing", [(None, None), (0.5, 2.0)])
def test_train_model_sgdparsvd_matches_jax(lr_data, monkeypatch, sing):
    """The port's svd_init patched to return JAX's output, the port's epochs
    fed the JAX key chain's batch orders: the per-dim regularization (u_reg
    / i_reg standing in for sing_a / sing_b when None), the SVD factors as
    the start and objective_sing in the loop, against JAX's front door at
    rtol 1e-5."""
    data, _, _ = lr_data
    p = Params(fac_dim=6, u_reg=0.05, i_reg=0.08, learn_rate=0.01,
               max_iter=6, seed=1, disp_iter=1000, save_iter=1,
               batch_size=128, sing_a=sing[0], sing_b=sing[1])
    calls = []

    def jax_svd(mat, rank, **kw):
        calls.append(rank)
        return jsvd.svd_init(mat, rank)

    monkeypatch.setattr(tloop, "svd_init", jax_svd)
    monkeypatch.setattr(SGDSolver, "epoch",
                        _jax_sgd_epoch(_jax_model("mf", data, p)))
    rep_j, *_ = j_train_model(data, p, mf_method="sgdparsvd",
                              log_fn=lambda s: None)
    rep_t, model, ev, _ = train_model(data, p, mf_method="sgdparsvd",
                                      device="cpu", log_fn=lambda s: None)
    assert calls == [p.fac_dim]
    solver = rep_t.solver
    assert isinstance(solver, SGDSolver) and solver.reg_vec is not None
    _, _, s = jsvd.svd_init(data.train_mat, p.fac_dim)
    sa = p.u_reg if sing[0] is None else sing[0]
    sb = p.i_reg if sing[1] is None else sing[1]
    np.testing.assert_array_equal(solver.reg_vec.numpy(),
                                  ((sa + 1.0) / (sb + s)).astype(np.float32))
    # the biases stay at each package's own random init (plain MF never
    # reads them), so the factors and the histories are compared
    assert rep_t.stop_reason == rep_j.stop_reason
    assert rep_t.best_iter == rep_j.best_iter
    for f in ("val_rmse", "objective"):
        np.testing.assert_allclose([getattr(h, f) for h in rep_t.history],
                                   [getattr(h, f) for h in rep_j.history],
                                   rtol=1e-5)
    for got, want in ((rep_t.state.u_fac, rep_j.state.u_fac),
                      (rep_t.state.i_fac, rep_j.state.i_fac)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    # the loop's objective is objective_sing, not the u_reg / i_reg one
    st = rep_t.state
    last = rep_t.history[-1].objective
    assert last == pytest.approx(
        ev.objective_sing(model.eval_view(st), st, s), rel=1e-12)
    assert last != pytest.approx(ev.objective(model.eval_view(st), st),
                                 rel=1e-3)


def test_sgdparsvd_starts_from_the_svd_factors(lr_data, monkeypatch):
    """Without an override the first epoch starts from the SVD factors,
    zero-padded past the train matrix's rows; an override wins."""
    data, _, _ = lr_data
    p = Params(fac_dim=4, u_reg=0.05, i_reg=0.05, learn_rate=0.0,
               max_iter=1, seed=1, disp_iter=1000, batch_size=128)
    u0, v0, s = tsvd.svd_init(data.train_mat, 4, device="cpu")
    monkeypatch.setattr(tloop, "svd_init",
                        lambda mat, rank, **kw: (u0, v0, s))
    rep, *_ = train_model(data, p, mf_method="sgdparsvd", device="cpu",
                          log_fn=lambda s: None)
    n_rows = data.train_mat.nrows
    np.testing.assert_array_equal(rep.state.u_fac[:n_rows].numpy(),
                                  u0[: data.n_users])
    assert float(rep.state.u_fac[n_rows:].abs().sum()) == 0.0
    np.testing.assert_array_equal(
        rep.state.i_fac[: v0.shape[0]].numpy(), v0[: data.n_items])
    leaves = _views(data, 3, 4, bias=False)[2]
    own = state_from_numpy(*leaves, device="cpu")
    rep2, *_ = train_model(data, p, mf_method="sgdparsvd", device="cpu",
                           init_state_override=own, log_fn=lambda s: None)
    np.testing.assert_array_equal(rep2.state.u_fac.numpy(), leaves[0])


def test_sgdparsvd_trains(lr_data):
    """The port's own SVD init and draws: val RMSE falls below the SVD
    start's, and the refusal of reg_exponent stays JAX's."""
    data, _, _ = lr_data
    p = Params(fac_dim=5, u_reg=0.05, i_reg=0.05, learn_rate=0.01,
               max_iter=8, seed=1, disp_iter=1000, batch_size=128)
    rep, model, ev, _ = train_model(data, p, mf_method="sgdparsvd",
                                    device="cpu", log_fn=lambda s: None)
    vals = [h.val_rmse for h in rep.history]
    assert np.isfinite(vals).all() and rep.best_metric < vals[0]
    with pytest.raises(ValueError, match="reg_exponent"):
        train_model(data, p.replace(reg_exponent=0.5),
                    mf_method="sgdparsvd", device="cpu",
                    log_fn=lambda s: None)
