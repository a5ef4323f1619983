"""The port's training loop, front door and checkpoints
(matfac_tpu_torch.train) — the branch tests of tests/test_train.py with
scripted stubs, resume, train_model(algo="mf", mf_method="densesgd")
against the JAX train_model from the same initial state and stripe
orders, and train_model(mf_method="blocksgd") for plain MF and TMF with
the JAX solver's diag schedules."""

import os

import numpy as np
import pytest
import torch

import jax

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.ops.block_sgd_kernel import device_diag_schedule
from matfac_tpu.train import checkpoint as jckpt
from matfac_tpu.train.loop import train_model as j_train_model
from matfac_tpu_torch.models.base import (MFState, init_state, rank_mask,
                                          state_from_numpy, state_to_numpy)
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
from matfac_tpu_torch.solvers.sgd import SGDSolver
from matfac_tpu_torch.train import checkpoint as ckpt
from matfac_tpu_torch.train.loop import TrainLoop, train_model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------------
# the termination state machine, with scripted stubs
# ----------------------------------------------------------------------

class StubModel:
    use_bias = False
    use_factors = True
    n_users = 4
    n_items = 3

    def eval_view(self, state):
        return state

    def example_weight(self, rows, cols):
        return torch.ones(rows.shape)


class StubSolver:
    """Each epoch adds one to u_fac."""

    def __init__(self):
        self.calls = 0

    def epoch(self, state, lr):
        self.calls += 1
        return state._replace(u_fac=state.u_fac + 1.0)


class StubEvaluator:
    """Scripted objective / val-RMSE sequences, keyed by check count."""

    def __init__(self, objs, vals):
        self.objs = objs
        self.vals = vals
        self.i = -1

        class _C:
            rows = torch.zeros(1, dtype=torch.int64)
            cols = torch.zeros(1, dtype=torch.int64)
        self.train_coo = _C()

    def objective(self, view, state, weights=None, use_factors=True,
                  use_bias=False):
        self.i += 1
        return self.objs[min(self.i, len(self.objs) - 1)]

    def rmse(self, view, which):
        if which == "val":
            return self.vals[min(max(self.i, 0), len(self.vals) - 1)]
        return 0.0


def dummy_state():
    z = torch.zeros((4, 3))
    return MFState(z, z, torch.zeros(4), torch.zeros(3), torch.zeros(()))


def make_loop(objs, vals, **params_kw):
    p = Params(max_iter=params_kw.pop("max_iter", 20), learn_rate=0.1,
               **params_kw)
    solver = StubSolver()
    loop = TrainLoop(StubModel(), solver, StubEvaluator(objs, vals), p,
                     log_fn=lambda s: None)
    return loop, solver


def test_converges_on_small_obj_delta():
    loop, solver = make_loop([100.0, 50.0, 50.0 + 1e-7], [1.0, 0.9, 0.8])
    rep = loop.run(dummy_state())
    assert rep.stop_reason == "converged"
    assert solver.calls == 2


def test_best_snapshot_tracks_val():
    objs = [100.0] + [90.0 - i for i in range(10)]
    vals = [1.0, 0.5, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3, 1.4, 1.5]
    loop, _ = make_loop(objs, vals, max_iter=5)
    rep = loop.run(dummy_state())
    assert rep.best_iter == 0
    assert rep.best_metric == 0.5
    assert float(rep.best_state.u_fac[0, 0]) == 1.0
    assert float(rep.state.u_fac[0, 0]) == 5.0


def test_lr_halves_after_100_stagnant():
    objs = [100.0] + [90.0 - 0.1 * i for i in range(200)]
    vals = [0.5] + [0.9] * 200
    loop, _ = make_loop(objs, vals, max_iter=150)
    lrs = [h.lr for h in loop.run(dummy_state()).history]
    assert lrs[98] == pytest.approx(0.1)
    assert lrs[99] == pytest.approx(0.05)
    assert lrs[100] == pytest.approx(0.025)


def test_chance_iter_gives_up():
    objs = [100.0] + [90.0 - 0.1 * i for i in range(600)]
    vals = [0.5] + [0.9] * 600
    loop, solver = make_loop(objs, vals, max_iter=600)
    rep = loop.run(dummy_state())
    assert rep.stop_reason == "not_converged_chance_iter"
    assert solver.calls == 500


def test_nan_rollback_restores_best_and_halves_lr():
    objs = [100.0, 90.0, float("nan"), 80.0, 70.0]
    vals = [1.0, 0.5, 0.6, 0.6, 0.6]
    loop, _ = make_loop(objs, vals, max_iter=4)
    rep = loop.run(dummy_state())
    assert rep.history[-1].lr == pytest.approx(0.05)
    assert rep.stop_reason == "max_iter"
    # best was epoch 0 (u=1); epochs 2, 3 ran on the restored state
    assert float(rep.state.u_fac[0, 0]) == 3.0


def test_nan_rollback_resets_the_solver():
    """On a non-finite check the loop restores the best snapshot and calls
    the solver's reset() once, as JAX's loop does (CCD's carried residual
    must start again from the restored tables)."""
    class ResettingSolver(StubSolver):
        resets = 0

        def reset(self):
            self.resets += 1

    objs = [100.0, 90.0, float("nan"), 80.0, 70.0]
    vals = [1.0, 0.5, 0.6, 0.6, 0.6]
    p = Params(max_iter=4, learn_rate=0.1)
    solver = ResettingSolver()
    loop = TrainLoop(StubModel(), solver, StubEvaluator(objs, vals), p,
                     log_fn=lambda s: None)
    rep = loop.run(dummy_state())
    assert solver.resets == 1
    assert solver.calls == 4 and rep.history[-1].lr == pytest.approx(0.05)


def test_nan_at_min_lr_stops():
    loop, _ = make_loop([100.0, float("nan")], [1.0, 0.5], max_iter=4)
    loop.params.learn_rate = 1e-6
    assert loop.run(dummy_state()).stop_reason == "nan_at_min_lr"


# ----------------------------------------------------------------------
# state helpers and checkpoints
# ----------------------------------------------------------------------

def test_init_state_and_numpy_round_trip():
    p = Params(fac_dim=4, seed=3)
    a = init_state(p, 7, 5, device="cpu")
    b = init_state(p, 7, 5, generator=torch.Generator().manual_seed(3),
                   device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.u_fac.shape == (7, 4) and a.i_fac.shape == (5, 4)
    assert float(a.u_fac.abs().max()) <= 0.01 and float(a.mu) == 0.0
    back = state_from_numpy(*state_to_numpy(a), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, back))


def test_rank_mask_matches_jax():
    import jax.numpy as jnp
    from matfac_tpu.models.base import rank_mask as j_rank_mask
    ranks = np.array([0, 1, 3, 4, 6], np.int32)
    assert np.array_equal(rank_mask(torch.from_numpy(ranks), 4).numpy(),
                          np.asarray(j_rank_mask(jnp.asarray(ranks), 4)))


def test_text_checkpoints_are_byte_identical_to_jax(tmp_path):
    p = Params(fac_dim=3, u_reg=0.01, i_reg=0.02, learn_rate=0.005)
    js = j_init_state(p, 6, 5)
    sig = ckpt.model_signature(p, 6, 5)
    assert sig == jckpt.model_signature(p, 6, 5) == "6X5_3_0.01_0.02_0.005"
    ts = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    for path_t, path_j in zip(ckpt.save_facs(ts, str(tmp_path / "t"), sig),
                              jckpt.save_facs(js, str(tmp_path / "j"), sig)):
        assert open(path_t, "rb").read() == open(path_j, "rb").read()
    # and each package reads the other's files
    back = ckpt.load_facs(init_state(p, 6, 5, device="cpu"),
                          str(tmp_path / "j"), sig)
    np.testing.assert_allclose(back.u_fac.numpy(), np.asarray(js.u_fac),
                               rtol=1e-6)
    assert ckpt.load_facs(ts, str(tmp_path / "nope"), sig) is None


def test_invalid_and_state_checkpoints_round_trip(tmp_path):
    prefix = str(tmp_path / "m")
    iu = np.array([True, False, True, False])
    ii = np.array([False, False, True])
    ckpt.save_invalid(prefix, iu, ii)
    assert all(np.array_equal(a, b) for a, b in zip(
        ckpt.load_invalid(prefix, 4, 3), jckpt.load_invalid(prefix, 4, 3)))
    assert ckpt.load_invalid(prefix + "x", 4, 3) is None
    st = init_state(Params(fac_dim=2), 3, 4, device="cpu")
    path = str(tmp_path / "st.npz")
    ckpt.save_state(path, st, epoch=np.int64(7), lr=np.float64(0.01))
    back, extra = ckpt.load_state(path, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(st, back))
    assert extra["epoch"] == 7 and extra["lr"] == 0.01
    jback, _ = jckpt.load_state(path)
    np.testing.assert_array_equal(np.asarray(jback.i_fac), st.i_fac.numpy())


# ----------------------------------------------------------------------
# train_model: the port against the JAX front door
# ----------------------------------------------------------------------

def _data():
    data, _, _ = synthetic_data(n_users=100, n_items=80, k=3, density=0.3,
                                seed=3, noise=0.05, nonneg=True)
    p = Params(fac_dim=3, u_reg=0.05, i_reg=0.05, learn_rate=0.05,
               max_iter=10, seed=1, disp_iter=1000, save_iter=1)
    return data, p


def _jax_orders(self):
    """Stand-in for BlockSGDSolver._stripe_order: the order the JAX dense
    solver draws each epoch (default_rng(seed + 41) keys, then
    device_diag_schedule with one lane)."""
    if not hasattr(self, "_jax_rng"):
        self._jax_rng = np.random.default_rng(self.params.seed + 41)
    ek = jax.random.PRNGKey(int(self._jax_rng.integers(2**31)))
    order = device_diag_schedule(ek, self.NU, 1, 1)[0][:, 0]
    return torch.from_numpy(np.asarray(order, np.int64))


def test_train_model_matches_jax(tmp_path, monkeypatch):
    data, p = _data()
    monkeypatch.setattr(BlockSGDSolver, "_stripe_order", _jax_orders)
    js = j_init_state(p, data.n_users, data.n_items)
    rep_j, *_ = j_train_model(data, p, algo="mf", mf_method="densesgd",
                              init_state_override=js,
                              log_fn=lambda s: None)
    prefix = str(tmp_path / "t")
    rep_t, model, ev, (iu, ii) = train_model(
        data, p, algo="mf", mf_method="densesgd", device="cpu",
        init_state_override=state_from_numpy(
            *(np.asarray(a) for a in js), device="cpu"),
        prefix=prefix, log_fn=lambda s: None)
    assert rep_t.stop_reason == rep_j.stop_reason
    assert rep_t.best_iter == rep_j.best_iter
    assert len(rep_t.history) == len(rep_j.history) == p.max_iter
    # mm_bf16 operand rounding compounds over the epochs
    np.testing.assert_allclose([h.val_rmse for h in rep_t.history],
                               [h.val_rmse for h in rep_j.history],
                               rtol=1e-3)
    assert rep_t.best_metric == pytest.approx(rep_j.best_metric, rel=1e-3)
    # the text checkpoint reads back through the JAX package's reader
    sig = jckpt.model_signature(p, data.n_users, data.n_items)
    back = jckpt.load_facs(js, prefix, sig)
    np.testing.assert_allclose(np.asarray(back.u_fac),
                               rep_t.best_state.u_fac.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert ckpt.load_invalid(prefix, data.n_users, data.n_items) is not None


def test_train_model_ifwmf_densesgd_matches_jax(monkeypatch):
    """IFWMF on the row-dense engine: its popularity weights stage as float
    W tiles (f32 at this size), and ten epochs from one initial state with
    JAX's stripe orders injected give JAX's val RMSE per epoch (rtol 1e-3:
    mm_bf16 operand rounding compounds over the epochs) and factors."""
    data, p = _data()
    monkeypatch.setattr(BlockSGDSolver, "_stripe_order", _jax_orders)
    js = j_init_state(p, data.n_users, data.n_items)
    rep_j, *_ = j_train_model(data, p, algo="ifwmf", mf_method="densesgd",
                              init_state_override=js,
                              log_fn=lambda s: None)
    rep_t, *_ = train_model(
        data, p, algo="ifwmf", mf_method="densesgd", device="cpu",
        init_state_override=state_from_numpy(
            *(np.asarray(a) for a in js), device="cpu"),
        log_fn=lambda s: None)
    sol = rep_t.solver
    assert (sol.engine, sol.tiles.R.dtype, sol.tiles.W.dtype) == (
        "dense", torch.float32, torch.float32)
    w = sol.tiles.W[sol.tiles.W > 0]
    assert float(w.min()) < 1.0   # float weights, not validity
    assert rep_t.stop_reason == rep_j.stop_reason
    assert rep_t.best_iter == rep_j.best_iter
    assert len(rep_t.history) == len(rep_j.history) == p.max_iter
    np.testing.assert_allclose([h.val_rmse for h in rep_t.history],
                               [h.val_rmse for h in rep_j.history],
                               rtol=1e-3)
    np.testing.assert_allclose(rep_t.state.u_fac.numpy(),
                               np.asarray(rep_j.state.u_fac), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(rep_t.state.i_fac.numpy(),
                               np.asarray(rep_j.state.i_fac), rtol=1e-3,
                               atol=1e-4)


def test_resume_is_bit_exact(tmp_path):
    """A run stopped at epoch 5 and resumed reaches the same state as an
    uninterrupted run: the loop state and the stripe-order generator are
    in the checkpoint."""
    data, p = _data()
    run = lambda prefix, params, resume: train_model(
        data, params, mf_method="densesgd", device="cpu",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=5), False)
    logs = []
    res = train_model(data, p, mf_method="densesgd", device="cpu",
                      prefix=str(tmp_path / "part"), resume=True,
                      log_fn=logs.append)[0]
    assert any("resumed from" in s for s in logs)
    assert torch.equal(full.state.u_fac, res.state.u_fac)
    assert torch.equal(full.state.i_fac, res.state.i_fac)
    assert full.best_metric == res.best_metric


def test_resume_survives_missing_best_file(tmp_path):
    data, p = _data()
    p = p.replace(max_iter=3)
    prefix = str(tmp_path / "r")
    train_model(data, p, mf_method="densesgd", device="cpu", prefix=prefix,
                log_fn=lambda s: None)
    os.remove(prefix + "_loop_best.npz")
    logs = []
    rep, *_ = train_model(data, p, mf_method="densesgd", device="cpu",
                          prefix=prefix, resume=True, log_fn=logs.append)
    assert any("starting fresh" in s for s in logs), logs
    assert np.isfinite(rep.best_metric)


@pytest.mark.parametrize("kw,match", [
    (dict(algo="tmfdropout", mf_method="blocksgd"), "static per-pair ranks"),
    (dict(algo="tmf", mf_method="als"), "coordinate family"),
    (dict(algo="ifwmf", mf_method="ccd"), "coordinate family"),
    (dict(algo="tmf", mf_method="densesgd",
          params=dict(reg_exponent=0.5)), "reg_exponent"),
    (dict(mf_method="nope"), "unknown mf_method"),
    (dict(algo="mf_loc", mf_method="blocksgd"), "per-side"),
    (dict(algo="mfloc", mf_method="densesgd"), "per-side"),
    (dict(algo="mf_loc", mf_method="als"), "per-side"),
    (dict(algo="dropoutmf", mf_method="blocksgd"), "static per-pair ranks"),
    (dict(algo="dropoutmf_ordered", mf_method="als"), "coordinate family"),
    (dict(algo="mf_headwt", mf_method="ccd++"), "coordinate family"),
    (dict(algo="mfwt", mf_method="ialspp"), "coordinate family"),
    (dict(algo="tmf_bias", mf_method="blocksgd"), "factor-only"),
    (dict(algo="tmf_bias", mf_method="sgdparsvd"), "factor-only"),
    (dict(algo="tmf_bias", mf_method="alsdense"), "coordinate family"),
    (dict(algo="mf_headwt", mf_method="densesgd",
          params=dict(reg_exponent=0.5)), "reg_exponent"),
    (dict(algo="mf_freq", mf_method="als"), "through the SGD engine"),
    (dict(algo="mffreq", mf_method="blocksgd"), "through the SGD engine"),
    (dict(algo="mf_freq", resume=True), "resume is not supported"),
    (dict(algo="increment"), "probe matrix")])
def test_refusals_match_jax(kw, match):
    """What JAX refuses, the port refuses with JAX's ValueError: sampled
    ranks on the one-hot engine, weighted or rank-masked models on the
    coordinate family, reg_exponent off the sgd engine, unknown methods;
    per-side gates off the sgd engine, biases on the factor-only engines,
    the mf_freq curriculum off the sgd engine or resumed, and incremental
    rank without a probe matrix (``data.graph_mat``)."""
    data, p = _data()
    assert data.graph_mat is None
    kw = dict(kw)
    p = p.replace(**kw.pop("params", {}))
    for fn, extra in ((j_train_model, {}), (train_model, dict(device="cpu"))):
        with pytest.raises(ValueError, match=match):
            fn(data, p, log_fn=lambda s: None, **kw, **extra)


def test_epoch_log_has_the_jax_fields_and_tracks_train_rmse():
    """EpochLog carries the JAX field set in the JAX order (train_rmse
    between val_rmse and lr), and TrainLoop fills train_rmse when asked."""
    import dataclasses

    from matfac_tpu.train.loop import EpochLog as JEpochLog
    from matfac_tpu_torch.train.loop import EpochLog
    names = lambda c: [f.name for f in dataclasses.fields(c)]
    assert names(EpochLog) == names(JEpochLog)
    log = EpochLog(3, 1.0, 0.5, 0.25, 0.01, 2.0)
    assert (log.train_rmse, log.lr, log.seconds) == (0.25, 0.01, 2.0)

    data, p = _data()
    p = p.replace(max_iter=2)
    rep, model, ev, _ = train_model(data, p, mf_method="densesgd",
                                    device="cpu", log_fn=lambda s: None)
    assert all(np.isnan(h.train_rmse) for h in rep.history)
    loop = TrainLoop(model, rep.solver, ev, p, log_fn=lambda s: None,
                     track_train_rmse=True)
    rep2 = loop.run(rep.state)
    for h in rep2.history:
        assert np.isfinite(h.train_rmse) and h.lr == pytest.approx(0.05)
    assert rep2.history[-1].train_rmse == pytest.approx(
        ev.rmse(model.eval_view(rep2.state), "train"), rel=1e-12)


# ----------------------------------------------------------------------
# train_model on the one-hot cell engine
# ----------------------------------------------------------------------

def _jax_diag_draw(self):
    """Stand-in for BlockSGDSolver.draw_schedule (diag): the schedule the
    JAX solver generates on the device from the same numpy draw."""
    ek = jax.random.PRNGKey(int(self._sched_rng.integers(2**31)))
    return device_diag_schedule(ek, self.NU, self.NI, self.S // self.bs)


def _block_data():
    """1000 x 800 at 5% density: 3 x 3 blocks of 384, so the diag schedule
    has 3 rounds of 3 lanes and each cell several 1024-rating steps."""
    data, _, _ = synthetic_data(n_users=1000, n_items=800, k=3,
                                density=0.05, seed=3, noise=0.05,
                                nonneg=True)
    p = Params(fac_dim=8, u_reg=0.01, i_reg=0.01, learn_rate=0.05,
               max_iter=3, seed=1, disp_iter=1000)
    return data, p


@pytest.mark.parametrize("algo", ["mf", "tmf"])
def test_train_model_blocksgd_matches_jax(algo, monkeypatch):
    """Three epochs through each front door from one initial state, the
    port drawing JAX's diag schedules: the same solver configuration
    (diag, 384-blocks, 1024-rating steps), factors at rtol 1e-5 /
    atol 1e-6 (JAX's zero-padded k=128 columns sum in another order) and
    the same val RMSE per epoch and best."""
    data, p = _block_data()
    monkeypatch.setattr(BlockSGDSolver, "draw_schedule", _jax_diag_draw)
    js = j_init_state(p, data.n_users, data.n_items)
    rep_j, *_ = j_train_model(data, p, algo=algo, mf_method="blocksgd",
                              init_state_override=js,
                              log_fn=lambda s: None)
    rep_t, model, ev, _ = train_model(
        data, p, algo=algo, mf_method="blocksgd", device="cpu",
        init_state_override=state_from_numpy(
            *(np.asarray(a) for a in js), device="cpu"),
        log_fn=lambda s: None)
    sol = rep_t.solver
    assert (sol.engine, sol.schedule, sol.bu, sol.bi, sol.bs, sol.NU,
            sol.NI) == ("xla", "diag", 384, 384, 1024, 3, 3)
    assert sol.use_mask == (algo == "tmf")
    assert rep_t.stop_reason == rep_j.stop_reason
    assert rep_t.best_iter == rep_j.best_iter
    assert len(rep_t.history) == len(rep_j.history) == p.max_iter
    np.testing.assert_allclose(rep_t.state.u_fac.numpy(),
                               np.asarray(rep_j.state.u_fac), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rep_t.state.i_fac.numpy(),
                               np.asarray(rep_j.state.i_fac), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose([h.val_rmse for h in rep_t.history],
                               [h.val_rmse for h in rep_j.history],
                               rtol=1e-5)
    np.testing.assert_allclose([h.objective for h in rep_t.history],
                               [h.objective for h in rep_j.history],
                               rtol=1e-5)
    assert rep_t.best_metric == pytest.approx(rep_j.best_metric, rel=1e-5)


def test_densesgd_falls_back_to_blocksgd(monkeypatch):
    """A dense grid over its budget falls back to the one-hot engine as the
    JAX front door does, and trains exactly as mf_method='blocksgd'."""
    data, p = _block_data()
    p = p.replace(max_iter=2)

    def over_budget(self, *a, **kw):
        raise ValueError("dense tiles need 9.0 GiB > dense_budget 8.0 GiB")

    monkeypatch.setattr(BlockSGDSolver, "_stage_dense", over_budget)
    logs = []
    fb = train_model(data, p, mf_method="densesgd", device="cpu",
                     log_fn=logs.append)[0]
    assert any("falling back to blocksgd" in s for s in logs), logs
    assert (fb.solver.engine, fb.solver.schedule) == ("xla", "diag")
    direct = train_model(data, p, mf_method="blocksgd", device="cpu",
                         log_fn=lambda s: None)[0]
    assert torch.equal(fb.state.u_fac, direct.state.u_fac)
    assert torch.equal(fb.state.i_fac, direct.state.i_fac)


def test_blocksgd_refuses_reg_exponent_like_jax():
    data, p = _data()
    p = p.replace(reg_exponent=0.5)
    msgs = []
    for fn, kw in ((j_train_model, {}), (train_model, dict(device="cpu"))):
        with pytest.raises(ValueError, match="reg_exponent") as e:
            fn(data, p, mf_method="blocksgd", log_fn=lambda s: None, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------------------
# the scatter SGD engine (the default method), the long-tail models on
# densesgd, and 'auto'
# ----------------------------------------------------------------------

def _longtail_data():
    """Power-law degrees, so TMF's ranks spread over 1..k."""
    data, _, _ = synthetic_data(n_users=100, n_items=80, k=3, density=0.3,
                                seed=3, noise=0.05, nonneg=True,
                                power_law=0.8)
    p = Params(fac_dim=6, u_reg=0.05, i_reg=0.05, learn_rate=0.05,
               max_iter=6, seed=1, disp_iter=1000, save_iter=1,
               batch_size=128, rho_rms=3.0)
    return data, p


def _jax_model(algo, data, p):
    from matfac_tpu.models import base as jbase
    from matfac_tpu.models import longtail as jlt
    from matfac_tpu.utils import freq as jfreq
    uf, if_ = jfreq.row_col_freq(data.train_mat)
    iu, ii = jfreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    n, m = data.n_users, data.n_items
    uf = np.pad(uf, (0, max(n - len(uf), 0)))[:n]
    if_ = np.pad(if_, (0, max(m - len(if_), 0)))[:m]
    return {"mf": lambda: jbase.ModelMF(p, n, m),
            "mf_bias": lambda: jbase.ModelMFBias(p, n, m),
            "ifwmf": lambda: jlt.ModelInvPopMF(p, n, m, uf, if_, iu, ii),
            "tmf": lambda: jlt.ModelDropoutSigmoid(p, n, m, uf, if_),
            "tmfdropout": lambda: jlt.ModelPoissonDropout(p, n, m, uf, if_),
            }[algo]()


def _jax_sgd_epoch(jmodel):
    """Stand-in for SGDSolver.epoch: the draws of the JAX loop's key chain
    (PRNGKey(seed), one split an epoch) and of JAX's SGDSolver epoch
    (tests/test_torch_sgd.jax_draws), through epoch_with."""
    from test_torch_sgd import jax_draws

    def epoch(self, state, lr):
        if not hasattr(self, "_jax_key"):
            self._jax_key = jax.random.PRNGKey(self.params.seed)
        self._jax_key, ek = jax.random.split(self._jax_key)
        return self.epoch_with(state, lr, *jax_draws(self, jmodel, ek))
    return epoch


def _jax_dense_draw(self):
    """Stand-in for BlockSGDSolver.draw_schedule (dense): the JAX dense
    solver's stripe order and, for TMF+Dropout, round uniforms, from one
    key a epoch (default_rng(seed + 41); dense_epoch_rows_keyed)."""
    if self.engine != "dense":
        raise AssertionError("dense engine expected")
    if not hasattr(self, "_jax_rng"):
        self._jax_rng = np.random.default_rng(self.params.seed + 41)
    key = jax.random.PRNGKey(int(self._jax_rng.integers(2**31)))
    round_u = None
    if self.pois_cdf is not None:
        key, ku = jax.random.split(key)
        round_u = torch.from_numpy(np.asarray(
            jax.random.uniform(ku, (self.NU,), jax.numpy.float32)))
    order = device_diag_schedule(key, self.NU, 1, 1)[0][:, 0]
    return torch.from_numpy(np.asarray(order, np.int64)), round_u


def _compare_runs(rep_t, rep_j, rtol, atol=None):
    assert rep_t.stop_reason == rep_j.stop_reason
    assert rep_t.best_iter == rep_j.best_iter
    assert len(rep_t.history) == len(rep_j.history)
    np.testing.assert_allclose([h.val_rmse for h in rep_t.history],
                               [h.val_rmse for h in rep_j.history],
                               rtol=rtol)
    np.testing.assert_allclose([h.objective for h in rep_t.history],
                               [h.objective for h in rep_j.history],
                               rtol=rtol)
    for got, want in zip(rep_t.state, rep_j.state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=rtol, atol=rtol / 10
                                   if atol is None else atol)


@pytest.mark.parametrize("algo,method,extra", [
    ("mf", None, {}), ("mf", "sgd", {}), ("mf", "sgdpar", {}),
    ("mf", "sgdu", {}), ("mf", "hogsgd", {}), ("mf_bias", "sgd", {}),
    ("ifwmf", "sgd", {}), ("tmf", "sgd", {}), ("tmfdropout", "sgd", {}),
    ("mf", "sgd", dict(reg_exponent=0.5)),
    ("mf_bias", "sgd", dict(reg_exponent=-0.5))])
def test_train_model_sgd_matches_jax(algo, method, extra, monkeypatch):
    """train_model on the scatter engine, JAX's default (``method=None``:
    the call ``train_model(data, params)``) and its spellings, and with
    reg_exponent's frequency-scaled regularization, against the JAX front
    door from one initial state, the port drawing the JAX key chain's
    batch orders and Poisson masks: val RMSE, objective and the final
    state at rtol 1e-5 (f32 sums in another order)."""
    data, p = _longtail_data()
    p = p.replace(**extra)
    monkeypatch.setattr(SGDSolver, "epoch",
                        _jax_sgd_epoch(_jax_model(algo, data, p)))
    kw = {} if method is None else dict(mf_method=method)
    if algo != "mf":
        kw["algo"] = algo
    js = j_init_state(p, data.n_users, data.n_items)
    # the JAX sgd epoch donates the state it is given: copy it first
    st = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    rep_j, *_ = j_train_model(data, p, init_state_override=js,
                              log_fn=lambda s: None, **kw)
    rep_t, model, *_ = train_model(data, p, device="cpu",
                                   init_state_override=st,
                                   log_fn=lambda s: None, **kw)
    assert isinstance(rep_t.solver, SGDSolver)
    assert model.name == _jax_model(algo, data, p).name
    _compare_runs(rep_t, rep_j, 1e-5)


@pytest.mark.parametrize("algo", ["tmf", "tmfdropout"])
def test_train_model_longtail_densesgd_matches_jax(algo, monkeypatch):
    """TMF and TMF+Dropout on the row-dense engine (rank masks; Poisson
    ranks redrawn at every stripe visit) against the JAX front door, the
    port drawing JAX's stripe orders and round uniforms: rtol 1e-3
    (mm_bf16 operand rounding compounds over the epochs). The ranks are
    not trivial."""
    data, p = _longtail_data()
    monkeypatch.setattr(BlockSGDSolver, "draw_schedule", _jax_dense_draw)
    js = j_init_state(p, data.n_users, data.n_items)
    st = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    rep_j, *_ = j_train_model(data, p, algo=algo, mf_method="densesgd",
                              init_state_override=js,
                              log_fn=lambda s: None)
    rep_t, *_ = train_model(data, p, algo=algo, mf_method="densesgd",
                            device="cpu", init_state_override=st,
                            log_fn=lambda s: None)
    sol = rep_t.solver
    assert sol.engine == "dense" and sol.tiles.ranks is not None
    assert (sol.pois_cdf is not None) == (algo == "tmfdropout")
    assert int(sol.tiles.ranks[1].min()) < p.fac_dim
    _compare_runs(rep_t, rep_j, 1e-3)


@pytest.mark.parametrize("algo", ["ifwmf", "tmf", "tmfdropout", "mf_bias"])
def test_train_model_auto_matches_jax(algo, monkeypatch):
    """mf_method='auto' resolves as JAX's _auto_method (densesgd for the
    long-tail models at this size, sgd for mf_bias) and trains as JAX."""
    data, p = _longtail_data()
    monkeypatch.setattr(BlockSGDSolver, "draw_schedule", _jax_dense_draw)
    monkeypatch.setattr(SGDSolver, "epoch",
                        _jax_sgd_epoch(_jax_model(algo, data, p)))
    js = j_init_state(p, data.n_users, data.n_items)
    st = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    logs_j, logs_t = [], []
    rep_j, *_ = j_train_model(data, p, algo=algo, mf_method="auto",
                              init_state_override=js, log_fn=logs_j.append)
    rep_t, *_ = train_model(data, p, algo=algo, mf_method="auto",
                            device="cpu", init_state_override=st,
                            log_fn=logs_t.append)
    pick = lambda logs: logs[0].split("'")[1]
    assert pick(logs_t) == pick(logs_j) == ("sgd" if algo == "mf_bias"
                                            else "densesgd")
    _compare_runs(rep_t, rep_j, 1e-3 if algo != "mf_bias" else 1e-5)


class _Mat:
    def __init__(self, values, nnz):
        self.values, self.nnz = values, nnz


class _Data:
    def __init__(self, n_users, n_items, values, nnz):
        self.n_users, self.n_items = n_users, n_items
        self.train_mat = _Mat(values, nnz)


@pytest.mark.parametrize("shape", ["small", "wide_stars", "wide_float",
                                   "wide_float_huge_nnz", "edge_stars"])
def test_auto_method_matches_jax(shape):
    """The port's copy of _auto_method picks JAX's method for every algo
    at grids inside and outside the 6e9-byte dense budget, with star and
    continuous ratings, and streams inside and outside 8e9 bytes."""
    from matfac_tpu.train.loop import _auto_method as j_auto
    from matfac_tpu_torch.train.loop import _auto_method as t_auto
    stars = np.asarray([1.0, 2.5, 4.0, 5.0] * 10, np.float32)
    floats = np.linspace(1.0, 5.0, 40).astype(np.float32) + 0.013
    n_users, n_items, values, nnz = {
        "small": (100, 80, floats, 2_000),
        "wide_stars": (1_000_000, 5_000, stars, 10_000_000),
        "wide_float": (1_000_000, 5_000, floats, 10_000_000),
        "wide_float_huge_nnz": (1_000_000, 5_000, floats, 200_000_000),
        "edge_stars": (2_560 * 900, 2_560, stars, 1_000),
    }[shape]
    data = _Data(n_users, n_items, values, nnz)
    p = Params(fac_dim=8)
    for algo in ("mf", "mf_bias", "ifwmf", "tmf", "tmfdropout", "tmf_bias",
                 "mf_loc", "dropoutmf"):
        assert t_auto(algo, data, p) == j_auto(algo, data, p, None), algo


@pytest.mark.parametrize("algo,method", [("tmfdropout", "sgd"),
                                         ("mf_bias", "sgd"),
                                         ("tmfdropout", "densesgd"),
                                         ("tmf", "densesgd")])
def test_longtail_and_sgd_resume_is_bit_exact(algo, method, tmp_path):
    """Stopped at epoch 3 and resumed to 6 equals the uninterrupted run on
    the CPU: the sgd engine's batch-order and mask generators, and the
    dense engine's order generator (which also draws the round
    uniforms), are in the loop checkpoint."""
    data, p = _longtail_data()
    run = lambda prefix, params, resume: train_model(
        data, params, algo=algo, mf_method=method, device="cpu",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=3), False)
    res = run("part", p, True)
    assert all(torch.equal(a, b) for a, b in zip(full.state, res.state))
    assert full.best_metric == res.best_metric


def test_densesgd_falls_back_to_sgd_for_sampled_ranks(monkeypatch):
    """TMF+Dropout on a dense grid over its budget falls back to the
    scatter engine, as the JAX front door does (the one-hot engines stage
    static ranks), and trains exactly as mf_method='sgd'."""
    data, p = _longtail_data()
    p = p.replace(max_iter=2)

    def over_budget(self, *a, **kw):
        raise ValueError("dense tiles need 9.0 GiB > dense_budget 8.0 GiB")

    monkeypatch.setattr(BlockSGDSolver, "_stage_dense", over_budget)
    logs = []
    fb = train_model(data, p, algo="tmfdropout", mf_method="densesgd",
                     device="cpu", log_fn=logs.append)[0]
    assert any("falling back to sgd" in s for s in logs), logs
    assert isinstance(fb.solver, SGDSolver)
    direct = train_model(data, p, algo="tmfdropout", mf_method="sgd",
                         device="cpu", log_fn=lambda s: None)[0]
    assert all(torch.equal(a, b) for a, b in zip(fb.state, direct.state))


# ----------------------------------------------------------------------
# the coordinate family: ALS and CCD / CCD++
# ----------------------------------------------------------------------

def _coord_data():
    """Item train degrees around 75, freq-adaptive CCD++'s threshold, so
    that both sides of it are populated."""
    data, _, _ = synthetic_data(n_users=300, n_items=80, k=3, density=0.3,
                                seed=3, noise=0.05, nonneg=True)
    p = Params(fac_dim=4, u_reg=0.05, i_reg=0.05, max_iter=3, seed=1,
               disp_iter=1000, save_iter=1)
    return data, p


def _jax_chain_draw(self):
    """Stand-in for the coordinate solvers' ``draw``: what JAX's epoch draws
    from the JAX loop's key chain (PRNGKey(seed), one split an epoch):
    CCD++ a permutation of the dims, CCD one for each sweep from the key's
    split, iALS++ a permutation of the blocks."""
    from matfac_tpu_torch.solvers.ccd import CCDPPSolver, CCDSolver
    if not hasattr(self, "_jax_key"):
        self._jax_key = jax.random.PRNGKey(self.params.seed)
    self._jax_key, ek = jax.random.split(self._jax_key)
    perm = lambda key, n: np.asarray(jax.random.permutation(key, n))
    if isinstance(self, CCDSolver):
        k_u, k_i = jax.random.split(ek)
        return perm(k_u, self.model.k), perm(k_i, self.model.k)
    if isinstance(self, CCDPPSolver):
        return perm(ek, self.model.k)
    return perm(ek, self._block_idx.shape[0])


@pytest.fixture
def jax_coordinate_draws(monkeypatch):
    from matfac_tpu_torch.solvers.als import SubspaceALSSolver
    from matfac_tpu_torch.solvers.ccd import CCDPPSolver, CCDSolver
    for cls in (SubspaceALSSolver, CCDPPSolver, CCDSolver):
        monkeypatch.setattr(cls, "draw", _jax_chain_draw)


@pytest.mark.parametrize("method,extra,cls", [
    ("auto", {}, "ALSSolver"), ("als", {}, "ALSSolver"),
    ("als", dict(reg_exponent=0.5), "ALSSolver"),
    ("ialspp", {}, "SubspaceALSSolver"), ("alsdense", {}, "DenseALSSolver"),
    ("ccd", {}, "CCDSolver"), ("ccd++", {}, "CCDPPSolver"),
    ("ccdpp", dict(ccd_group_dims=2), "CCDPPSolver"),
    ("ccd++freqadap", {}, "CCDPPSolver"),
    ("ccd++freqadap", dict(ccd_group_dims=4), "CCDPPSolver")])
def test_train_model_coordinate_matches_jax(method, extra, cls,
                                            jax_coordinate_draws):
    """train_model(algo="mf", mf_method=m) for every method of the
    coordinate family (and 'auto', which resolves to 'als' for plain MF
    and says so) against the JAX front door from one initial state, the
    port drawing the JAX key chain's permutations, three epochs: val RMSE
    and objective at rtol 2e-3, the final state at rtol / atol 2e-3, JAX's
    engine-to-engine class (tests/test_solvers.py:452). JAX's CCD++ sums
    by differences of f32 prefix sums (its "sorted" engine, the default)
    and is off the exact sums by ~2.5e-4 an epoch here; the port's float64
    segment sums agree with JAX's "scatter" engine to ~3e-6
    (test_torch_ccd.py)."""
    data, p = _coord_data()
    p = p.replace(**extra)
    js = j_init_state(p, data.n_users, data.n_items)
    st = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    logs_j, logs_t = [], []
    rep_j, *_ = j_train_model(data, p, mf_method=method,
                              init_state_override=js, log_fn=logs_j.append)
    rep_t, *_ = train_model(data, p, mf_method=method, device="cpu",
                            init_state_override=st, log_fn=logs_t.append)
    assert type(rep_t.solver).__name__ == cls
    if method == "auto":
        pick = lambda logs: logs[0].split("'")[1]
        assert pick(logs_t) == pick(logs_j) == "als"
    if method == "ccd++freqadap":
        ok = rep_t.solver.item_dim_ok
        assert 0 < float(ok.sum()) < len(ok)
    if p.reg_exponent:
        assert rep_t.solver.reg_exp == 0.5
    _compare_runs(rep_t, rep_j, 2e-3, 2e-3)


def test_ccd_requires_sorted_csr_like_jax():
    """JAX's train_model refuses CCD on a CSR whose rows are not sorted by
    column (main.cpp:1245); so does the port."""
    data, p = _coord_data()
    m = data.train_mat
    starts = np.nonzero(np.diff(m.indptr) > 1)[0][0]
    a = m.indptr[starts]
    m.indices[a:a + 2] = m.indices[a:a + 2][::-1].copy()
    m.values[a:a + 2] = m.values[a:a + 2][::-1].copy()
    assert not m.is_sorted()
    for fn, kw in ((j_train_model, {}), (train_model, dict(device="cpu"))):
        with pytest.raises(ValueError, match="sorted CSR"):
            fn(data, p, mf_method="ccd", log_fn=lambda s: None, **kw)


@pytest.mark.parametrize("method", ["ccd++", "ccd"])
def test_ccd_rollback_matches_jax(method, monkeypatch, jax_coordinate_draws):
    """A non-finite objective at the second epoch's check (a patched
    evaluator in both packages): both loops roll back to the best
    snapshot, halve lr and reset the solver, whose next epoch zeroes u and
    restarts the residual from the ratings; the port's history and final
    factors hold JAX's at 2e-3, as in the parity test above. Without the
    reset the port would go on from the residual of the rolled-back
    epoch."""
    from matfac_tpu.eval.metrics import Evaluator as JEvaluator
    from matfac_tpu_torch.eval.metrics import Evaluator
    from matfac_tpu_torch.solvers.ccd import CCDPPSolver

    def nan_at(cls, n):
        orig = cls.objective
        calls = []

        def objective(self, *a, **kw):
            calls.append(1)
            v = orig(self, *a, **kw)
            return float("nan") if len(calls) == n else v
        monkeypatch.setattr(cls, "objective", objective)

    nan_at(JEvaluator, 3)   # the initial check, then epochs 0, 1
    nan_at(Evaluator, 3)
    resets = []
    orig_reset = CCDPPSolver.reset
    monkeypatch.setattr(CCDPPSolver, "reset",
                        lambda self: resets.append(1) or orig_reset(self))
    data, p = _coord_data()
    p = p.replace(learn_rate=0.1, max_iter=4)
    js = j_init_state(p, data.n_users, data.n_items)
    st = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    logs = []
    rep_j, *_ = j_train_model(data, p, mf_method=method,
                              init_state_override=js, log_fn=logs.append)
    rep_t, *_ = train_model(data, p, mf_method=method, device="cpu",
                            init_state_override=st, log_fn=logs.append)
    assert sum("rollback" in s for s in logs) == 2
    assert len(resets) == 1
    assert [h.epoch for h in rep_t.history] == [0, 2, 3]
    assert rep_t.history[-1].lr == pytest.approx(0.05)
    _compare_runs(rep_t, rep_j, 2e-3, 2e-3)
