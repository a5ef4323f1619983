"""The port's othersrc models (matfac_tpu_torch.models.longtail:
ModelAdaptiveDropoutMF, ModelDropoutSigmoidBias, ModelLocalityMF,
ModelSideGatedMF, ModelHeadWeightedMF) and their front door against the
JAX package: every model hook on the same inputs, the sampled training
ranks from JAX's uniforms, scatter epochs with JAX's batch order and masks,
train_model for each algo and spelling with the JAX key chain's draws, and
the mf_freq curriculum's five stages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.models import base as jbase
from matfac_tpu.models import longtail as jlt
from matfac_tpu.solvers.sgd import SGDSolver as JSGDSolver
from matfac_tpu.train.loop import train_model as j_train_model
from matfac_tpu.utils import freq
from matfac_tpu_torch.models import longtail as tlt
from matfac_tpu_torch.models.base import rank_mask, state_from_numpy
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
from matfac_tpu_torch.solvers.sgd import SGDSolver
from matfac_tpu_torch.train.loop import train_model

from test_torch_sgd import jax_draws
from test_torch_train import _compare_runs, _jax_dense_draw, _jax_diag_draw


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _small():
    """The JAX othersrc tests' data (tests/test_othersrc_models.py):
    power-law degrees, so heads, tails and quartiles are all populated."""
    data, _, _ = synthetic_data(n_users=80, n_items=60, k=3, density=0.3,
                                seed=4, noise=0.05, power_law=0.8,
                                nonneg=True)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    uf, if_ = freq.row_col_freq(data.train_mat)
    return data, iu, ii, uf, if_


# (model, dropout mode or None); gate stages of mf_freq as "gates:<stage>"
MODELS = ["dropoutmf:prob", "dropoutmf:ordered", "dropoutmf:onlyordered",
          "tmf_bias", "mf_loc", "gates:full", "gates:head-only",
          "gates:tail-items", "gates:tail-users", "mf_headwt"]


def _gates(stage, data, iu, ii, uf, if_):
    hu = freq.head_items_from_freq(uf, 0.8)
    hi = freq.head_items_from_freq(if_, 0.8)
    none_u = np.zeros(data.n_users, bool)
    none_i = np.zeros(data.n_items, bool)
    return {"full": (~iu, ~ii), "head-only": (hu & ~iu, hi & ~ii),
            "tail-items": (none_u, ~hi & ~ii),
            "tail-users": (~hu & ~iu, none_i)}[stage]


def _pair(name, p, data, iu, ii, uf, if_):
    """(JAX model, port model) built from the same numpy inputs."""
    n, m = data.n_users, data.n_items
    kind, _, arg = name.partition(":")
    if kind == "dropoutmf":
        return tuple(c(p, n, m, uf, if_, mode=arg) for c in (
            jlt.ModelAdaptiveDropoutMF, tlt.ModelAdaptiveDropoutMF))
    if kind == "tmf_bias":
        return tuple(c(p, n, m, uf, if_) for c in (
            jlt.ModelDropoutSigmoidBias, tlt.ModelDropoutSigmoidBias))
    if kind == "mf_loc":
        hu = freq.head_items_from_freq(uf, 0.8)
        hi = freq.head_items_from_freq(if_, 0.8)
        return tuple(c(p, n, m, hu, hi) for c in (
            jlt.ModelLocalityMF, tlt.ModelLocalityMF))
    if kind == "gates":
        gu, gi = _gates(arg, data, iu, ii, uf, if_)
        return tuple(c(p, n, m, gu, gi) for c in (
            jlt.ModelSideGatedMF, tlt.ModelSideGatedMF))
    head = freq.head_items_from_freq(if_, 0.5)
    return tuple(c(p, n, m, head, lambda0=0.8) for c in (
        jlt.ModelHeadWeightedMF, tlt.ModelHeadWeightedMF))


def _idx(data, n=500, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, data.n_users, n)
    i = rng.integers(0, data.n_items, n)
    return (jnp.asarray(u.astype(np.int32)), jnp.asarray(i.astype(np.int32)),
            torch.from_numpy(u), torch.from_numpy(i))


def _same(got, want):
    """Equal values and shapes (tensors and JAX arrays through f32)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("freqs", [
    [100, 90, 80, 70, 60, 50, 40, 30, 20, 10, 5, 1],
    [3, 3, 3, 1, 1, 7, 7, 0, 0, 2], [5], [2, 9], [4, 4, 4], "random"])
@pytest.mark.parametrize("k", [1, 4, 16, 64])
def test_adaptive_rank_map_matches_jax(freqs, k):
    """Descending-frequency quartiles of ranks k, k/2, k/4, k/8 (floor 1),
    ties in id order, the 4th part taking the remainder and the tiny-n
    guard: the port's copy gives JAX's ranks."""
    if freqs == "random":
        freqs = np.random.default_rng(k).integers(0, 6, 101)
    f = np.asarray(freqs, np.float64)
    got = tlt.adaptive_rank_map(f, k)
    want = jlt.adaptive_rank_map(f, k)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_model_hooks_match_jax(name):
    """example_weight, pair_rank, entity_ranks, update_side_masks,
    transform_init_state, eval_view (dropoutmf's 2k-wide view at f32
    exactness: same products in the same order) and the static
    update_rank_mask of each model, on the same indices and state."""
    data, iu, ii, uf, if_ = _small()
    p = Params(fac_dim=16, seed=5, rho_rms=0.3)
    j, t = _pair(name, p, data, iu, ii, uf, if_)
    assert (t.name, t.use_bias, t.stochastic_rank) == \
        (j.name, j.use_bias, getattr(j, "stochastic_rank", False))
    ju, ji, tu, ti = _idx(data)
    _same(t.example_weight(tu, ti), j.example_weight(ju, ji))
    assert hasattr(t, "pair_rank") == hasattr(j, "pair_rank")
    if hasattr(j, "pair_rank"):
        _same(t.pair_rank(tu, ti), j.pair_rank(ju, ji))
    jr, tr = j.entity_ranks(), t.entity_ranks()
    assert (jr is None) == (tr is None)
    for got, want in zip(tr or (), jr or ()):
        assert got.dtype == torch.int32
        _same(got, want)
    js, ts = j.update_side_masks(ju, ji), t.update_side_masks(tu, ti)
    assert (js is None) == (ts is None)
    for got, want in zip(ts or (), js or ()):
        _same(got, want)
    if not getattr(j, "stochastic_rank", False):
        jm = j.update_rank_mask(None, ju, ji)
        tm = t.update_rank_mask(tu, ti)
        assert (jm is None) == (tm is None)
        if jm is not None:
            _same(tm, jm)
    s0 = jbase.init_state(p, data.n_users, data.n_items, seed=3)
    st = state_from_numpy(*(np.asarray(a) for a in s0), device="cpu")
    for got, want in zip(t.transform_init_state(st),
                         j.transform_init_state(s0)):
        _same(got, want)
    for got, want in zip(t.eval_view(st), j.eval_view(s0)):
        _same(got, want)


def test_mf_loc_zeroes_the_tail_halves_of_a_loaded_state():
    """transform_init_state zeroes dims >= k/2 of every tail entity, and
    only those, of any state it is given (train_model applies it to loaded
    factors too)."""
    data, iu, ii, uf, if_ = _small()
    p = Params(fac_dim=6)
    _, t = _pair("mf_loc", p, data, iu, ii, uf, if_)
    ones = state_from_numpy(np.ones((data.n_users, 6), np.float32),
                            np.ones((data.n_items, 6), np.float32),
                            np.zeros(data.n_users, np.float32),
                            np.zeros(data.n_items, np.float32),
                            np.float32(0), device="cpu")
    out = t.transform_init_state(ones)
    for fac, ranks in ((out.u_fac, t.rank_u), (out.i_fac, t.rank_i)):
        assert set(ranks.tolist()) == {3, 6}
        np.testing.assert_array_equal(fac.numpy(),
                                      rank_mask(ranks, 6).numpy())


@pytest.mark.parametrize("rho", [1.0, 0.3, 0.0])
@pytest.mark.parametrize("mode", ["prob", "ordered", "onlyordered"])
def test_dropoutmf_rank_masks_from_jax_uniforms(mode, rho):
    """update_rank_mask's rule fed the uniforms JAX's draws from its key
    (lift from the first half of split(key) and the cap from the second;
    'onlyordered' caps from the key itself) gives JAX's masks. rho_rms 1
    lifts every pair to full rank; rho_rms 0 < eps means 0.3."""
    data, iu, ii, uf, if_ = _small()
    p = Params(fac_dim=16, seed=5, rho_rms=rho)
    j, t = _pair(f"dropoutmf:{mode}", p, data, iu, ii, uf, if_)
    assert t.rho == j.rho == (0.3 if rho == 0.0 else rho)
    ju, ji, tu, ti = _idx(data, n=4096, seed=1)
    key = jax.random.PRNGKey(3)
    shape = (len(tu),)
    if mode == "onlyordered":
        lift = torch.zeros(shape)
        cap = torch.from_numpy(np.array(jax.random.uniform(key, shape)))
    else:
        k1, k2 = jax.random.split(key)
        lift = torch.from_numpy(np.array(jax.random.uniform(k1, shape)))
        cap = torch.from_numpy(np.array(jax.random.uniform(k2, shape)))
    ranks = t.ranks_from_uniforms(tu, ti, lift, cap)
    want = np.asarray(j.update_rank_mask(key, ju, ji))
    np.testing.assert_array_equal(rank_mask(ranks, 16).numpy(), want)
    # the generator path draws ranks of the same rule
    got = t.update_rank_mask(tu, ti, generator=torch.Generator()
                             .manual_seed(0)).sum(dim=1).long()
    pair = t.pair_rank(tu, ti).long()
    allowed = {16, t.cand} | set(pair.tolist()) \
        | set(torch.clamp(pair, max=t.cand).tolist())
    assert set(got.tolist()) <= allowed
    assert len(set(got.tolist())) > 1 or mode == "prob" and rho == 1.0


# (model, collision_norm)
EPOCH_CASES = [(m, True) for m in MODELS] + [
    ("tmf_bias", False), ("mf_loc", False), ("dropoutmf:ordered", False),
    ("mf_headwt", False)]


@pytest.mark.parametrize("name,cn", EPOCH_CASES)
def test_scatter_epochs_match_jax_with_its_draws(name, cn):
    """Two scatter epochs of each model through epoch_with, fed JAX's batch
    order and per-step masks (tests/test_torch_sgd.jax_draws): biases with
    static rank masks and no global mean (tmf_bias), [B, k] side masks
    (mf_loc) and [B, 1] gates (the mf_freq stages), sampled masks with no
    pair_lambda (dropoutmf), 0.8 head weights (mf_headwt); factors and
    biases at rtol 1e-5 / atol 1e-6, as tests/test_torch_sgd.py."""
    data, iu, ii, uf, if_ = _small()
    p = Params(fac_dim=8, u_reg=0.05, i_reg=0.02, learn_rate=0.05, seed=3,
               batch_size=64, rho_rms=0.3)
    jm, tm = _pair(name, p, data, iu, ii, uf, if_)
    j = JSGDSolver(jm, p, data.train_mat, iu, ii, collision_norm=cn)
    t = SGDSolver(tm, p, data.train_mat, iu, ii, collision_norm=cn,
                  device="cpu")
    sj = jm.transform_init_state(
        jbase.init_state(p, data.n_users, data.n_items, seed=4))
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    start = [a.clone() for a in st]
    key = jax.random.PRNGKey(9)
    for _ in range(2):
        key, ek = jax.random.split(key)
        border, masks = jax_draws(j, jm, ek)
        assert (masks is not None) == name.startswith("dropoutmf")
        sj = j.epoch(sj, p.learn_rate, ek)
        st = t.epoch_with(st, p.learn_rate, border, masks)
    moved = [not torch.equal(a, b) for a, b in zip(st, start)]
    assert moved[0] or moved[1]
    assert moved[2] == (name == "tmf_bias")
    for got, want in zip(st, sj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def _jax_sgd_epoch_seeded(jmodel_of):
    """Stand-in for SGDSolver.epoch: the JAX loop's key chain from the
    solver's own seed (PRNGKey(seed), one split an epoch; the mf_freq
    stage s runs JAX's loop at params.seed + s) and JAX's SGDSolver draws
    (tests/test_torch_sgd.jax_draws) for the JAX twin of the solver's
    model."""
    def epoch(self, state, lr):
        if not hasattr(self, "_jax_key"):
            self._jax_key = jax.random.PRNGKey(self.seed)
            self._jax_model = jmodel_of(self.model)
            self.orders = []
        self._jax_key, ek = jax.random.split(self._jax_key)
        border, masks = jax_draws(self, self._jax_model, ek)
        self.orders.append(np.asarray(border))
        return self.epoch_with(state, lr, border, masks)
    return epoch


def _jax_twin(data, p):
    """The JAX model of a port model, from the port model's own tables."""
    uf, if_ = freq.row_col_freq(data.train_mat)
    n, m = data.n_users, data.n_items
    uf = np.pad(uf, (0, max(n - len(uf), 0)))[:n]
    if_ = np.pad(if_, (0, max(m - len(if_), 0)))[:m]

    def twin(model):
        if isinstance(model, tlt.ModelAdaptiveDropoutMF):
            return jlt.ModelAdaptiveDropoutMF(p, n, m, uf, if_,
                                              mode=model.mode)
        if isinstance(model, tlt.ModelDropoutSigmoidBias):
            return jlt.ModelDropoutSigmoidBias(p, n, m, uf, if_)
        if isinstance(model, tlt.ModelLocalityMF):
            return jlt.ModelLocalityMF(p, n, m, model.rank_u.numpy() == p.fac_dim,
                                       model.rank_i.numpy() == p.fac_dim)
        if isinstance(model, tlt.ModelSideGatedMF):
            return jlt.ModelSideGatedMF(p, n, m, model._gate_u.numpy() > 0,
                                        model._gate_i.numpy() > 0)
        assert isinstance(model, tlt.ModelHeadWeightedMF)
        return jlt.ModelHeadWeightedMF(p, n, m, model._head.numpy(),
                                       lambda0=model.lambda0)
    return twin


def _train_data():
    data, *_ = _small()
    p = Params(fac_dim=6, u_reg=0.05, i_reg=0.05, learn_rate=0.05,
               max_iter=6, seed=1, disp_iter=1000, save_iter=1,
               batch_size=128, rho_rms=0.3)
    return data, p


def _both(data, p, algo, method, **kw):
    js = jbase.init_state(p, data.n_users, data.n_items)
    st = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    logs_j, logs_t = [], []
    rep_j, jmodel, *_ = j_train_model(data, p, algo=algo, mf_method=method,
                                      init_state_override=js,
                                      log_fn=logs_j.append, **kw)
    rep_t, tmodel, *_ = train_model(data, p, algo=algo, mf_method=method,
                                    device="cpu", init_state_override=st,
                                    log_fn=logs_t.append, **kw)
    return rep_j, rep_t, jmodel, tmodel, logs_j, logs_t


@pytest.mark.parametrize("algo,name", [
    ("tmf_bias", "tmf_bias"), ("mf_headwt", "mf_headwt"),
    ("mfwt", "mf_headwt"), ("mf_loc", "mf_loc"), ("mfloc", "mf_loc"),
    ("dropoutmf", "dropoutmf"), ("dropoutmf_prob", "dropoutmf"),
    ("dropoutmf_ordered", "dropoutmf"),
    ("dropoutmf_onlyordered", "dropoutmf"), ("mf_freq", "mf_freq"),
    ("mffreq", "mf_freq"), ("TMF_Bias", "tmf_bias")])
@pytest.mark.parametrize("method", ["sgd", "auto"])
def test_train_model_matches_jax(algo, name, method, monkeypatch):
    """train_model for each othersrc algo and spelling, on the scatter
    engine or where 'auto' resolves (JAX's choice: the scatter engine for
    every one but mf_headwt, which takes the row-dense engine at this
    size), against the JAX front door from one initial state, the port
    drawing the JAX key chain's batch orders and masks or JAX's stripe
    orders: the same model and dropout mode, val RMSE, objective and final
    state at rtol 1e-5 (1e-3 on the dense engine, its bf16 operand
    rounding), the same best epoch."""
    data, p = _train_data()
    monkeypatch.setattr(SGDSolver, "epoch",
                        _jax_sgd_epoch_seeded(_jax_twin(data, p)))
    monkeypatch.setattr(BlockSGDSolver, "draw_schedule", _jax_dense_draw)
    rep_j, rep_t, jm, tm, logs_j, logs_t = _both(data, p, algo, method)
    assert tm.name == jm.name == name
    assert getattr(tm, "mode", None) == getattr(jm, "mode", None)
    resolved = lambda logs: [s.split("'")[1] for s in logs
                             if "resolved to" in s]
    assert resolved(logs_t) == resolved(logs_j)
    dense = resolved(logs_t) == ["densesgd"]
    assert dense == (method == "auto" and name == "mf_headwt")
    assert isinstance(rep_t.solver, BlockSGDSolver if dense else SGDSolver)
    rtol = 1e-3 if dense else 1e-5
    _compare_runs(rep_t, rep_j, rtol)
    np.testing.assert_allclose(rep_t.best_metric, rep_j.best_metric,
                               rtol=rtol)


@pytest.mark.parametrize("method,draw", [("densesgd", _jax_dense_draw),
                                         ("blocksgd", _jax_diag_draw)])
def test_train_model_headwt_on_the_block_engines_matches_jax(
        method, draw, monkeypatch):
    """mf_headwt's 0.8 head weights on the row-dense engine (float W
    tiles) and the one-hot cell engine, with JAX's stripe orders or diag
    schedules: rtol 1e-3 on the dense engine (bf16 operand rounding, as
    tests/test_torch_train.py), 1e-5 on the cell engine."""
    data, p = _train_data()
    monkeypatch.setattr(BlockSGDSolver, "draw_schedule", draw)
    rep_j, rep_t, *_ = _both(data, p, "mf_headwt", method)
    sol = rep_t.solver
    assert isinstance(sol, BlockSGDSolver)
    if method == "densesgd":
        w = sol.tiles.W[sol.tiles.W > 0]
        assert sol.engine == "dense" and w.dtype != torch.int8
        assert set(np.unique(w.float().numpy())) == {np.float32(0.8), 1.0}
    _compare_runs(rep_t, rep_j, 1e-3 if method == "densesgd" else 1e-5)


def test_dropoutmf_densesgd_falls_back_to_sgd_like_jax(monkeypatch):
    """Sampled ranks on densesgd: both front doors log the fallback to the
    scatter engine and train as mf_method='sgd'."""
    data, p = _train_data()
    monkeypatch.setattr(SGDSolver, "epoch",
                        _jax_sgd_epoch_seeded(_jax_twin(data, p)))
    rep_j, rep_t, _, _, logs_j, logs_t = _both(data, p, "dropoutmf_ordered",
                                               "densesgd")
    for logs in (logs_j, logs_t):
        assert any("falling back to sgd" in s for s in logs), logs
    assert isinstance(rep_t.solver, SGDSolver)
    _compare_runs(rep_t, rep_j, 1e-5)


def test_mf_freq_stages_match_jax(monkeypatch):
    """The curriculum's five stages: the same trainable counts a stage
    (the log lines), the history's epoch numbers offset by max_iter a
    stage, the best of all stages and its epoch, and each stage drawing
    its own batch orders (seed params.seed + stage), distinct from the
    other stages'."""
    data, p = _train_data()
    p = p.replace(max_iter=3)
    solvers = []
    seeded = _jax_sgd_epoch_seeded(_jax_twin(data, p))

    def epoch(self, state, lr):
        if self not in solvers:
            solvers.append(self)
        return seeded(self, state, lr)

    monkeypatch.setattr(SGDSolver, "epoch", epoch)
    rep_j, rep_t, jm, tm, logs_j, logs_t = _both(data, p, "mf_freq", "sgd")
    stage_lines = lambda logs: [s for s in logs if "mf_freq stage" in s]
    assert stage_lines(logs_t) == stage_lines(logs_j)
    assert len(stage_lines(logs_t)) == 5
    counts = [s.split(": ")[1] for s in stage_lines(logs_t)]
    assert len(set(counts)) >= 3   # heads and tails are populated
    assert [h.epoch for h in rep_t.history] == \
        [h.epoch for h in rep_j.history] == \
        [s * 3 + e for s in range(5) for e in range(3)]
    assert rep_t.best_iter == rep_j.best_iter
    np.testing.assert_allclose(rep_t.best_metric, rep_j.best_metric,
                               rtol=1e-5)
    for got, want in zip(rep_t.best_state, rep_j.best_state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    _compare_runs(rep_t, rep_j, 1e-5)
    assert [s.seed for s in solvers] == [p.seed + s for s in range(5)]
    firsts = [tuple(s.orders[0]) for s in solvers]
    assert len(set(firsts)) == 5, firsts
    # the final stage trains every valid entity
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    assert np.all(tm._gate_u.numpy()[~iu] == 1.0)
    assert rep_t.solver is solvers[-1]


def test_sgd_solver_seed_moves_only_the_generators():
    """SGDSolver(seed=s) changes the batch-order and mask generators and
    nothing staged; seed=None is params.seed."""
    data, iu, ii, uf, if_ = _small()
    p = Params(fac_dim=4, seed=3, batch_size=32)
    model = tlt.ModelAdaptiveDropoutMF(p, data.n_users, data.n_items, uf,
                                       if_)
    a = SGDSolver(model, p, data.train_mat, iu, ii, device="cpu")
    b = SGDSolver(model, p, data.train_mat, iu, ii, seed=3, device="cpu")
    c = SGDSolver(model, p, data.train_mat, iu, ii, seed=4, device="cpu")
    assert a.seed == b.seed == 3 and c.seed == 4
    assert all(torch.equal(x, y) for x, y in ((a.rows, c.rows),
                                              (a.vals, c.vals)))
    assert torch.equal(a.batch_order(), b.batch_order())
    assert not torch.equal(a.batch_order(), c.batch_order())


@pytest.mark.parametrize("algo", ["mf_loc", "tmf_bias", "dropoutmf"])
def test_othersrc_resume_is_bit_exact(algo, tmp_path):
    """Stopped at epoch 3 and resumed to 6 equals the uninterrupted run
    (the scatter engine's generators are in the loop checkpoint)."""
    data, p = _train_data()
    run = lambda prefix, params, resume: train_model(
        data, params, algo=algo, device="cpu", prefix=str(tmp_path / prefix),
        resume=resume, log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=3), False)
    res = run("part", p, True)
    assert all(torch.equal(a, b) for a, b in zip(full.state, res.state))
