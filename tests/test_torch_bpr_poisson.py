"""The port's BPR x TMF+Poisson hybrid (matfac_tpu_torch.models.bpr
.ModelBPRPoissonDropout, the triple rank masks in solvers.bpr and
train_model(algo="bpr_poisson")) against the JAX package, with JAX's random
draws injected: the batch order and sampler words, and for the sampled
ranks the per-step masks that JAX's triple_rank_mask draws from its own
per-step keys. Tolerances: factors at rtol 1e-5 / atol 1e-6 and the loss at
rtol 1e-5 (f32 sums in another order), inversions, rank tables, masks,
stop reasons, best epochs and HR histories exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import leave_one_out_data
from matfac_tpu.models.base import MFState as JState
from matfac_tpu.models.bpr import ModelBPRPoissonDropout as JHybrid
from matfac_tpu.serving import Recommender as JRecommender
from matfac_tpu.solvers import bpr as jbpr
from matfac_tpu.train import checkpoint as jckpt
from matfac_tpu.train.loop import train_model as j_train_model
from matfac_tpu.utils import freq
from matfac_tpu_torch.models.base import init_state, state_from_numpy
from matfac_tpu_torch.models.bpr import ModelBPRPoissonDropout, ModelMFBPR
from matfac_tpu_torch.ops.bpr_step import bpr_pair_terms
from matfac_tpu_torch.serving import Recommender
from matfac_tpu_torch.solvers import bpr as tbpr
from matfac_tpu_torch.train.loop import train_model

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lo_data():
    """Implicit feedback with explicit zeros and never-rated items, as the
    plain BPR tests use; item degrees spread, so the ranks do too."""
    data = leave_one_out_data(n_users=80, n_items=120, per_user=14, seed=6,
                              structured=True)
    data.train_mat.values[::3] = 0.0
    return data


def _freqs(data):
    uf, if_ = freq.row_col_freq(data.train_mat)
    pad = lambda a, n: np.pad(a, (0, max(n - len(a), 0)))[:n]
    return pad(uf, data.n_users), pad(if_, data.n_items)


def _models(data, p, sample):
    uf, if_ = _freqs(data)
    args = (p, data.n_users, data.n_items, uf, if_)
    return (JHybrid(*args, sample_poisson=sample),
            ModelBPRPoissonDropout(*args, sample_poisson=sample))


def _params(**kw):
    base = dict(fac_dim=6, u_reg=0.001, i_reg=0.001, learn_rate=0.3,
                max_iter=8, seed=2, batch_size=128, disp_iter=1000,
                save_iter=1, eval_user_block=128, eval_item_block=128,
                rho_rms=1.0, alpha=0.0)
    base.update(kw)
    return Params(**base)


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _j32(t):
    return jnp.asarray(t.numpy().astype(np.int32))


def jax_draws(ts, jmodel, key, with_masks=True):
    """(border, bits, masks) of one JAX epoch from ``key``
    (matfac_tpu/solvers/bpr.py: stream ``k_ord, k_bits, k = split(key,
    3)``, posneg ``k_bits, k = split(key)``, then one mask key a step,
    ``split(k, n_batches)``). Step t's mask is JAX's triple_rank_mask on
    that step's triple; its negatives come from the port's sampler, which
    equals JAX's bit for bit on the same words."""
    nb, B, nt = ts.n_batches, ts.batch_size, ts.n_tries
    if ts.mode == "posneg":
        k_bits, k_m = jax.random.split(key)
        border = None
        bits = _i64(jax.random.bits(k_bits, (nb, 2 + 2 * nt, B),
                                    jnp.uint32))
    else:
        k_ord, k_bits, k_m = jax.random.split(key, 3)
        border = _i64(jax.random.permutation(k_ord, nb))
        bits = _i64(jax.random.bits(k_bits, (nb, 2, nt, B), jnp.uint32))
    if not with_masks:
        return border, bits, None
    keys = jax.random.split(k_m, nb)
    masks = []
    for t in range(nb):
        if ts.mode == "posneg":
            u, p, neg, _ = ts.sample_posneg(bits[t])
        else:
            sl = slice(int(border[t]) * B, (int(border[t]) + 1) * B)
            sample = (ts.sample_rankgap if ts.sampler == "rankgap"
                      else ts.sample_gap)
            neg, _ = sample(ts.pos_start[sl], ts.pos_deg[sl], bits[t, 0],
                            bits[t, 1])
            u, p = ts.pos_u[sl], ts.pos_i[sl]
        masks.append(np.array(jmodel.triple_rank_mask(
            keys[t], _j32(u), _j32(p), _j32(neg))))
    return border, bits, masks


def _start_state(data, k, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.normal(0, scale, (data.n_users, k)),
        rng.normal(0, scale, (data.n_items, k)),
        np.zeros(data.n_users), np.zeros(data.n_items), np.asarray(0.0)))


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

def test_hybrid_tables_match_jax(lo_data):
    """Lambda tables (TMF's sigmoid ranks), the CDF inference ranks and
    the rank-truncated eval view, exactly; plain BPR has no mask."""
    p = _params()
    jm, tm = _models(lo_data, p, True)
    for got, want in ((tm.lambda_u, jm.lambda_u), (tm.lambda_i, jm.lambda_i),
                      (tm.rank_u, jm.rank_u), (tm.rank_i, jm.rank_i)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 1 <= int(tm.lambda_i.min()) < int(tm.lambda_i.max()) <= p.fac_dim
    assert bool((tm.rank_i >= tm.lambda_i).all())
    leaves = _start_state(lo_data, p.fac_dim, 1)
    jv = jm.eval_view(JState(*(jnp.asarray(a) for a in leaves)))
    tv = tm.eval_view(state_from_numpy(*leaves, device="cpu"))
    for got, want in zip(tv, jv):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z = torch.zeros(3, dtype=torch.int64)
    assert ModelMFBPR(p, 4, 4).triple_rank_mask(z, z, z) is None
    assert tm.name == jm.name == "bpr_poisson" and tm.is_ranking


def test_sigmoid_triple_mask_matches_jax(lo_data):
    """trainSigmoid's deterministic mask: the least frequent of the three
    entities' lambda, exactly."""
    p = _params()
    jm, tm = _models(lo_data, p, False)
    rng = np.random.default_rng(0)
    u, i, j = (rng.integers(0, n, 300) for n in (lo_data.n_users,
                                                  lo_data.n_items,
                                                  lo_data.n_items))
    got = tm.triple_rank_mask(*(_i64(a) for a in (u, i, j)))
    want = jm.triple_rank_mask(jax.random.PRNGKey(0),
                               *(jnp.asarray(a.astype(np.int32))
                                 for a in (u, i, j)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.mean()) < 1


def test_sampled_triple_mask_is_a_clipped_poisson_draw(lo_data):
    """train's sampled ranks: clip(Poisson(lambda), 1, k) from the given
    generator (reproducible by its seed), with the mean of JAX's draws on
    the same triples within sampling noise."""
    p = _params(fac_dim=16)
    jm, tm = _models(lo_data, p, True)
    n = 20_000
    rng = np.random.default_rng(1)
    u, i, j = (rng.integers(0, m, n) for m in (lo_data.n_users,
                                                lo_data.n_items,
                                                lo_data.n_items))
    idx = tuple(_i64(a) for a in (u, i, j))
    draw = lambda s: tm.triple_rank_mask(
        *idx, generator=torch.Generator().manual_seed(s))
    a, b = draw(5), draw(5)
    assert torch.equal(a, b) and not torch.equal(a, draw(6))
    ranks = a.sum(1)
    assert float(ranks.min()) >= 1 and float(ranks.max()) <= p.fac_dim
    # the mask is a prefix: dims j < rank
    assert torch.equal(a, (torch.arange(p.fac_dim)[None, :]
                           < ranks[:, None]).float())
    want = np.asarray(jm.triple_rank_mask(
        jax.random.PRNGKey(3), *(jnp.asarray(x.astype(np.int32))
                                 for x in (u, i, j)))).sum(1)
    assert abs(float(ranks.mean()) - want.mean()) < 0.05 * want.mean()


def test_pair_terms_with_a_mask_match_jax():
    rng = np.random.default_rng(0)
    pu, qp, qn = (rng.normal(0, 1, (64, 6)).astype(np.float32)
                  for _ in range(3))
    w = (rng.random(64) < 0.8).astype(np.float32)
    m = (np.arange(6)[None, :] < rng.integers(1, 7, 64)[:, None]
         ).astype(np.float32)
    want = jbpr.bpr_pair_terms(*(jnp.asarray(a) for a in (pu, qp, qn, w,
                                                           m)), 0.01, 0.03)
    got = bpr_pair_terms(*(torch.from_numpy(a) for a in (pu, qp, qn, w)),
                         0.01, 0.03, torch.from_numpy(m))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
    # masked dims take no gradient
    assert float(got[0].numpy()[m == 0].__abs__().max()) == 0.0


# ----------------------------------------------------------------------
# one epoch with JAX's draws
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sample", [True, False])
@pytest.mark.parametrize("mode,sampler", [("stream", "rankgap"),
                                          ("stream", "gap"),
                                          ("posneg", "rankgap")])
def test_hybrid_epoch_matches_jax_with_its_draws(lo_data, mode, sampler,
                                                 sample):
    """Sampled ranks take JAX's per-step masks; sigmoid ranks are the
    port's own (deterministic) masks, given no masks."""
    p = _params(fac_dim=5, u_reg=0.01, i_reg=0.02)
    jm, tm = _models(lo_data, p, sample)
    kw = dict(batch_size=128, n_tries=2, mode=mode, sampler=sampler)
    iu, ii = freq.invalid_users_items(lo_data.train_mat, lo_data.n_users,
                                      lo_data.n_items)
    js = jbpr.BPRSolver(jm, p, lo_data.train_mat, iu, ii, **kw)
    ts = tbpr.BPRSolver(tm, p, lo_data.train_mat, iu, ii, device="cpu",
                        **kw)
    leaves = _start_state(lo_data, 5, 3)
    key = jax.random.PRNGKey(7)
    lr = 0.2
    jst = js.epoch(JState(*(jnp.asarray(a) for a in leaves)), lr, key)
    tst = ts.epoch_with(state_from_numpy(*leaves, device="cpu"), lr,
                        *jax_draws(ts, jm, key, with_masks=sample))
    for got, want in ((tst.u_fac, jst.u_fac), (tst.i_fac, jst.i_fac)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    assert np.abs(tst.i_fac.numpy() - leaves[1]).max() > 100 * ATOL
    assert float(ts.last_loss) == pytest.approx(float(js.last_loss),
                                                rel=RTOL)
    assert int(ts.last_inversions) == int(js.last_inversions) > 0


# ----------------------------------------------------------------------
# the front door, with the JAX key chain injected
# ----------------------------------------------------------------------

def _jax_epoch(jmodel):
    """Stand-in for BPRSolver.epoch: TrainLoopHR's key chain (PRNGKey(seed),
    one split an epoch) into the JAX epoch's draws and masks."""
    def epoch(self, state, lr):
        if not hasattr(self, "_jkey"):
            self._jkey = jax.random.PRNGKey(self.params.seed)
        self._jkey, ek = jax.random.split(self._jkey)
        return self.epoch_with(state, lr, *jax_draws(self, jmodel, ek))
    return epoch


@pytest.mark.parametrize("algo,mf_method", [
    ("bpr_poisson", "train"), ("bpr_poisson", "sigmoid"),
    ("bprpoissondropout", "auto")])
def test_train_model_hybrid_matches_jax(lo_data, monkeypatch, algo,
                                        mf_method):
    """The same stop reason, best epoch and val HR@10 history as JAX's
    front door; losses at rtol 1e-4 (eight epochs of f32 sums)."""
    p = _params()
    jm, _ = _models(lo_data, p, mf_method != "sigmoid")
    monkeypatch.setattr(tbpr.BPRSolver, "epoch", _jax_epoch(jm))
    leaves = _start_state(lo_data, p.fac_dim, 5, scale=0.01)
    logs_j, logs_t = [], []
    rep_j, jmodel, *_ = j_train_model(
        lo_data, p, algo=algo, mf_method=mf_method, log_fn=logs_j.append,
        init_state_override=JState(*(jnp.asarray(a) for a in leaves)))
    rep_t, model, *_ = train_model(
        lo_data, p, algo=algo, mf_method=mf_method, device="cpu",
        log_fn=logs_t.append,
        init_state_override=state_from_numpy(*leaves, device="cpu"))
    assert isinstance(model, ModelBPRPoissonDropout)
    assert isinstance(rep_t.solver, tbpr.BPRSolver)
    assert model.sample_poisson == jmodel.sample_poisson == (
        mf_method != "sigmoid")
    if mf_method == "auto":
        assert "resolved to 'train'" in logs_t[0] and \
            "resolved to 'train'" in logs_j[0]
    assert rep_t.stop_reason == rep_j.stop_reason
    assert rep_t.best_iter == rep_j.best_iter
    assert len(rep_t.history) == len(rep_j.history) == p.max_iter
    assert [h.val_rmse for h in rep_t.history] == \
        [h.val_rmse for h in rep_j.history]
    assert rep_t.best_metric == rep_j.best_metric
    np.testing.assert_allclose([h.objective for h in rep_t.history],
                               [h.objective for h in rep_j.history],
                               rtol=1e-4)
    for got, want in zip(rep_t.best_state[:2], rep_j.best_state[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def test_hybrid_training_lifts_hr(lo_data):
    """The solver's own draws and masks: val HR@10 rises well above its
    value at the initial state (0.1375 -> 0.25 here; the truncated ranks
    hold the hybrid below plain BPR's 0.3+ on this data)."""
    p = _params(max_iter=12)
    rep, model, scorer, _ = train_model(lo_data, p, algo="bpr_poisson",
                                        device="cpu", log_fn=lambda s: None)
    s0 = init_state(p, lo_data.n_users, lo_data.n_items, device="cpu")
    hr0 = scorer.hit_rate(model.eval_view(s0), lo_data.val_mat, 10)
    assert rep.best_metric > 1.5 * hr0 and rep.best_iter >= 0


def test_hybrid_resume_is_exact(lo_data, tmp_path):
    """The mask generator is part of the checkpoint: a run stopped at
    epoch 4 and resumed reaches the uninterrupted run's state."""
    p = _params(max_iter=8, learn_rate=0.1)
    run = lambda prefix, params, resume: train_model(
        lo_data, params, algo="bpr_poisson", device="cpu",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=4), False)
    res = run("part", p, True)
    assert torch.equal(full.state.u_fac, res.state.u_fac)
    assert torch.equal(full.state.i_fac, res.state.i_fac)
    assert [h.val_rmse for h in full.history[4:]] == \
        [h.val_rmse for h in res.history]


def test_recommender_answers_a_hybrid_checkpoint(lo_data, tmp_path):
    """Recommender.from_checkpoint(model=ModelBPRPoissonDropout) ranks the
    CDF-truncated view, as JAX's Recommender does with its hybrid: ids
    exactly, scores at rtol 1e-5 / atol 1e-6; the untruncated model
    ranks otherwise."""
    p = _params()
    jm, tm = _models(lo_data, p, True)
    leaves = _start_state(lo_data, p.fac_dim, 9, scale=1.0)
    sig = jckpt.model_signature(p, lo_data.n_users, lo_data.n_items)
    prefix = str(tmp_path / "hybrid")
    jckpt.save_facs(JState(*(jnp.asarray(a) for a in leaves)), prefix, sig)
    jrec = JRecommender.from_checkpoint(prefix, p, lo_data, model=jm,
                                        user_block=16, item_block=16,
                                        use_pallas=False)
    trec = Recommender.from_checkpoint(prefix, p, lo_data, model=tm,
                                       device="cpu", user_block=16,
                                       item_block=16)
    users = list(range(0, lo_data.n_users, 3))
    ji, jsc = jrec.recommend(users, n=8)
    ti, tsc = trec.recommend(users, n=8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tsc, jsc, rtol=RTOL, atol=ATOL)
    plain = Recommender.from_checkpoint(prefix, p, lo_data, device="cpu",
                                        user_block=16, item_block=16)
    assert not np.array_equal(plain.recommend(users, n=8)[0], ti)
