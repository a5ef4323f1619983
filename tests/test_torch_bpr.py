"""The port's BPR path (matfac_tpu_torch.models.bpr, .solvers.bpr,
.train.loop.TrainLoopHR and train_model(algo="bpr")) against the JAX
package, with the JAX package's random draws injected: the same 32-bit
words give the same negatives, so the epochs differ only in the order the
scatters add duplicates (factors at rtol 1e-5 / atol 1e-6, loss at
rtol 1e-5, inversions exactly)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import leave_one_out_data, synthetic_data
from matfac_tpu.models.base import MFState as JState
from matfac_tpu.models.bpr import ModelMFBPR as JModelMFBPR
from matfac_tpu.solvers import bpr as jbpr
from matfac_tpu.train.loop import train_model as j_train_model
from matfac_tpu.utils import freq
from matfac_tpu_torch.models.base import state_from_numpy
from matfac_tpu_torch.models.bpr import ModelMFBPR
from matfac_tpu_torch.ops.bpr_step import bpr_pair_terms
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
    """Implicit feedback with explicit zeros (a third of the train entries)
    and never-rated items, so every sampler branch is taken."""
    data = leave_one_out_data(n_users=80, n_items=120, per_user=14, seed=6,
                              structured=True)
    data.train_mat.values[::3] = 0.0
    return data


def _pair(data, params, **kw):
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    js = jbpr.BPRSolver(JModelMFBPR(params, data.n_users, data.n_items),
                        params, data.train_mat, iu, ii, **kw)
    ts = tbpr.BPRSolver(ModelMFBPR(params, data.n_users, data.n_items),
                        params, data.train_mat, iu, ii, device="cpu", **kw)
    return js, ts


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("sampler", ["rankgap", "gap"])
def test_stream_samplers_match_jax_on_its_bits(lo_data, sampler):
    p = Params(fac_dim=4, seed=0, batch_size=256)
    js, ts = _pair(lo_data, p, batch_size=256, n_tries=3, sampler=sampler)
    B = 256
    jj, jb = _words((3, B), 1), _words((3, B), 2)
    start, deg = js.pos_start[:B], js.pos_deg[:B]
    if sampler == "rankgap":
        want = js._sample_rankgap_bits(start, deg, jnp.asarray(jj),
                                       jnp.asarray(jb), js.csr_packed4,
                                       js.sel_items)
        got = ts.sample_rankgap(ts.pos_start[:B], ts.pos_deg[:B], _i64(jj),
                                _i64(jb))
    else:
        want = js._sample_gap_bits(js.pos_u[:B], start, deg,
                                   jnp.asarray(jj), jnp.asarray(jb),
                                   (js.csr_packed, js.train_items))
        got = ts.sample_gap(ts.pos_start[:B], ts.pos_deg[:B], _i64(jj),
                            _i64(jb))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    ok = got[1].numpy()
    assert 0.5 < ok.mean() < 1.0   # some tries fail: both branches run
    np.testing.assert_array_equal(ts.pos_u.numpy(), np.asarray(js.pos_u))
    np.testing.assert_array_equal(ts.pos_i.numpy(), np.asarray(js.pos_i))


def _start_state(data, k, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.normal(0, scale, (data.n_users, k)),
        rng.normal(0, scale, (data.n_items, k)),
        np.zeros(data.n_users), np.zeros(data.n_items), np.asarray(0.0)))


def _jax_epoch_draws(js, key):
    """The (border, bits) the JAX epoch draws from ``key``."""
    nb, B = js.n_batches, js.batch_size
    if js.mode == "posneg":
        k_bits, _ = jax.random.split(key)
        return None, _i64(jax.random.bits(
            k_bits, (nb, 2 + 2 * js.n_tries, B), jnp.uint32))
    k_ord, k_bits, _ = jax.random.split(key, 3)
    return (_i64(jax.random.permutation(k_ord, nb)),
            _i64(jax.random.bits(k_bits, (nb, 2, js.n_tries, B),
                                 jnp.uint32)))


@pytest.mark.parametrize("mode,sampler", [("stream", "rankgap"),
                                          ("stream", "gap"),
                                          ("posneg", "rankgap")])
def test_one_epoch_matches_jax_with_its_draws(lo_data, mode, sampler):
    p = Params(fac_dim=5, seed=2, batch_size=128, u_reg=0.01, i_reg=0.02)
    js, ts = _pair(lo_data, p, batch_size=128, n_tries=2, mode=mode,
                   sampler=sampler)
    leaves = _start_state(lo_data, 5, 3)
    key = jax.random.PRNGKey(7)
    lr = 0.2
    jst = js.epoch(JState(*(jnp.asarray(a) for a in leaves)), lr, key)
    tst = ts.epoch_with(state_from_numpy(*leaves, device="cpu"), lr,
                        *_jax_epoch_draws(js, key))
    for got, want in ((tst.u_fac, jst.u_fac), (tst.i_fac, jst.i_fac)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    moved = np.abs(tst.i_fac.numpy() - leaves[1]).max()
    assert moved > 100 * ATOL
    assert float(ts.last_loss) == pytest.approx(float(js.last_loss),
                                                rel=RTOL)
    assert int(ts.last_inversions) == int(js.last_inversions) > 0


def test_pair_terms_match_jax_and_stay_finite():
    rng = np.random.default_rng(0)
    pu, qp, qn = (rng.normal(0, 1, (64, 6)).astype(np.float32)
                  for _ in range(3))
    w = (rng.random(64) < 0.8).astype(np.float32)
    pu[:4] *= 40.0   # |r| ~ 1e3: ln(1 + e^-r) overflows without logaddexp
    want = jbpr.bpr_pair_terms(*(jnp.asarray(a) for a in (pu, qp, qn, w)),
                               None, 0.01, 0.03)
    got = bpr_pair_terms(*(torch.from_numpy(a) for a in (pu, qp, qn, w)),
                         0.01, 0.03)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
    assert np.isfinite(float(got[4])) and float(got[4]) > 0


# ----------------------------------------------------------------------
# the loop and the front door, with the JAX key chain injected
# ----------------------------------------------------------------------

def _jax_loop_draw(self):
    """Stand-in for BPRSolver.draw: TrainLoopHR's key chain
    (PRNGKey(seed), one split per epoch) into the JAX epoch's draws."""
    if not hasattr(self, "_jkey"):
        self._jkey = jax.random.PRNGKey(self.params.seed)
    self._jkey, ek = jax.random.split(self._jkey)
    return _jax_epoch_draws(self, ek)


def _bpr_params(**kw):
    base = dict(fac_dim=6, u_reg=0.001, i_reg=0.001, learn_rate=0.3,
                max_iter=8, seed=2, batch_size=256, disp_iter=1000,
                save_iter=1, eval_user_block=128, eval_item_block=128)
    base.update(kw)
    return Params(**base)


@pytest.mark.parametrize("mf_method", ["train", "hog", "posneg"])
def test_train_model_bpr_matches_jax(lo_data, tmp_path, monkeypatch,
                                     mf_method):
    """'train' selects on val HR@10, 'hog' and 'posneg' on val NDCG@10 (val
    rows of >= 2 entries, so a rating matrix here). 'posneg' runs with
    bpr_engine="dense": both front doors train posneg mode on BPRSolver
    whatever the engine."""
    if mf_method in ("hog", "posneg"):
        data, _, _ = synthetic_data(n_users=70, n_items=60, k=3,
                                    density=0.3, seed=3, noise=0.1,
                                    nonneg=True)
    else:
        data = lo_data
    p = _bpr_params(**({"bpr_engine": "dense"} if mf_method == "posneg"
                       else {}))
    monkeypatch.setattr(tbpr.BPRSolver, "draw", _jax_loop_draw)
    leaves = _start_state(data, p.fac_dim, 5, scale=0.01)
    rep_j, *_ = j_train_model(
        data, p, algo="bpr", mf_method=mf_method, log_fn=lambda s: None,
        init_state_override=JState(*(jnp.asarray(a) for a in leaves)))
    prefix = str(tmp_path / "t")
    rep_t, model, scorer, _ = train_model(
        data, p, algo="bpr", mf_method=mf_method, device="cpu",
        prefix=prefix, log_fn=lambda s: None,
        init_state_override=state_from_numpy(*leaves, device="cpu"))
    assert isinstance(model, ModelMFBPR)
    assert isinstance(rep_t.solver, tbpr.BPRSolver)
    assert rep_t.solver.mode == ("posneg" if mf_method == "posneg"
                                 else "stream")
    assert rep_t.stop_reason == rep_j.stop_reason
    assert rep_t.best_iter == rep_j.best_iter
    assert len(rep_t.history) == len(rep_j.history) == p.max_iter
    hr_t = [h.val_rmse for h in rep_t.history]
    hr_j = [h.val_rmse for h in rep_j.history]
    if mf_method == "train":
        assert hr_t == hr_j
    else:
        np.testing.assert_allclose(hr_t, hr_j, rtol=RTOL)
    assert rep_t.best_metric == pytest.approx(rep_j.best_metric, rel=RTOL)
    np.testing.assert_allclose([h.objective for h in rep_t.history],
                               [h.objective for h in rep_j.history],
                               rtol=1e-4)
    assert [h.lr for h in rep_t.history] == pytest.approx(
        [h.lr for h in rep_j.history], rel=1e-12)


def test_hr_loop_resume_is_exact(lo_data, tmp_path):
    """A run stopped at epoch 4 and resumed reaches the uninterrupted
    run's state: lr, best snapshot, loss, inversions and the solver's
    generator are in the checkpoint."""
    p = _bpr_params(max_iter=8, learn_rate=0.1)
    run = lambda prefix, params, resume: train_model(
        lo_data, params, algo="bpr", device="cpu",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=4), False)
    res = run("part", p, True)
    assert torch.equal(full.state.u_fac, res.state.u_fac)
    assert torch.equal(full.state.i_fac, res.state.i_fac)
    assert full.best_metric == res.best_metric
    assert full.best_iter == res.best_iter
    assert [h.val_rmse for h in full.history[4:]] == \
        [h.val_rmse for h in res.history]


def test_bpr_training_lifts_hr(lo_data):
    """The solver's own draws: val HR@10 rises well above its value at
    the initial state."""
    p = _bpr_params(max_iter=15)
    rep, model, scorer, _ = train_model(lo_data, p, algo="bpr",
                                        mf_method="auto", device="cpu",
                                        log_fn=lambda s: None)
    assert rep.best_metric > 0.3 and rep.best_iter >= 0
