"""The port's Evaluator (matfac_tpu_torch.eval.metrics) against the JAX
Evaluator on the same data, masks and state. Both reduce in a different
order (the port sums in float64), hence rtol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.eval.metrics import Evaluator as JEvaluator
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import MFState as JState
from matfac_tpu.utils import freq
from matfac_tpu_torch.eval import metrics as tm
from matfac_tpu_torch.models.base import ModelMF, state_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(extra_invalid: bool):
    data, _, _ = synthetic_data(n_users=90, n_items=70, k=3, density=0.25,
                                seed=5, noise=0.1)
    p = Params(fac_dim=5, u_reg=0.03, i_reg=0.07)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    if extra_invalid:   # masks also filter test/val entries
        iu, ii = iu.copy(), ii.copy()
        iu[::7] = True
        ii[::5] = True
    rng = np.random.default_rng(1)
    leaves = (rng.normal(0, 0.5, (data.n_users, 5)),
              rng.normal(0, 0.5, (data.n_items, 5)),
              rng.normal(0, 0.1, data.n_users), rng.normal(0, 0.1,
                                                           data.n_items),
              np.asarray(0.3))
    leaves = tuple(np.asarray(a, np.float32) for a in leaves)
    return data, p, iu, ii, leaves


@pytest.mark.parametrize("extra_invalid", [False, True])
def test_rmse_and_objective_match_jax(extra_invalid):
    data, p, iu, ii, leaves = _case(extra_invalid)
    js = JState(*(jnp.asarray(a) for a in leaves))
    ts = state_from_numpy(*leaves, device="cpu")
    jev = JEvaluator(data, iu, ii, p)
    tev = tm.Evaluator(data, iu, ii, p, device="cpu")
    jm = JModelMF(p, data.n_users, data.n_items)
    tmod = ModelMF(p, data.n_users, data.n_items)
    jv, tv = jm.eval_view(js), tmod.eval_view(ts)
    for which in ("train", "val", "test"):
        assert tev.rmse(tv, which) == pytest.approx(jev.rmse(jv, which),
                                                    rel=1e-6)
    assert tev.objective(tv, ts) == pytest.approx(jev.objective(jv, js),
                                                  rel=1e-6)
    # the bias-model form of the objective (bias reg on valid entities)
    assert tev.objective(tv, ts, use_factors=False, use_bias=True) == \
        pytest.approx(jev.objective(jv, js, use_factors=False,
                                    use_bias=True), rel=1e-6)


def test_predict_pairs_includes_biases_like_jax():
    from matfac_tpu.eval.metrics import predict_pairs as j_predict
    from matfac_tpu.models.base import EvalView as JView
    from matfac_tpu_torch.models.base import EvalView
    _, _, _, _, leaves = _case(False)
    rows = np.array([0, 3, 3, 89], np.int64)
    cols = np.array([1, 0, 69, 2], np.int64)
    want = j_predict(JView(*(jnp.asarray(a) for a in leaves)),
                     jnp.asarray(rows), jnp.asarray(cols))
    got = tm.predict_pairs(EvalView(*(torch.from_numpy(a) for a in leaves)),
                           torch.from_numpy(rows), torch.from_numpy(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sse_walks_chunks(monkeypatch):
    """Streams longer than one chunk reduce chunk by chunk to the same
    sum."""
    data, p, iu, ii, leaves = _case(False)
    tev = tm.Evaluator(data, iu, ii, p, device="cpu")
    view = ModelMF(p, data.n_users, data.n_items).eval_view(
        state_from_numpy(*leaves, device="cpu"))
    whole = tm.sse(view, tev.train_coo)
    monkeypatch.setattr(tm, "_EVAL_CHUNK", 97)
    chunked = tm.sse(view, tev.train_coo)
    assert chunked[1] == whole[1] == tev.train_coo.rows.shape[0]
    assert chunked[0] == pytest.approx(whole[0], rel=1e-12)


def test_rmse_of_a_missing_matrix_raises():
    data, p, iu, ii, _ = _case(False)
    data.val_mat = None
    tev = tm.Evaluator(data, iu, ii, p, device="cpu")
    with pytest.raises(ValueError, match="no val"):
        tev.rmse(None, "val")


@pytest.mark.parametrize("extra_invalid", [False, True])
@pytest.mark.parametrize("n", [3, 10])
def test_ndcg_matches_jax(extra_invalid, n):
    """NDCG@n over the padded test / val rows with invalid items masked
    out of the scan (model.cpp:785); f32 per user, summed in another
    order: rel 1e-6."""
    data, p, iu, ii, leaves = _case(extra_invalid)
    js = JState(*(jnp.asarray(a) for a in leaves))
    ts = state_from_numpy(*leaves, device="cpu")
    jev = JEvaluator(data, iu, ii, p)
    tev = tm.Evaluator(data, iu, ii, p, device="cpu")
    from matfac_tpu.models.base import EvalView as JView
    from matfac_tpu_torch.models.base import EvalView
    # the full view, biases and mu included
    jv, tv = JView(*js), EvalView(*ts)
    mask = np.random.default_rng(2).random(data.n_users) < 0.6
    for which in ("test", "val"):
        want = jev.ndcg(jv, which, n=n)
        assert 0.0 < want < 1.0
        assert tev.ndcg(tv, which, n=n) == pytest.approx(want, rel=1e-6)
        assert tev.ndcg(tv, which, n=n, user_mask=mask) == pytest.approx(
            jev.ndcg(jv, which, n=n, user_mask=mask), rel=1e-6)
