"""The port's quartile reports (matfac_tpu_torch.eval.quartile) against the
JAX package on the same view: the partitions, per-bucket counts and RMSE,
the report's text, the sub-matrix RMSE, and the ranking report (the
port's CatalogScorer on the CPU runs the plain top-N) with HR, ARHR and
NDCG per user quartile."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.eval import quartile as jq
from matfac_tpu.eval.metrics import Evaluator as JEvaluator
from matfac_tpu.eval.ranking import CatalogScorer as JScorer
from matfac_tpu.models.base import EvalView as JView
from matfac_tpu.utils import freq
from matfac_tpu_torch.eval import quartile as tq
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.eval.ranking import CatalogScorer
from matfac_tpu_torch.models.base import EvalView

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(width=4, bias=True, extra_users=0, seed=0):
    """Power-law data (heads and tails in every quartile), a random view of
    ``width`` columns (dropoutmf's view is 2k wide) with biases and mu, and
    both evaluators. ``extra_users`` widens n_users past the train matrix:
    entities with zero train frequency, padded with zeros."""
    data, _, _ = synthetic_data(n_users=90, n_items=70, k=3, density=0.3,
                                seed=4, noise=0.05, power_law=0.8,
                                nonneg=True)
    data.n_users += extra_users
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(data.n_users, width)).astype(np.float32),
            rng.normal(size=(data.n_items, width)).astype(np.float32),
            rng.normal(size=data.n_users).astype(np.float32) * bias,
            rng.normal(size=data.n_items).astype(np.float32) * bias,
            np.float32(3.0 * bias))
    jview = JView(*(jnp.asarray(a) for a in arrs))
    tview = EvalView(*(torch.from_numpy(np.array(a)) for a in arrs))
    p = Params(fac_dim=width)
    return (data, iu, ii, jview, tview, JEvaluator(data, iu, ii, p),
            Evaluator(data, iu, ii, p, device="cpu"))


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d+|nan", text)]


def _same_text(got, want, tol=TOL):
    """The same lines with every count equal and every number within
    ``tol``."""
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert re.sub(r"\d+\.\d+", "x", g) == re.sub(r"\d+\.\d+", "x", w)
        np.testing.assert_allclose(_numbers(g), _numbers(w), atol=tol)


@pytest.mark.parametrize("extra_users", [0, 6])
def test_quartile_partitions_match_jax(extra_users):
    data, iu, ii, *_ = _setup(extra_users=extra_users)
    for got, want in zip(tq.quartile_partitions(data, iu, ii),
                         jq.quartile_partitions(data, iu, ii)):
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {-1, 0, 1, 2, 3}
    for nq in (2, 3, 5):
        for got, want in zip(tq.quartile_partitions(data, iu, ii, nq),
                             jq.quartile_partitions(data, iu, ii, nq)):
            np.testing.assert_array_equal(got, want)


def test_pad_zeros_never_tiles():
    a = np.array([3.0, 1.0])
    np.testing.assert_array_equal(tq._pad_zeros(a, 5), jq._pad_zeros(a, 5))
    np.testing.assert_array_equal(tq._pad_zeros(a, 5), [3, 1, 0, 0, 0])
    np.testing.assert_array_equal(tq._pad_zeros(a, 1), [3])


@pytest.mark.parametrize("width,bias,extra", [(4, True, 0), (8, False, 0),
                                              (4, True, 6)])
def test_quartile_report_matches_jax(width, bias, extra):
    """The report's lines: the same bucket counts, RMSE within 1e-5."""
    data, iu, ii, jv, tv, jev, tev = _setup(width, bias, extra)
    got = tq.quartile_report(tv, data, tev, iu, ii)
    want = jq.quartile_report(jv, data, jev, iu, ii)
    assert "Test RMSE by quartile" in got and "Val RMSE by quartile" in got
    _same_text(got, want)
    counts = lambda s: re.findall(r"(\d+) \d+\.\d+", s)
    assert counts(got) == counts(want)


@pytest.mark.parametrize("which", ["train", "test", "val"])
def test_filtered_rmse_matches_jax(which):
    """(count, RMSE) per user and item filter, with and without reused
    residuals; an empty filter gives (0, nan)."""
    data, iu, ii, jv, tv, jev, tev = _setup()
    uq, iq = tq.quartile_partitions(data, iu, ii)
    res = tq.split_residuals(tv, tev, which)
    for uf, itf in ((uq == 0, None), (None, iq == 3), (uq == 1, iq == 2),
                    (None, None), (uq == 9, None)):
        gc, gr = tq.filtered_rmse(tv, tev, which, uf, itf, residuals=res)
        gc2, gr2 = tq.filtered_rmse(tv, tev, which, uf, itf)
        wc, wr = jq.filtered_rmse(jv, jev, which, uf, itf)
        assert gc == gc2 == wc
        if wc == 0:
            assert np.isnan(gr) and np.isnan(wr)
        else:
            np.testing.assert_allclose([gr, gr2], [wr, wr], rtol=TOL)


@pytest.mark.parametrize("exclude", [False, True])
def test_submat_rmse_matches_jax(exclude):
    data, iu, ii, jv, tv, jev, tev = _setup()
    for ur, ir in (((0, 30), (10, 40)), ((5, 6), (0, 70)), ((0, 0), (0, 5))):
        gc, gr = tq.submat_rmse(tv, tev, "test", ur, ir, exclude=exclude)
        wc, wr = jq.submat_rmse(jv, jev, "test", ur, ir, exclude=exclude)
        assert gc == wc
        if wc:
            np.testing.assert_allclose(gr, wr, rtol=TOL)
        else:
            assert np.isnan(gr) and np.isnan(wr)


@pytest.mark.parametrize("n,with_ndcg", [(10, True), (5, False)])
def test_quartile_ranking_report_matches_jax(n, with_ndcg):
    """HR@n and ARHR (top-n and top-min(1000, n_items) passes through each
    package's scorer) and NDCG@n per user quartile, within 1e-5."""
    data, iu, ii, jv, tv, jev, tev = _setup(width=8)
    js = JScorer(data.train_mat, iu, ii, data.n_users, data.n_items)
    ts = CatalogScorer(data.train_mat, iu, ii, data.n_users, data.n_items,
                       device="cpu")
    got = tq.quartile_ranking_report(tv, data, ts, iu, ii, n=n,
                                     evaluator=tev if with_ndcg else None)
    want = jq.quartile_ranking_report(jv, data, js, iu, ii, n=n,
                                      evaluator=jev if with_ndcg else None)
    assert f"Test HR@{n} by user quartile" in got
    assert ("Test NDCG@10 by user quartile" in got) == with_ndcg
    _same_text(got, want)
    assert max(_numbers(got)) > 0
