"""The port's analysis layer (matfac_tpu_torch.analysis.*, ops.ppr and the
item-similarity graphs of data.io) against the JAX package's, on the same
numpy inputs: the cases of tests/test_analysis.py and
tests/test_analyze_models.py (those of parallel/ and sharded checkpoints
wait for the port's multi-device slice).

Tolerances: numpy-only code and the random draws (numpy generators in
both packages) are held exactly; float32 device products (JAX's XLA, the
port's torch, in other summation orders) at rtol 1e-5 / atol 1e-6, and
PPR's float32 power iteration at rtol 1e-4 / atol 1e-6; orderings and
counts derived from them exactly (the inputs have no near-ties). The
cosine graph is held to the native library's path edge for edge, values
at rtol 1e-6.
"""

import os
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matfac_tpu.analysis import batch as jbatch
from matfac_tpu.analysis import compare as jcmp
from matfac_tpu.analysis import conf_compat as jcc
from matfac_tpu.analysis import confidence as jconf
from matfac_tpu.analysis import drivers as jdrv
from matfac_tpu.analysis import top_bucket as jtb
from matfac_tpu.analysis import topn as jtopn
from matfac_tpu.config import Params as JParams
from matfac_tpu.data import io as jio
from matfac_tpu.data.csr import RatingMatrix as JRM
from matfac_tpu.data.synthetic import low_rank_ratings, synthetic_data
from matfac_tpu.eval.metrics import Evaluator as JEvaluator
from matfac_tpu.models.base import EvalView as JView
from matfac_tpu.ops.ppr import PPREngine as JPPR
from matfac_tpu.utils import freq
from matfac_tpu.utils import native
from matfac_tpu_torch import analysis as tanalysis
from matfac_tpu_torch.analysis import batch as tbatch
from matfac_tpu_torch.analysis import compare as tcmp
from matfac_tpu_torch.analysis import conf_compat as tcc
from matfac_tpu_torch.analysis import confidence as tconf
from matfac_tpu_torch.analysis import drivers as tdrv
from matfac_tpu_torch.analysis import top_bucket as ttb
from matfac_tpu_torch.analysis import topn as ttopn
from matfac_tpu_torch.config import Params as TParams
from matfac_tpu_torch.data import io as tio
from matfac_tpu_torch.data.csr import RatingMatrix as TRM
from matfac_tpu_torch.data.dataset import Data as TData
from matfac_tpu_torch.eval.metrics import Evaluator as TEvaluator
from matfac_tpu_torch.models.base import EvalView as TView
from matfac_tpu_torch.ops.ppr import PPREngine as TPPR

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_native_ref import load_native_ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6          # float32 products, both packages
PPR_RTOL, PPR_ATOL = 1e-4, 1e-6  # float32 power iteration
COS_RTOL = 1e-6                  # float32 roundings of float64 cosines


@pytest.fixture(autouse=True, scope="module")
def _native_ref():
    """JAX's native library loads before any test here reads it: its
    cosine graph is the reference (torch_native_ref.py says why)."""
    load_native_ref()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Two(NamedTuple):
    """An argument given to the JAX function (j) and to the port's (t)."""
    j: object
    t: object


def views(uf, vf, ub=None, ib=None, mu=0.0):
    """The same EvalView in both packages (zero biases by default)."""
    ub = np.zeros(uf.shape[0], np.float32) if ub is None else ub
    ib = np.zeros(vf.shape[0], np.float32) if ib is None else ib
    arrs = [np.asarray(a, np.float32) for a in (uf, vf, ub, ib)]
    return (JView(*(jnp.asarray(a) for a in arrs), jnp.float32(mu)),
            TView(*(torch.from_numpy(a) for a in arrs),
                  torch.tensor(mu, dtype=torch.float32)))


def tmat(m: JRM) -> TRM:
    return TRM(m.indptr, m.indices, m.values, m.ncols)


def tdata(data):
    return TData(train_mat=tmat(data.train_mat),
                 test_mat=tmat(data.test_mat), val_mat=tmat(data.val_mat))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def same_graph(got: TRM, want: JRM, rtol=COS_RTOL):
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.values, want.values, rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def syn():
    """tests/test_analysis.py's drivers data: power-law synthetic ratings,
    ground truth and a shifted model, the cosine graph and both engines."""
    data, uf, vf = synthetic_data(n_users=50, n_items=40, k=3,
                                  density=0.35, seed=6, noise=0.05,
                                  power_law=0.7, nonneg=True)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    graph = jio.item_cosine_sim(data.train_mat, top_k=5)
    return dict(data=data, tdata=tdata(data), uf=uf, vf=vf, iu=iu, ii=ii,
                orig=views(uf, vf), full=views(uf + 0.1, vf),
                graph=graph, eng=(JPPR(graph), TPPR(tmat(graph),
                                                    device="cpu")))


# ----------------------------------------------------------------------
# the item-similarity graphs
# ----------------------------------------------------------------------

def _binary(seed, n_users=80, n_items=60, density=0.15):
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((n_users, n_items)) < density)
    v = np.ones(len(r), np.float32)
    return JRM.from_coo(r, c, v, n_users, n_items)


def _settled(monkeypatch):
    """Spy on the rows settled on the host by the native rule."""
    rows = []
    real = tio._native_cosine_row

    def spy(mat, norms, i, k):
        rows.append(i)
        return real(mat, norms, i, k)
    monkeypatch.setattr(tio, "_native_cosine_row", spy)
    return rows


def test_the_native_library_is_the_reference():
    assert native._find_lib() is not None


@pytest.mark.parametrize("seed,top_k", [(0, 3), (1, 3), (2, 7)])
def test_cosine_ties_match_the_native_path(seed, top_k, monkeypatch):
    """Binary ratings: cosines c / sqrt(n_i n_j) tie exactly, many at the
    k-th slot. The graph equals the native library's edge for edge and
    value for value; some rows were settled on the host."""
    mat = _binary(seed)
    rows = _settled(monkeypatch)
    got = tio.item_cosine_sim(tmat(mat), top_k=top_k, block=16,
                              device="cpu")
    same_graph(got, jio.item_cosine_sim(mat, top_k=top_k), rtol=0)
    assert rows


def test_cosine_tie_rule_is_the_natives_not_first_touch(monkeypatch):
    """Among float32-equal cosines the native keeps those whose float64
    value rounds down first, the last touched first: a first-touch rule
    gives other edges on this input."""
    mat = _binary(0)
    want = jio.item_cosine_sim(mat, top_k=3)

    def first_touch(m, norms, i, k):
        colptr, rowind, _ = m.csc()
        pos, _ = tio._segments(m.indptr, rowind[colptr[i]:colptr[i + 1]]
                               .astype(np.int64))
        js = m.indices[pos].astype(np.int64)
        js = js[js != i]
        acc = np.bincount(js, minlength=m.ncols).astype(np.float64)
        t, first = np.unique(js, return_index=True)
        f = (acc[t] / (norms[i] * norms[t])).astype(np.float32)
        o = np.lexsort((first, -f))[:k]
        return t[o], f[o]
    monkeypatch.setattr(tio, "_native_cosine_row", first_touch)
    got = tio.item_cosine_sim(tmat(mat), top_k=3, device="cpu")
    assert not np.array_equal(got.indices, want.indices)


@pytest.mark.parametrize("kind", ["continuous", "integer", "signed"])
def test_cosine_matches_the_native_path(kind):
    mat, _, _ = low_rank_ratings(300, 200, 4, density=0.1, seed=1,
                                 nonneg=kind != "signed")
    if kind == "integer":   # integer ratings: exact float64 sums, ties
        mat = JRM(mat.indptr, mat.indices,
                  np.maximum(np.round(mat.values), 1).astype(np.float32),
                  mat.ncols)
    got = tio.item_cosine_sim(tmat(mat), top_k=10, block=64, device="cpu")
    same_graph(got, jio.item_cosine_sim(mat, top_k=10))


def test_cosine_rows_subset_and_small_catalog():
    """cosine_topk_rows on a subset of rows gives those rows of the graph;
    top_k beyond the catalog keeps every positive neighbour."""
    mat = _binary(3, n_items=12, density=0.3)
    full = jio.item_cosine_sim(mat, top_k=20)
    r, c, v = tio.cosine_topk_rows(tmat(mat), np.array([7, 2, 5]),
                                   top_k=20, device="cpu")
    for i in (7, 2, 5):
        cols, vals = full.row(i)
        np.testing.assert_array_equal(np.sort(c[r == i]), cols)
    same_graph(tio.item_cosine_sim(tmat(mat), top_k=20, device="cpu"),
               full)


@pytest.mark.parametrize("top_k", [3, 5])
def test_jaccard_matches_jax(top_k):
    """Values per row equal (exact counts, float32 division as JAX's);
    the edge set equal on the rows without a tie at the k-th slot (JAX's
    argpartition does not define the order of ties)."""
    data, _, _ = synthetic_data(n_users=50, n_items=40, k=3, density=0.3,
                                seed=4, noise=0.05)
    want = jio.item_jaccard_sim(data.train_mat, top_k=top_k)
    got = tio.item_jaccard_sim(tmat(data.train_mat), top_k=top_k, block=16,
                               device="cpu")
    colptr = data.train_mat.csc()[0]
    sets = [set(data.train_mat.csc()[1][colptr[i]:colptr[i + 1]])
            for i in range(40)]
    n_clear = 0
    for i in range(40):
        gc, gv = got.row(i)
        wc, wv = want.row(i)
        np.testing.assert_array_equal(np.sort(gv), np.sort(wv))
        sims = sorted((len(sets[i] & sets[j]) / max(len(sets[i] | sets[j]),
                                                    1)
                       for j in range(40) if j != i), reverse=True)
        if sims[top_k - 1] != sims[top_k]:
            np.testing.assert_array_equal(gc, wc)
            n_clear += 1
    assert n_clear > 10


# ----------------------------------------------------------------------
# PPR
# ----------------------------------------------------------------------

def test_ppr_stationary_distribution():
    n = 16
    rows = np.arange(n)
    g = JRM.from_coo(rows, (rows + 1) % n, np.ones(n, np.float32), n, n)
    got = TPPR(tmat(g), device="cpu").global_pagerank(lamda=0.85).numpy()
    close(got, np.asarray(JPPR(g).global_pagerank(lamda=0.85)),
          PPR_RTOL, PPR_ATOL)
    np.testing.assert_allclose(got, got[0], rtol=1e-3)


def test_ppr_restart_locality():
    rows, cols = [], []
    for a in range(4):
        for b in range(4):
            if a != b:
                rows += [a, a + 4]
                cols += [b, b + 4]
    g = JRM.from_coo(np.array(rows), np.array(cols),
                     np.ones(len(rows), np.float32), 8, 8)
    restart = np.zeros(8, np.float32)
    restart[0] = 1.0
    got = TPPR(tmat(g), device="cpu").ppr(restart).numpy()
    close(got, np.asarray(JPPR(g).ppr(jnp.asarray(restart))), PPR_RTOL,
          PPR_ATOL)
    assert got[:4].sum() > 0.99 and got[4:].sum() < 0.01


def _dangling_graph(seed=0, n=50):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) < 0.08
    m[:5] = False                      # dangling nodes: their mass restarts
    r, c = np.nonzero(m)
    return JRM.from_coo(r, c, rng.random(len(r)).astype(np.float32), n, n)


def _jax_iterations(eng, train, users, eps):
    """JAX's step count: the least max_iter whose result is the default's
    (the while_loop does not return its count)."""
    full = np.asarray(eng.user_ppr(train, users, eps=eps))
    for m in range(1, 200):
        if np.array_equal(np.asarray(eng.user_ppr(train, users, eps=eps,
                                                  max_iter=m)), full):
            return m
    raise AssertionError("no convergence")


@pytest.mark.parametrize("eps", [1e-4, 1e-2])
def test_user_ppr_stops_at_jax_iteration(eps):
    """The port stops after JAX's step, and with max_iter one less it
    returns JAX's earlier iterate, which the tolerance tells from the
    last: the stopping test matters. Two runs give the same bits."""
    g = _dangling_graph()
    rng = np.random.default_rng(1)
    train = JRM.from_coo(rng.integers(0, 20, 120), rng.integers(0, 50, 120),
                         rng.random(120).astype(np.float32), 20, 50)
    users = np.arange(20)
    j, t = JPPR(g), TPPR(tmat(g), device="cpu")
    want = np.asarray(j.user_ppr(train, users, eps=eps))
    got = t.user_ppr(tmat(train), users, eps=eps)
    close(got, want, PPR_RTOL, PPR_ATOL)
    n = _jax_iterations(j, train, users, eps)
    assert t.iterations == n > 2
    early = t.user_ppr(tmat(train), users, eps=eps, max_iter=n - 1)
    assert t.iterations == n - 1
    close(early, np.asarray(j.user_ppr(train, users, eps=eps,
                                       max_iter=n - 1)),
          PPR_RTOL, PPR_ATOL)
    if eps > 1e-3:
        assert not np.allclose(early, want, rtol=PPR_RTOL, atol=PPR_ATOL)
    np.testing.assert_array_equal(t.user_ppr(tmat(train), users, eps=eps),
                                  got)


# ----------------------------------------------------------------------
# batch primitives
# ----------------------------------------------------------------------

def _biased_views(seed=0, U=30, I=40, K=4):
    rng = np.random.default_rng(seed)
    return views(rng.normal(size=(U, K)), rng.normal(size=(I, K)),
                 rng.normal(size=U).astype(np.float32),
                 rng.normal(size=I).astype(np.float32), 0.3)


@pytest.mark.parametrize("P,C,block", [(17, 9, 8), (3, 5, 256), (0, 4, 8)])
def test_score_pools_matches_jax(P, C, block):
    jv, tv = _biased_views()
    rng = np.random.default_rng(0)
    users = rng.integers(0, 30, P)
    pools = rng.integers(0, 40, (P, C))
    got = tbatch.score_pools(tv, users, pools, pair_block=block)
    assert got.shape == (P, C)
    if P:
        close(got, jbatch.score_pools(jv, users, pools, pair_block=block))


@pytest.mark.parametrize("block", [7, 1024])
def test_catalog_blocks_match_jax(block):
    (jv, tv), (jo, to) = _biased_views(1), _biased_views(2)
    users = np.array([3, 0, 29, 7, 7, 12, 5, 1, 2, 9, 11])
    for (ip, p), (jp, q) in zip(tbatch.catalog_preds(tv, users, block),
                                jbatch.catalog_preds(jv, users, block)):
        np.testing.assert_array_equal(ip, jp)
        close(p, q)
    got = list(tbatch.catalog_sq_err(to, tv, users, block))
    want = list(jbatch.catalog_sq_err(jo, jv, users, block))
    assert len(got) == len(want)
    for (ip, p), (jp, q) in zip(got, want):
        np.testing.assert_array_equal(ip, jp)
        close(p, q, 1e-4, 1e-5)


def test_sample_unrated_pools_draws_as_jax():
    """The same numpy generator, the same draws: distinct valid unrated
    negatives, and the exhausted-catalog padding."""
    mat, _, _ = low_rank_ratings(40, 30, 3, density=0.3, seed=2)
    valid = np.ones(30, bool)
    valid[5] = False
    users, tis = np.array([0, 3, 7, 7]), np.array([1, 2, 3, 4])
    args = lambda m: (m, valid, users, tis, 20, np.random.default_rng(1))
    np.testing.assert_array_equal(tbatch.sample_unrated_pools(*args(
        tmat(mat))), jbatch.sample_unrated_pools(*args(mat)))
    small = lambda m: (m, valid[:20].copy(), users[:2], tis[:2], 50,
                       np.random.default_rng(2))
    np.testing.assert_array_equal(
        tbatch.sample_unrated_pools(*small(tmat(mat))),
        jbatch.sample_unrated_pools(*small(mat)))


# ----------------------------------------------------------------------
# confidence and the pair-score providers
# ----------------------------------------------------------------------

def test_ensemble_conf_and_curves():
    rng = np.random.default_rng(0)
    n_u, n_i, k = 30, 20, 3
    base_u = rng.standard_normal((n_u, k)).astype(np.float32)
    base_v = rng.standard_normal((n_i, k)).astype(np.float32)
    pairs = [views(base_u + 0.01 * i * rng.standard_normal(
        (n_u, k)).astype(np.float32), base_v) for i in range(4)]
    rows, cols = rng.integers(0, n_u, 200), rng.integers(0, n_i, 200)
    got = tconf.ensemble_conf_scores([t for _, t in pairs], rows, cols)
    close(got, jconf.ensemble_conf_scores([j for j, _ in pairs], rows,
                                          cols), 1e-4)
    actual = rng.standard_normal(200)
    pred = actual + rng.standard_normal(200) * np.linspace(0.1, 2, 200)
    sc = -np.linspace(0.1, 2, 200)
    np.testing.assert_array_equal(tconf.rmse_curve(sc, actual, pred, 4),
                                  jconf.rmse_curve(sc, actual, pred, 4))
    np.testing.assert_array_equal(
        tconf.confidence_curve(sc, actual, pred, 4, 0.05),
        jconf.confidence_curve(sc, actual, pred, 4, 0.05))
    np.testing.assert_array_equal(
        tanalysis.rmse_curve(sc, actual, pred, 3),
        jconf.rmse_curve(sc, actual, pred, 3))


def test_pair_score_providers(syn):
    data, (je, te) = syn["data"], syn["eng"]
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 50, 50), rng.integers(0, 40, 50)
    (jo, to), (jf, tf) = syn["orig"], syn["full"]
    close(tconf.gpr_pair_scores(te, cols), jconf.gpr_pair_scores(je, cols),
          PPR_RTOL, PPR_ATOL)
    close(tconf.ppr_pair_scores(te, syn["tdata"].train_mat, rows, cols),
          jconf.ppr_pair_scores(je, data.train_mat, rows, cols),
          PPR_RTOL, PPR_ATOL)
    deg = data.train_mat.col_degrees()
    np.testing.assert_array_equal(tconf.freq_pair_scores(deg, cols),
                                  jconf.freq_pair_scores(deg, cols))
    op = tconf.optimal_pair_scores(to, tf, rows, cols)
    close(op, jconf.optimal_pair_scores(jo, jf, rows, cols))
    close(tconf.score_bucket_rmses(to, tf, rows, cols, op, 5),
          jconf.score_bucket_rmses(jo, jf, rows, cols, op, 5))


def test_per_user_bucket_rmses(syn):
    (jo, to), (jf, tf) = syn["orig"], syn["full"]
    rng = np.random.default_rng(2)
    users = np.arange(0, 50, 3)
    scores = rng.random((len(users), 40))
    mask = ~syn["ii"][:40]
    g, gn = tconf.per_user_bucket_rmses(to, tf, scores, users, mask, 4)
    w, wn = jconf.per_user_bucket_rmses(jo, jf, scores, users, mask, 4)
    close(g, w)
    np.testing.assert_array_equal(gn, wn)


@pytest.mark.parametrize("sorted_rows", [True, False])
def test_sample_missing_pairs(syn, sorted_rows):
    if sorted_rows:
        mat, iu, ii = syn["data"].train_mat, syn["iu"], syn["ii"]
    else:   # row 0 unsorted: items [9, 2, 5]
        mat = JRM(np.array([0, 3, 4]), np.array([9, 2, 5, 1]),
                  np.ones(4, np.float32), ncols=10)
        iu, ii = np.zeros(2, bool), np.zeros(10, bool)
    for a, b in zip(tconf.sample_missing_pairs(tmat(mat), iu, ii, 120, 3),
                    jconf.sample_missing_pairs(mat, iu, ii, 120, 3)):
        np.testing.assert_array_equal(a, b)


def test_conf_compat_named_surface():
    """Every named confCompute analog, port against JAX on
    tests/test_analysis.py's grid (the JAX cosine graph under both
    engines)."""
    mat, uf, vf = low_rank_ratings(50, 40, 3, density=0.3, seed=7,
                                   noise=0.05, nonneg=True)
    tm = tmat(mat)
    iu, ii = freq.invalid_users_items(mat, 50, 40)
    orig = Two(*views(uf, vf))
    full = Two(*views(uf + 0.1 * np.random.default_rng(0).normal(
        size=uf.shape).astype(np.float32), vf))
    ens = [views(uf * s, vf) for s in (0.9, 1.0, 1.1)]
    ens = Two([j for j, _ in ens], [t for _, t in ens])
    g = jio.item_cosine_sim(mat, top_k=10)
    eng = Two(JPPR(g), TPPR(tmat(g), device="cpu"))
    mats = Two(mat, tm)
    item_freq = mat.col_degrees().astype(np.float64)
    user_freq = mat.row_degrees().astype(np.float64)

    def both(fn_j, fn_t, *args, tol=(RTOL, ATOL), **kw):
        """fn_j on the JAX side of each Two argument, fn_t on the port's;
        the results held together."""
        pick = lambda side: [getattr(a, side) if isinstance(a, Two) else a
                             for a in args]
        want, got = fn_j(*pick("j"), **kw), fn_t(*pick("t"), **kw)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for a, b in zip(got, want):
            close(a, b, *tol)
        return got[0]

    pairs = jcc.get_test_pairs(mat, iu, ii, 200, seed=3)
    for a, b in zip(tcc.get_test_pairs(tm, iu, ii, 200, seed=3), pairs):
        np.testing.assert_array_equal(a, b)
    both(jcc.compute_mod_conf, tcc.compute_mod_conf, mats,
         ens, iu, ii, orig, full, 5, tol=(1e-4, 1e-6))
    both(jcc.compute_gpr_conf, tcc.compute_gpr_conf, mats, eng, iu,
         ii, 0.85, orig, full, 5)
    both(jcc.compute_ppr_conf, tcc.compute_ppr_conf, mats, mats,
         eng, iu, ii, 0.85, orig, full, 5)
    both(jcc.compute_missing_mod_conf, tcc.compute_missing_mod_conf,
         mats, ens, iu, ii, orig, full, 5, n_pairs=500,
         tol=(1e-4, 1e-6))
    both(jcc.compute_missing_gpr_conf, tcc.compute_missing_gpr_conf,
         mats, eng, iu, ii, 0.85, orig, full, 5, n_pairs=300)
    both(jcc.compute_missing_ppr_conf, tcc.compute_missing_ppr_conf,
         mats, eng, iu, ii, 0.85, orig, full, 5, n_pairs=300)
    both(jcc.gen_opt_conf_rmse_curve, tcc.gen_opt_conf_rmse_curve, pairs,
         orig, full, 5)
    both(jcc.gen_item_conf_rmse_curve, tcc.gen_item_conf_rmse_curve,
         pairs, orig, full, item_freq, 5)
    both(jcc.gen_user_conf_rmse_curve, tcc.gen_user_conf_rmse_curve,
         pairs, orig, full, user_freq, 5)
    both(jcc.gen_gpr_conf_rmse_curve, tcc.gen_gpr_conf_rmse_curve, pairs,
         orig, full, eng)
    both(jcc.gen_model_conf_rmse_curve, tcc.gen_model_conf_rmse_curve,
         pairs, orig, full, ens, 5, tol=(1e-4, 1e-6))
    both(jcc.gen_ppr_conf_rmse_curve, tcc.gen_ppr_conf_rmse_curve, pairs,
         orig, full, eng, mats)
    both(jcc.gen_opt_confidence_curve, tcc.gen_opt_confidence_curve,
         pairs, orig, full, 5)
    both(jcc.conf_bucket_rmses, tcc.conf_bucket_rmses, orig, full,
         ens, 50, 40, 4, iu, ii)
    both(jcc.gpr_bucket_rmses, tcc.gpr_bucket_rmses, orig, full, eng, 50,
         40, n_buckets=4, invalid_users=iu, invalid_items=ii)
    both(jcc.ppr_bucket_rmses, tcc.ppr_bucket_rmses, orig, full, eng,
         mats, 50, 40, n_buckets=4, invalid_users=iu,
         invalid_items=ii, n_samp_users=10)
    b4 = both(jcc.conf_opt_bucket_rmses, tcc.conf_opt_bucket_rmses, orig,
              full, 50, 40, 4, iu, ii)
    assert (np.diff(b4) >= -1e-6).all()
    both(jcc.item_freq_bucket_rmses, tcc.item_freq_bucket_rmses, orig,
         full, item_freq, 50, 40, 4, iu, ii)


# ----------------------------------------------------------------------
# top-N recall
# ----------------------------------------------------------------------

def _preference_data():
    """tests/test_analysis.py's preference-structured data: each user's
    positives are their top items under known factors."""
    rng = np.random.default_rng(8)
    n_u, n_i, k, per_user = 50, 60, 3, 10
    uf = rng.standard_normal((n_u, k)).astype(np.float32)
    vf = rng.standard_normal((n_i, k)).astype(np.float32)
    scores = uf @ vf.T
    rows_tr, cols_tr, rows_te, cols_te = [], [], [], []
    for u in range(n_u):
        top = np.argsort(-scores[u])[:per_user]
        rows_te.append(u)
        cols_te.append(top[rng.integers(0, per_user)])
        for it in top:
            if it != cols_te[-1]:
                rows_tr.append(u)
                cols_tr.append(it)
    tr = JRM.from_coo(np.array(rows_tr), np.array(cols_tr),
                      np.ones(len(rows_tr), np.float32), n_u, n_i)
    te = JRM.from_coo(np.array(rows_te), np.array(cols_te),
                      np.ones(n_u, np.float32), n_u, n_i)
    return tr, te, uf, vf


def _same_report(got, want):
    assert (got.n_test_items, got.n_head_items, got.n_tail_items) == (
        want.n_test_items, want.n_head_items, want.n_tail_items)
    assert got.recall == want.recall
    assert got.head_recall == want.head_recall
    assert got.tail_recall == want.tail_recall
    assert str(got) == str(want)


@pytest.mark.parametrize("with_ppr", [False, True])
def test_top_n_rec_matches_jax(with_ppr):
    tr, te, uf, vf = _preference_data()
    iu, ii = freq.invalid_users_items(tr, 50, 60)
    jv, tv = views(uf, vf)
    kw = dict(n=10, n_samp_users=40, n_negatives=30, seed=1)
    if with_ppr:
        users = np.arange(0, 50, 2)
        g = jio.item_cosine_sim(tr, top_k=5)
        kw.update(sampled_users=users,
                  ppr_scores=JPPR(g).user_ppr(tr, users))
    want = jtopn.top_n_rec(jv, tr, te, iu, ii, **kw)
    got = ttopn.top_n_rec(tv, tmat(tr), tmat(te), iu, ii, **kw)
    _same_report(got, want)
    assert got.recall["model"] > 0.9
    assert set(got.recall) == ({"model", "local", "local_wt"} if with_ppr
                               else {"model"})


def test_top_n_rec_handles_test_only_items():
    rng = np.random.default_rng(0)
    n_users, n_train_items, n_all = 30, 20, 25
    r = np.repeat(np.arange(n_users), 5)
    train = JRM.from_coo(r, rng.integers(0, n_train_items, len(r)),
                         np.ones(len(r), np.float32), n_users,
                         n_train_items)
    test = JRM.from_coo(np.arange(n_users),
                        rng.integers(n_train_items, n_all, n_users),
                        np.ones(n_users, np.float32), n_users, n_all)
    jv, tv = views(rng.normal(size=(n_users, 4)),
                   rng.normal(size=(n_all, 4)))
    args = (np.zeros(n_users, bool), np.zeros(n_all, bool))
    kw = dict(n=5, n_samp_users=30, n_negatives=10, seed=3)
    got = ttopn.top_n_rec(tv, tmat(train), tmat(test), *args, **kw)
    _same_report(got, jtopn.top_n_rec(jv, train, test, *args, **kw))
    assert got.n_head_items == 0


def test_spot_rec_matches_jax():
    data, uf, vf = synthetic_data(n_users=30, n_items=25, k=3,
                                  density=0.4, seed=2, nonneg=True)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    (jv, tv), (js, ts) = views(uf, vf), views(uf + 0.3, vf)
    kw = dict(n_values=(1, 5), n_samp_users=10, n_negatives=15)
    want = jtopn.spot_rec({"gt": jv, "shift": js}, data.train_mat,
                          data.test_mat, iu, ii, **kw)
    got = ttopn.spot_rec({"gt": tv, "shift": ts}, tmat(data.train_mat),
                         tmat(data.test_mat), iu, ii, **kw)
    assert set(got) == set(want) == {"gt@1", "gt@5", "shift@1", "shift@5"}
    for key in want:
        _same_report(got[key], want[key])


# ----------------------------------------------------------------------
# top-bucket curves and the ordering-overlap family
# ----------------------------------------------------------------------

def test_top_bucket_curves(syn):
    data = syn["data"]
    (jo, to), (jf, tf) = syn["orig"], syn["full"]
    items = np.arange(40)
    sc = np.random.default_rng(0).random(40)
    close(ttb.top_bucket_rmse_curve(to, tf, 0, items, sc, 5),
          jtb.top_bucket_rmse_curve(jo, jf, 0, items, sc, 5))
    close(ttb.item_pred_scores(tf, 3, items),
          jtb.item_pred_scores(jf, 3, items))
    np.testing.assert_array_equal(
        ttb.item_freq_scores(syn["tdata"].train_mat, items),
        jtb.item_freq_scores(data.train_mat, items))
    for how in ("avg", "prod", "logsum"):
        s = [np.ones(40), np.arange(40, dtype=float)]
        np.testing.assert_array_equal(ttb.fuse_scores(s, how),
                                      jtb.fuse_scores(s, how))
    np.testing.assert_array_equal(
        ttb.sample_users(syn["iu"], 50, 10, 4),
        jtb.sample_users(syn["iu"], 50, 10, 4))
    deg = data.train_mat.col_degrees()
    scorer = {"freq": lambda u, it: deg[it].astype(float),
              "rand": lambda u, it: (it * 7919 + u * 31) % 97 / 97.0}
    got = ttb.pred_samp_users_rmse(to, tf, syn["tdata"].train_mat,
                                   syn["iu"], syn["ii"], scorer, n_users=10,
                                   n_buckets=5)
    want = jtb.pred_samp_users_rmse(jo, jf, data.train_mat, syn["iu"],
                                    syn["ii"], scorer, n_users=10,
                                    n_buckets=5)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])


def test_ordering_overlap_family():
    ids_a = np.array([5, 3, 9, 1, 7])
    ids_b = np.array([3, 8, 5, 2, 9])
    sc_b = np.array([.5, .4, .3, .2, .1])
    for size in (2, 3, 9):
        for fn in ("ordering_overlap", "ordering_diff"):
            for a, b in zip(getattr(ttb, fn)(ids_a, ids_b, sc_b, size),
                            getattr(jtb, fn)(ids_a, ids_b, sc_b, size)):
                np.testing.assert_array_equal(a, b)
        for b_ids in (ids_b, ids_b[:2], np.array([])):
            for fn in ("comp_ordering_overlap", "comp_ordering_overlap2"):
                assert getattr(ttb, fn)(ids_a, b_ids, size) == getattr(
                    jtb, fn)(ids_a, b_ids, size)
            assert ttb.comp_ordering_overlap_bscores(
                ids_a, b_ids, sc_b[:len(b_ids)], size) == \
                jtb.comp_ordering_overlap_bscores(ids_a, b_ids,
                                                  sc_b[:len(b_ids)], size)
    assert ttb.comp_diff_pc(ids_a, ids_b) == jtb.comp_diff_pc(ids_a, ids_b)
    assert ttb.comp_ordering_overlap_bscores(ids_a, ids_b, sc_b, 3) == \
        pytest.approx(((0.5 + 0.3 - 1.0) / 2, (0.4 - 1.0) / 1))


# ----------------------------------------------------------------------
# the drivers of analyze mode
# ----------------------------------------------------------------------

def test_freq_rmse_sweep(syn):
    data, td = syn["data"], syn["tdata"]
    jp, tp = JParams(fac_dim=3), TParams(fac_dim=3)
    jev = JEvaluator(data, syn["iu"], syn["ii"], jp)
    tev = TEvaluator(td, syn["iu"], syn["ii"], tp, device="cpu")
    for which in ("test", "val"):
        got = tdrv.freq_rmse_sweep(syn["full"][1], tev, td, which=which)
        want = jdrv.freq_rmse_sweep(syn["full"][0], jev, data, which=which)
        assert list(got) == list(want) == [0.1, 0.25, 0.5, 0.75, 1.0]
        for p in want:
            assert got[p][0] == want[p][0]
            close(got[p][1], want[p][1])


def test_sample_top_n_analysis_and_ppr_gpr(syn):
    """sample_top_n_analysis with one SVD view (the JAX package's factors
    in both) and both engines; compare_ppr_gpr's overlaps exactly."""
    from matfac_tpu.ops.svd_init import svd_init
    data, td = syn["data"], syn["tdata"]
    su, sv, _ = svd_init(data.train_mat, 3)
    jsvd, tsvd = views(su, sv)
    jev = JEvaluator(data, syn["iu"], syn["ii"], JParams(fac_dim=3))
    tev = TEvaluator(td, syn["iu"], syn["ii"], TParams(fac_dim=3),
                     device="cpu")
    kw = dict(n_users=8, n_buckets=4)
    want = jdrv.sample_top_n_analysis(
        syn["full"][0], syn["orig"][0], jev, data, syn["iu"], syn["ii"],
        svd_view=jsvd, ppr_engine=syn["eng"][0], **kw)
    got = tdrv.sample_top_n_analysis(
        syn["full"][1], syn["orig"][1], tev, td, syn["iu"], syn["ii"],
        svd_view=tsvd, ppr_engine=syn["eng"][1], **kw)
    assert set(got["bucket_curves"]) == {"freq", "svd", "ppr"}
    for k, w in want["bucket_curves"].items():
        close(got["bucket_curves"][k], w, 1e-4, 1e-6)
    for p, w in want["freq_rmse_sweep"].items():
        assert got["freq_rmse_sweep"][p][0] == w[0]
        close(got["freq_rmse_sweep"][p][1], w[1])
    for users, top_m in (([0, 1, 2], 10), (np.arange(0, 50, 5), 4)):
        g = tdrv.compare_ppr_gpr(syn["eng"][1], td.train_mat, users, top_m)
        w = jdrv.compare_ppr_gpr(syn["eng"][0], data.train_mat, users,
                                 top_m)
        np.testing.assert_array_equal(g["overlaps"], w["overlaps"])
        assert g["mean_overlap"] == w["mean_overlap"]


# ----------------------------------------------------------------------
# multi-model agreement (tests/test_analyze_models.py)
# ----------------------------------------------------------------------

def test_model_agreement_and_jaccard():
    data, uf, vf = synthetic_data(n_users=50, n_items=40, k=3,
                                  density=0.3, seed=4, noise=0.05)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    rng = np.random.default_rng(0)
    ens = [views(uf + 0.05 * rng.standard_normal(uf.shape).astype(
        np.float32), vf) for _ in range(3)]
    want = jcmp.model_agreement([j for j, _ in ens], data.test_mat, iu, ii)
    got = tanalysis.model_agreement([t for _, t in ens],
                                    tmat(data.test_mat), iu, ii)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], 1e-4, 1e-6)
    jac_j = jio.item_jaccard_sim(data.train_mat, top_k=5)
    jac_t = tio.item_jaccard_sim(tmat(data.train_mat), top_k=5,
                                 device="cpu")
    # one graph under both correlations, then each package's own graph
    assert tcmp.jaccard_accuracy_correlation(got, tmat(jac_j)) == \
        pytest.approx(jcmp.jaccard_accuracy_correlation(want, jac_j),
                      rel=1e-4)
    assert -1.0 <= tcmp.jaccard_accuracy_correlation(got, jac_t) <= 1.0


def _ensemble(seed=0, n_users=60, n_items=40, k=4, m=3):
    """tests/test_analyze_models.py's setup: m views (the first with
    biases), a ground truth, a train matrix and invalid entities."""
    rng = np.random.default_rng(seed)

    def view(bias):
        uf = rng.normal(size=(n_users, k)).astype(np.float32) * 0.3
        vf = rng.normal(size=(n_items, k)).astype(np.float32) * 0.3
        ub = (rng.normal(size=n_users).astype(np.float32) * 0.1
              if bias else np.zeros(n_users, np.float32))
        ib = (rng.normal(size=n_items).astype(np.float32) * 0.1
              if bias else np.zeros(n_items, np.float32))
        mu = float(np.float32(rng.normal() * 0.1)) if bias else 0.0
        return views(uf, vf, ub, ib, mu)
    ens = [view(i == 0) for i in range(m)]
    orig = view(False)
    r, c = rng.integers(0, n_users, 300), rng.integers(0, n_items, 300)
    _, idx = np.unique(r * n_items + c, return_index=True)
    train = JRM.from_coo(r[idx], c[idx],
                         rng.uniform(1, 5, len(idx)).astype(np.float32),
                         n_users, n_items)
    iu, ii = np.zeros(n_users, bool), np.zeros(n_items, bool)
    iu[[3, 17]] = True
    ii[[5]] = True
    return ([j for j, _ in ens], [t for _, t in ens]), orig, train, iu, ii


@pytest.mark.parametrize("block", [16, 256])
def test_mean_and_var_all_users_and_average_models(block):
    (ej, et), (oj, ot), train, iu, ii = _ensemble()
    got = tcmp.mean_and_var_same_ground_all_users(et, ot, tmat(train), iu,
                                                  ii, user_block=block)
    want = jcmp.mean_and_var_same_ground_all_users(ej, oj, train, iu, ii,
                                                   user_block=block)
    assert got["count"] == want["count"]
    for k in ("rmse_models", "best_rmse", "avg_rmse", "mean_var"):
        close(got[k], want[k])
    got = tcmp.average_models_rmse(et, ot, tmat(train), iu, ii, block)
    want = jcmp.average_models_rmse(ej, oj, train, iu, ii, block)
    assert got["count"] == want["count"]
    close([got["rmse"], got["sse"]], [want["rmse"], want["sse"]])


def test_compare_models_accuracy_and_counts_file(tmp_path):
    (ej, et), (oj, ot), train, iu, ii = _ensemble(seed=2, m=2)
    got = tcmp.compare_models_accuracy(*et, ot, tmat(train), iu, ii,
                                       epsilon=0.25, user_block=16)
    want = jcmp.compare_models_accuracy(*ej, oj, train, iu, ii,
                                        epsilon=0.25, user_block=16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tcmp.write_accu_counts(str(tmp_path / "t.txt"), got, ii)
    jcmp.write_accu_counts(str(tmp_path / "j.txt"), want, ii)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("seed,frac", [(3, 0.2), (4, 0.1)])
def test_mean_and_var_samp_users(seed, frac):
    (ej, et), (oj, ot), train, iu, ii = _ensemble(seed=seed)
    got = tcmp.mean_and_var_same_ground_samp_users(
        et, ot, tmat(train), iu, ii, samp_frac=frac, seed=11)
    want = jcmp.mean_and_var_same_ground_samp_users(
        ej, oj, train, iu, ii, samp_frac=frac, seed=11)
    np.testing.assert_array_equal(got["users"], want["users"])
    np.testing.assert_array_equal(got["items"], want["items"])
    for k in ("mean", "var", "err"):
        close(got[k], want[k], 1e-4, 1e-6)
    assert not np.isin(np.nonzero(ii)[0], got["items"]).any()
