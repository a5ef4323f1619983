"""The port's full-catalog top-N (matfac_tpu_torch.ops.topk_kernel, on the
CPU its plain version) and ranking eval (matfac_tpu_torch.eval.ranking)
against the JAX package: the XLA ``CatalogScorer``, the Pallas
``topk_tiles`` in interpret mode, and the LOO / sampled metrics, on the
same numpy inputs.

Scores are held at rtol 1e-5 / atol 1e-6: f32 dot products summed in
another order, and ``topk_tiles`` adds mu and u_bias after the item bias.
Ids are held exactly where no two scores are that close."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matfac_tpu.data.csr import RatingMatrix
from matfac_tpu.data.synthetic import leave_one_out_data
from matfac_tpu.eval import ranking as jr
from matfac_tpu.models.base import EvalView as JView
from matfac_tpu.ops.topk_kernel import PallasCatalogScorer
from matfac_tpu.utils import freq
from matfac_tpu_torch.eval import ranking as tr
from matfac_tpu_torch.models.base import EvalView
from matfac_tpu_torch.ops import topk_kernel as tk

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _leaves(n_users, n_items, k, seed, dup_items=()):
    """(u_fac, i_fac, u_bias, i_bias, mu) f32 from a seed; each (dst, src)
    in ``dup_items`` copies item src's row and bias to item dst."""
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 1, (n_users, k))
    i = rng.normal(0, 1, (n_items, k))
    ub = rng.normal(0, 0.3, n_users)
    ib = rng.normal(0, 0.3, n_items)
    for dst, src in dup_items:
        i[dst], ib[dst] = i[src], ib[src]
    return tuple(np.asarray(a, np.float32)
                 for a in (u, i, ub, ib, np.asarray(0.4)))


def _views(leaves):
    return (JView(*(jnp.asarray(a) for a in leaves)),
            EvalView(*(torch.from_numpy(a.copy()) for a in leaves)))


def _setup(n_users=40, n_items=70, per_user=9, seed=3, k=6, n_invalid=5,
           dup_items=()):
    data = leave_one_out_data(n_users=n_users, n_items=n_items,
                              per_user=per_user, seed=seed)
    iu, ii = freq.invalid_users_items(data.train_mat, n_users, n_items)
    ii = ii.copy()
    ii[np.random.default_rng(seed).choice(n_items, n_invalid,
                                          replace=False)] = True
    leaves = _leaves(n_users, n_items, k, seed + 1, dup_items)
    return data, iu, ii, leaves


def _exact_scores(leaves, train_mat, ii):
    """float64 scores with the exclusions at -inf: the separation check."""
    u, i, ub, ib, mu = (a.astype(np.float64) for a in leaves)
    sc = u @ i.T + mu + ub[:, None] + ib[None, :]
    sc[:, ii] = -np.inf
    r, c, _ = train_mat.to_coo()
    keep = r < sc.shape[0]
    sc[r[keep], c[keep]] = -np.inf
    return sc


def _assert_no_near_ties(sc, n, gap=1e-4):
    top = -np.sort(-sc, axis=1)[:, :n + 1]
    fin = np.isfinite(top[:, :-1]) & np.isfinite(top[:, 1:])
    d = (top[:, :-1] - top[:, 1:])[fin]
    assert d.size == 0 or d.min() > gap, "pick another seed: near-ties"


def _assert_same(got_s, got_i, want_s, want_i):
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("n", [1, 5, 12])
def test_topk_matches_xla_scorer(n):
    data, iu, ii, leaves = _setup()
    jv, tv = _views(leaves)
    _assert_no_near_ties(_exact_scores(leaves, data.train_mat, ii), n)
    js, ji = jr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                              data.n_items, user_block=16,
                              item_block=32).topk(jv, n)
    ts, ti = tr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                              data.n_items, device="cpu").topk(tv, n)
    assert ti.dtype == np.int32 and ts.shape == (data.n_users, n)
    _assert_same(ts, ti, js, ji)


def test_topk_matches_pallas_topk_tiles_interpret():
    """topk_tiles drops mu and u_bias (ranking-invariant): add them back
    on its scorable slots."""
    data, iu, ii, leaves = _setup(n_users=24, n_items=50, seed=5)
    n = 6
    jv, tv = _views(leaves)
    _assert_no_near_ties(_exact_scores(leaves, data.train_mat, ii), n)
    pls = PallasCatalogScorer(data.train_mat, iu, ii, data.n_users,
                              data.n_items, user_block=8, item_block=128,
                              interpret=True)
    ps, pi = pls.topk(jv, n)
    ps = np.where(pi >= 0, ps + leaves[4] + leaves[2][:, None], ps)
    ts, ti = tr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                              data.n_items, device="cpu").topk(tv, n)
    _assert_same(ts, ti, ps, pi)


def test_exact_ties_go_to_the_smallest_id():
    """Duplicated item rows score exactly alike: the smaller id comes
    first, in the port as in the XLA scorer and in a stable numpy sort."""
    dups = [(40, 3), (41, 3), (7, 12), (55, 12), (56, 30), (2, 30)]
    data, iu, ii, leaves = _setup(n_items=60, n_invalid=0, dup_items=dups,
                                  seed=8)
    n = 20
    jv, tv = _views(leaves)
    js, ji = jr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                              data.n_items, user_block=16,
                              item_block=16).topk(jv, n)
    ts, ti = tr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                              data.n_items, device="cpu").topk(tv, n)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    sc = _exact_scores(leaves, data.train_mat, ii)
    want = np.argsort(-sc, axis=1, kind="stable")[:, :n]
    np.testing.assert_array_equal(ti, want)
    np.testing.assert_array_equal(ji, want)
    # the ties are really there and really split by id
    tied = [(u, j) for u in range(data.n_users) for j in range(n - 1)
            if ts[u, j] == ts[u, j + 1]]
    assert tied and all(ti[u, j] < ti[u, j + 1] for u, j in tied)


def test_n_beyond_the_scorable_items_pads_with_minus_one():
    data, iu, ii, leaves = _setup(n_users=10, n_items=20, per_user=8,
                                  n_invalid=4)
    n = 30   # more than the catalog
    jv, tv = _views(leaves)
    js, ji = jr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                              data.n_items, user_block=8,
                              item_block=32).topk(jv, n)
    ts, ti = tr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                              data.n_items, device="cpu").topk(tv, n)
    _assert_same(ts, ti, js, ji)
    n_scorable = (np.isfinite(_exact_scores(leaves, data.train_mat, ii))
                  ).sum(axis=1)
    for u in range(data.n_users):
        assert (ti[u, :n_scorable[u]] >= 0).all()
        assert (ti[u, n_scorable[u]:] == -1).all()
        assert (ts[u, n_scorable[u]:] == tk.NEG_INF).all()


def test_loo_padding_slots_never_match_item_zero():
    """The trap of tests/test_eval.py: a held-out item 0 that is train-rated
    must not match the padding slots of users with fewer scorable items
    than n."""
    n_users, n_items = 4, 8
    r = np.repeat(np.arange(n_users), 5)
    c = np.tile(np.arange(5), n_users)
    train = RatingMatrix.from_coo(r, c, np.ones(len(r), np.float32),
                                  n_users, n_items)
    test = RatingMatrix.from_coo(np.arange(n_users),
                                 np.zeros(n_users, np.int64),
                                 np.ones(n_users, np.float32),
                                 n_users, n_items)
    iu = np.zeros(n_users, bool)
    ii = np.zeros(n_items, bool)
    leaves = _leaves(n_users, n_items, 3, 0)
    jv, tv = _views(leaves)
    sc = tr.CatalogScorer(train, iu, ii, n_users, n_items, device="cpu")
    js = jr.CatalogScorer(train, iu, ii, n_users, n_items, user_block=4,
                          item_block=128)
    assert sc.hit_rate(tv, test, 10) == js.hit_rate(jv, test, 10) == 0.0
    assert sc.arhr(tv, test, 10) == js.arhr(jv, test, 10) == 0.0
    _, ti = sc.topk(tv, 10)
    assert (ti[:, 3:] == -1).all()


def test_more_train_rows_than_users():
    """Train rows past n_users are dropped (the reference truncates)."""
    data = leave_one_out_data(n_users=30, n_items=25, per_user=8, seed=5)
    n_users, n_items = 24, 25
    iu = np.zeros(n_users, bool)
    ii = np.zeros(n_items, bool)
    leaves = _leaves(n_users, n_items, 4, 2)
    jv, tv = _views(leaves)
    _assert_no_near_ties(_exact_scores(leaves, data.train_mat, ii), 5)
    js, ji = jr.CatalogScorer(data.train_mat, iu, ii, n_users, n_items,
                              user_block=8, item_block=32).topk(jv, 5)
    ts, ti = tr.CatalogScorer(data.train_mat, iu, ii, n_users, n_items,
                              device="cpu").topk(tv, 5)
    _assert_same(ts, ti, js, ji)
    for u in range(n_users):
        assert not set(data.train_mat.row(u)[0]) & set(ti[u])


def test_topk_catalog_any_user_set_and_cpu_route():
    """Any ids in any order, repeats included, through the wrapper; a CPU
    tensor takes the plain version and launches nothing."""
    data, iu, ii, leaves = _setup()
    _, tv = _views(leaves)
    sc = tr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                          data.n_items, device="cpu")
    all_s, all_i = sc.topk(tv, 7)
    users = torch.tensor([5, 0, 39, 5, 17], dtype=torch.int64)
    before = tk.topk_catalog.launches
    s, i = sc.topk_users(tv, users, 7)
    assert tk.topk_catalog.launches == before
    np.testing.assert_array_equal(i.numpy(), all_i[users.numpy()])
    np.testing.assert_array_equal(s.numpy(), all_s[users.numpy()])
    with pytest.raises(ValueError, match="user ids"):
        sc.topk_users(tv, torch.tensor([data.n_users]), 7)
    with pytest.raises(ValueError, match="int64"):
        sc.topk_users(tv, torch.tensor([1], dtype=torch.int32), 7)


def test_plain_version_chunks_users(monkeypatch):
    data, iu, ii, leaves = _setup()
    _, tv = _views(leaves)
    sc = tr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                          data.n_items, device="cpu")
    whole = sc.topk(tv, 9)
    monkeypatch.setattr(tk, "SCRATCH_FLOATS", 3 * data.n_items)
    assert tk.chunk_users(data.n_items) == 3
    chunked = sc.topk(tv, 9)
    # the product's blocking follows the row count: last-bit differences
    np.testing.assert_allclose(chunked[0], whole[0], rtol=1e-6)
    np.testing.assert_array_equal(chunked[1], whole[1])


# ----------------------------------------------------------------------
# LOO metrics
# ----------------------------------------------------------------------

def _loo_case():
    data = leave_one_out_data(n_users=60, n_items=45, per_user=10, seed=4,
                              structured=True)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    iu = iu.copy()
    iu[::9] = True   # invalid users leave the denominator
    leaves = _leaves(data.n_users, data.n_items, 5, 7)
    return data, iu, ii, leaves


def test_hit_rate_arhr_and_loo_score_match_jax():
    """HR is a count over valid users: equal exactly. ARHR sums 1/(rank+1)
    in f32 in the JAX package and in float64 in the port: rel 1e-6."""
    data, iu, ii, leaves = _loo_case()
    jv, tv = _views(leaves)
    js = jr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                          data.n_items, user_block=16, item_block=64)
    ts = tr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                          data.n_items, device="cpu")
    for n in (1, 10, 30):
        _assert_no_near_ties(_exact_scores(leaves, data.train_mat, ii), n)
        for mat in (data.val_mat, data.test_mat):
            assert ts.hit_rate(tv, mat, n) == js.hit_rate(jv, mat, n)
            assert ts.arhr(tv, mat, n) == pytest.approx(js.arhr(jv, mat, n),
                                                        rel=1e-6)
            _, ti = ts.topk(tv, n)
            _, ji = js.topk(jv, n)
            for rec in (False, True):
                got = tr._loo_score(ti, mat, iu, data.n_users, rec)
                assert got == jr._loo_score(ji, mat, iu, data.n_users, rec)
                assert got == pytest.approx(ts.loo_credit(
                    torch.from_numpy(ti), mat, rec), rel=1e-12)
    assert 0.0 < ts.hit_rate(tv, data.val_mat, 10) < 1.0


def test_loo_staging_is_cached_on_matrix_identity():
    data, iu, ii, leaves = _loo_case()
    _, tv = _views(leaves)
    ts = tr.CatalogScorer(data.train_mat, iu, ii, data.n_users,
                          data.n_items, device="cpu")
    a = ts._loo_staged(data.val_mat)
    assert ts._loo_staged(data.val_mat) is a
    b = ts._loo_staged(data.test_mat)
    assert b is not a and ts._loo_mat is data.test_mat
    # an equal copy is another matrix: staged anew, same values
    c = ts._loo_staged(data.test_mat.copy())
    assert c is not b and all(torch.equal(x, y) for x, y in zip(c[:2],
                                                                 b[:2]))


def test_sampled_and_popularity_metrics_match_jax():
    data, iu, ii, leaves = _loo_case()
    jv, tv = _views(leaves)
    pop = data.train_mat.col_degrees().astype(np.float64)
    for kw in (dict(), dict(popularity=pop, seed=3)):
        want_c, want_u = jr.sample_negatives(
            data.test_mat, data.train_mat, iu, ii, data.n_users,
            data.n_items, n_candidates=20, **kw)
        got_c, got_u = tr.sample_negatives(
            data.test_mat, data.train_mat, iu, ii, data.n_users,
            data.n_items, n_candidates=20, **kw)
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_u, want_u)
        jh, ja = jr.sampled_ranking_metrics(jv, data.test_mat,
                                            data.train_mat, iu, ii, n=5,
                                            n_candidates=20, blk=16, **kw)
        th, ta = tr.sampled_ranking_metrics(tv, data.test_mat,
                                            data.train_mat, iu, ii, n=5,
                                            n_candidates=20, blk=16, **kw)
        assert th == jh
        assert ta == pytest.approx(ja, rel=1e-6)
        assert tr.popularity_ranking_metrics(
            data.test_mat, data.train_mat, iu, ii, data.n_users,
            data.n_items, n=5, n_candidates=20, **kw) == \
            jr.popularity_ranking_metrics(
                data.test_mat, data.train_mat, iu, ii, data.n_users,
                data.n_items, n=5, n_candidates=20, **kw)
