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
# the fused route's algorithm (csrc/topk.cu, topk_fused_kernel), modelled
# ----------------------------------------------------------------------

def _keys(scores: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The kernel's 64-bit keys: order-preserving score bits << 32 | ~id
    (-0 as +0)."""
    s = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    b = s.view(np.uint32).astype(np.uint64)
    ordk = np.where(b & 0x80000000, ~b & 0xffffffff, b | 0x80000000)
    return (ordk << np.uint64(32)) | (np.uint64(0xffffffff)
                                      - ids.astype(np.uint64))


def _key_scores(keys: np.ndarray) -> np.ndarray:
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    b = np.where(hi & 0x80000000, hi & 0x7fffffff, ~hi & 0xffffffff)
    return b.astype(np.uint32).view(np.float32)


THR0 = int(_keys(np.asarray([tk.NEG_INF], np.float32),
                 np.asarray([0]))[0]) | 0xffffffff


def _fused_model(u, i, ib, ub, mu, invalid, indptr, indices, users, n,
                 splits):
    """The fused route's selection, step for step, on numpy f32: per
    catalog slice and user, item tiles of FUSED_TILE_ITEMS (item it0 + lane
    + 32 j in lane ``lane``); a cursor into the user's sorted train row
    marks each tile's excluded columns; the scores not below the threshold
    score pass; when they fit in the buffer of fused_capacity(n) keys, the
    tile's passing keys are appended at once, else the tile goes in rounds
    of 32 items (one a lane): a round's keys above the threshold key are
    appended, the buffer cut back to the best n first (raising the
    threshold to the n-th key) when they might not fit; the slice's best n
    keys after a last cut-back; with several slices, the merge of their
    keys. Scores sum over d in order."""
    TI, cap = tk.FUSED_TILE_ITEMS, tk.fused_capacity(n)
    n_items = i.shape[0]
    n_tiles = -(-n_items // TI)
    out_s = np.full((len(users), n), tk.NEG_INF, np.float32)
    out_i = np.full((len(users), n), -1, np.int32)
    stats = dict(cuts=0, appends=0, rounds=0)
    for row, user in enumerate(users):
        acc = np.zeros(n_items, np.float32)
        for d in range(u.shape[1]):
            acc = acc + u[user, d] * i[:, d]
        score = ((acc + mu) + ub[user]) + ib
        merged = []
        for sp in range(splits):
            t0, t1 = n_tiles * sp // splits, n_tiles * (sp + 1) // splits
            row_cols = indices[indptr[user]:indptr[user + 1]]
            cur = int(np.searchsorted(row_cols, t0 * TI))   # binary search
            thr, buf = THR0, []

            def cut():
                nonlocal thr, buf
                stats["cuts"] += 1
                buf = sorted(buf, reverse=True)[:n]
                if len(buf) == n:
                    thr = buf[-1]

            for t in range(t0, t1):
                ids = np.arange(t * TI, (t + 1) * TI)
                ok = ids < n_items
                ids_ok = np.minimum(ids, n_items - 1)
                excl = np.zeros(TI, bool)
                while cur < len(row_cols) and row_cols[cur] < (t + 1) * TI:
                    excl[row_cols[cur] - t * TI] = True
                    cur += 1
                s = score[ids_ok]
                thr_s = _key_scores(np.asarray([thr], np.uint64))[0]
                ok &= ~invalid[ids_ok] & ~excl & ~(s < thr_s)
                keys = _keys(s, ids)
                if len(buf) + int(ok.sum()) <= cap:
                    stats["appends"] += 1
                    buf += [int(k_) for k_ in keys[ok]]
                    continue
                for j in range(TI // 32):
                    stats["rounds"] += 1
                    sl = slice(32 * j, 32 * j + 32)
                    rnd = [int(k_) for k_ in keys[sl][ok[sl]]]
                    new = [k_ for k_ in rnd if k_ > thr]
                    if new and len(buf) + len(new) > cap:
                        cut()
                        new = [k_ for k_ in rnd if k_ > thr]
                    buf += new
            cut()
            merged += buf + [0] * (n - len(buf))
        best = sorted(merged, reverse=True)[:n]
        for slot, key in enumerate(best):
            if key > THR0:
                out_s[row, slot] = _key_scores(np.asarray([key],
                                                          np.uint64))[0]
                out_i[row, slot] = 0xffffffff - (key & 0xffffffff)
    return out_s, out_i, stats


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("n", [1, 10, 40])
def test_fused_route_model_matches_plain_and_jax(n, splits):
    """The model of the fused route against topk_plain and the JAX XLA
    scorer on a ragged 3-tile catalog: exact ties from duplicated item rows
    (the smaller id first), a user who rated every item (all -1), users with
    fewer scorable items than n (padding), repeated users; each path of
    the selection is taken."""
    n_items = 700
    dups = [(600, 3), (650, 3), (10, 512), (300, 299), (699, 100)]
    data, iu, ii, leaves = _setup(n_users=24, n_items=n_items, per_user=30,
                                  k=8, seed=9, dup_items=dups)
    ib = leaves[3].copy()   # the tied items lead most users' lists
    for g, src in enumerate(sorted({src for _, src in dups})):
        ib[src] = 4.0 - 0.25 * g
    for dst, src in dups:
        ib[dst] = ib[src]
    leaves = leaves[:3] + (ib,) + leaves[4:]
    ii[[3, 600, 650, 10, 512]] = False
    train = data.train_mat
    r, c, v = train.to_coo()
    full = np.arange(n_items)
    keep = (r != 5) & (r != 6)
    few = np.setdiff1d(full, np.arange(0, n_items, 23))   # 31 unrated
    r = np.concatenate([r[keep], np.full(n_items, 5), np.full(len(few), 6)])
    c = np.concatenate([c[keep], full, few])
    train = RatingMatrix.from_coo(r, c, np.ones(len(r), np.float32),
                                  data.n_users, n_items)
    u, i, ub, ib, mu = leaves
    sc = tr.CatalogScorer(train, iu, ii, data.n_users, n_items, device="cpu")
    users = np.concatenate([np.arange(data.n_users), [5, 6, 0]])
    indptr, indices = sc.indptr.numpy(), sc.indices.numpy()
    got_s, got_i, stats = _fused_model(u, i, ib, ub, np.float32(mu), ii,
                                       indptr, indices, users, n, splits)
    # thresholds seeded from the lanes' best (n <= 32) or rounds with
    # cut-backs in the first tiles (n = 40); the later tiles append
    # the first tiles go in rounds with cut-backs, the later ones append
    assert stats["cuts"] > len(users) * splits
    assert stats["rounds"] and stats["appends"]
    _, tv = _views(leaves)
    ws, wi = tk.topk_plain(tv.u_fac, tv.i_fac, tv.i_bias, tv.u_bias, tv.mu,
                           sc.invalid_items_dev, sc.indptr, sc.indices,
                           torch.from_numpy(users), n)
    np.testing.assert_allclose(got_s, ws.numpy(), rtol=RTOL, atol=ATOL)
    exact = _exact_scores(leaves, train, ii)[users]
    np.testing.assert_array_equal(got_i, np.where(
        np.isfinite(np.take_along_axis(exact, np.argsort(
            -exact, axis=1, kind="stable")[:, :n], 1)),
        np.argsort(-exact, axis=1, kind="stable")[:, :n], -1))
    assert (got_i[-3] == -1).all()     # user 5 rated every item
    assert np.isfinite(exact[-2]).sum() < 40   # user 6: padded at n = 40
    js, ji = jr.CatalogScorer(train, iu, ii, data.n_users, n_items,
                              user_block=8, item_block=128).topk(
        _views(leaves)[0], n)
    np.testing.assert_array_equal(got_i[:data.n_users], ji)
    np.testing.assert_allclose(got_s[:data.n_users], js, rtol=RTOL,
                               atol=ATOL)
    if n > 1:   # the ties are there and the smaller id leads
        tie = (got_s[:, 1:] == got_s[:, :-1]) & (got_i[:, 1:] >= 0)
        assert tie.any() and (got_i[:, :-1][tie] < got_i[:, 1:][tie]).all()


def test_fused_plan_counts_launches_and_splits():
    """The fused route's host plan: a power-of-2 buffer with room for n and
    one more round, slices only where the user tiles underfill the card
    and no more than fit in one wave beside them, never more than one a
    256-item tile."""
    assert [tk.fused_capacity(n) for n in (1, 10, 32, 33, 96, 97, 128)] == \
        [64, 64, 64, 128, 128, 256, 256]
    # (g): 100,000 users fill 264 resident CTAs with 1,563 user tiles
    assert tk.fused_splits(100_000, 20_000, 10, 264) == 1
    assert tk.fused_splits(16_900, 20_000, 10, 264) == 1
    # recommend on 2,048 users: 32 tiles -> 8 slices (256 CTAs, one wave)
    assert tk.fused_splits(2048, 20_000, 10, 264) == 8
    assert tk.fused_splits(2048, 20_000, 10, 132) == 4
    # 637 rows of (f): 10 tiles, capped by the catalog's 12 tiles
    assert tk.fused_splits(637, 3001, 10, 264) == 12
    assert tk.fused_splits(637, 3001, 128, 264) == 12
    assert tk.fused_splits(1, 200_000, 128, 264) == 32
    assert tk.fused_splits(1, 200_000, 1, 10_000) == 32


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
