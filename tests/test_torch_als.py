"""The port's ALS (matfac_tpu_torch.solvers.als, data.batching.bucketed_rows)
against the JAX package's on the CPU: the same seeded inputs, at JAX's own
fixtures (tests/test_solvers.py's positive-rating bundle), through both.
Tolerances: rtol 1e-4 / atol 1e-5 after one epoch and 2e-3 after three
(f32 Grams and solves in another summation order, compounding over
epochs); bf16 dense Grams at JAX's own 5e-3 dense-vs-bucketed class."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params as JParams
from matfac_tpu.data.batching import bucketed_rows as j_bucketed_rows
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.eval.metrics import Evaluator as JEvaluator
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.solvers import als as jals
from matfac_tpu.utils import freq as jfreq
from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.batching import bucketed_rows
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.models.base import ModelMF, state_from_numpy
from matfac_tpu_torch.solvers import als

NOISE = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup_pos():
    """JAX's ``setup_pos``: the positive-rating bundle ALS's rating>0 gate
    assumes (tests/test_solvers.py:71-82)."""
    data, _, _ = synthetic_data(n_users=150, n_items=100, k=4, density=0.3,
                                seed=11, noise=NOISE, nonneg=True)
    iu, ii = jfreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    return data, iu, ii


def _pair(data, **kw):
    """(JAX Params, port Params, JAX model, port model) of one config."""
    kw = dict(dict(fac_dim=4, u_reg=0.001, i_reg=0.001, seed=5), **kw)
    jp, tp = JParams(**kw), Params(**kw)
    return (jp, tp, JModelMF(jp, data.n_users, data.n_items),
            ModelMF(tp, data.n_users, data.n_items))


def _states(jp, data, seed=0):
    js = j_init_state(jp, data.n_users, data.n_items, seed=seed)
    ts = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    return js, ts


def _close(ts, js, rtol, atol):
    np.testing.assert_allclose(ts.u_fac.numpy(), np.asarray(js.u_fac),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(ts.i_fac.numpy(), np.asarray(js.i_fac),
                               rtol=rtol, atol=atol)


# ----------------------------------------------------------------------
# bucketed_rows
# ----------------------------------------------------------------------

@pytest.mark.parametrize("view,kw", [
    ("rows", {}), ("cols", {}), ("rows", dict(min_cap=2, rows_multiple=5)),
    ("cols", dict(min_cap=16, rows_multiple=1))])
def test_bucketed_rows_match_jax_bit_for_bit(setup_pos, view, kw):
    """Power-of-two buckets, dummy rows (id 0, all masked) and the dropped
    invalid / zero-degree rows, array for array."""
    data, iu, ii = setup_pos
    mat = data.train_mat if view == "rows" else data.train_mat.transpose()
    invalid = (iu if view == "rows" else ii).copy()
    invalid[::7] = True
    got = bucketed_rows(mat, invalid=invalid, **kw)
    want = j_bucketed_rows(mat, invalid=invalid, **kw)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.cap == w.cap
        for name in ("row_ids", "cols", "vals", "mask"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    dummies = sum(int((b.mask.sum(axis=1) == 0).sum()) for b in got)
    assert (dummies > 0) == (kw.get("rows_multiple", 8) > 1)


# ----------------------------------------------------------------------
# ALSSolver
# ----------------------------------------------------------------------

@pytest.mark.parametrize("reg_exp", [0.0, 0.7])
@pytest.mark.parametrize("cg_iters", [0, 6])
def test_als_matches_jax(setup_pos, cg_iters, reg_exp):
    """Exact Cholesky and warm CG, flat and per-row lambda: after one epoch
    at rtol 1e-4 / atol 1e-5, after three at 2e-3."""
    data, iu, ii = setup_pos
    jp, tp, jm, tm = _pair(data, u_reg=0.07, i_reg=0.07,
                           reg_exponent=reg_exp)
    js_, ts_ = (jals.ALSSolver(jm, jp, data.train_mat, iu, ii,
                               cg_iters=cg_iters),
                als.ALSSolver(tm, tp, data.train_mat, iu, ii,
                              cg_iters=cg_iters, device="cpu"))
    assert ts_.reg_exp == reg_exp
    js, ts = _states(jp, data, seed=3)
    for e in range(3):
        js = js_.epoch(js, 0.0, None)
        ts = ts_.epoch(ts, 0.0)
        if e == 0:
            _close(ts, js, 1e-4, 1e-5)
    _close(ts, js, 2e-3, 2e-3)


def test_als_leaves_its_input_state_and_drops_dummy_rows(setup_pos):
    """The epoch returns new tables; invalid rows (absent from every
    bucket) keep their values, and no dummy row writes row 0."""
    data, iu, ii = setup_pos
    jp, tp, jm, tm = _pair(data)
    iu2 = iu.copy()
    iu2[[0, 3]] = True
    solver = als.ALSSolver(tm, tp, data.train_mat, iu2, ii, device="cpu")
    _, ts = _states(jp, data)
    before = ts.u_fac.clone()
    out = solver.epoch(ts, 0.0)
    assert torch.equal(ts.u_fac, before)
    assert torch.equal(out.u_fac[[0, 3]], before[[0, 3]])
    assert not torch.equal(out.u_fac[1], before[1])


def test_cholesky_nan_matches_jax_on_an_indefinite_matrix():
    """JAX's cholesky gives NaN (lower triangle) for a matrix that is not
    positive definite; torch's raises, the port's ``cholesky_nan`` gives
    JAX's factor, NaN for NaN."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 5, 5)).astype(np.float32)
    g = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(5, dtype=np.float32)
    g[1] -= 50.0 * np.eye(5, dtype=np.float32)
    want = np.asarray(jax.lax.linalg.cholesky(jnp.asarray(g)))
    got = als.cholesky_nan(torch.from_numpy(g)).numpy()
    assert np.isnan(want[1][np.tril_indices(5)]).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError):
        torch.linalg.cholesky(torch.from_numpy(g))


def test_solve_spd_cg_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 8, 8)).astype(np.float32)
    g = a @ a.transpose(0, 2, 1) + np.eye(8, dtype=np.float32)
    b = rng.normal(size=(6, 8)).astype(np.float32)
    x0 = rng.normal(size=(6, 8)).astype(np.float32)
    want = np.asarray(jals.solve_spd_cg(*map(jnp.asarray, (g, b, x0)), 5))
    got = als.solve_spd_cg(*map(torch.from_numpy, (g, b, x0)), 5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_als_chunks_large_buckets_like_jax(monkeypatch):
    """JAX's chunking of a bucket past its element budget (chunk rows =
    max(budget // max(cap * k, k * k), 256), a multiple of 8): 600 users
    in one cap-16 bucket, with the budget cut so that a chunk takes the
    256-row floor, split in three chunks, and the epochs still hold JAX's
    unchunked ones at the ALS tolerance."""
    data, _, _ = synthetic_data(n_users=600, n_items=50, k=4, density=0.2,
                                seed=5, noise=NOISE, nonneg=True)
    iu, ii = jfreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    jp, tp, jm, tm = _pair(data)
    monkeypatch.setattr(als, "CHUNK_ELEMS", 1024)
    solver = als.ALSSolver(tm, tp, data.train_mat, iu, ii, device="cpu")
    sizes = [len(c[0]) for c in solver._stage[0]]
    assert max(sizes) == 256 and len(sizes) > len(solver.u_buckets)
    js_ = jals.ALSSolver(jm, jp, data.train_mat, iu, ii)
    js, ts = _states(jp, data)
    js = js_.epoch(js, 0.0, None)
    ts = solver.epoch(ts, 0.0)
    _close(ts, js, 1e-4, 1e-5)


# ----------------------------------------------------------------------
# SubspaceALSSolver
# ----------------------------------------------------------------------

@pytest.mark.parametrize("block_dim", [2, 3])
def test_subspace_als_matches_jax_with_its_block_orders(setup_pos,
                                                        block_dim):
    """iALS++ sweeps with JAX's block permutations injected (block_dim 3
    at k = 4 wraps the block list), three epochs at 2e-3."""
    data, iu, ii = setup_pos
    jp, tp, jm, tm = _pair(data)
    js_ = jals.SubspaceALSSolver(jm, jp, data.train_mat, iu, ii,
                                 block_dim=block_dim)
    ts_ = als.SubspaceALSSolver(tm, tp, data.train_mat, iu, ii,
                                block_dim=block_dim, device="cpu")
    assert np.array_equal(ts_._block_idx, js_._block_idx)
    js, ts = _states(jp, data)
    key = jax.random.PRNGKey(0)
    for e in range(3):
        key, k = jax.random.split(key)
        perm = np.asarray(jax.random.permutation(k, ts_._block_idx.shape[0]))
        js = js_.epoch(js, 0.0, k)
        ts = ts_.epoch_with(ts, 0.0, perm)
        if e == 0:
            _close(ts, js, 1e-4, 1e-5)
    _close(ts, js, 2e-3, 2e-3)
    assert sorted(ts_.draw().tolist()) == list(range(len(ts_._block_idx)))


def test_subspace_als_refuses_reg_exponent_like_jax(setup_pos):
    data, iu, ii = setup_pos
    jp, tp, jm, tm = _pair(data, reg_exponent=0.5)
    for fn, m, p, kw in ((jals.SubspaceALSSolver, jm, jp, {}),
                         (als.SubspaceALSSolver, tm, tp,
                          dict(device="cpu"))):
        with pytest.raises(ValueError, match="reg_exponent"):
            fn(m, p, data.train_mat, iu, ii, **kw)


# ----------------------------------------------------------------------
# DenseALSSolver
# ----------------------------------------------------------------------

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype,packed,cg_iters", [
    ("f32", True, 0), ("f32", False, 0), ("f32", True, 6),
    ("bf16", True, 0), ("bf16", False, 6)])
def test_dense_als_matches_jax(setup_pos, dtype, packed, cg_iters):
    """The dense masked-Gram sweeps (row_block 32 pads both sides): f32
    values at the ALS tolerance, bf16 values (bf16 Gram operands, f32
    sums) at JAX's 5e-3 class."""
    data, iu, ii = setup_pos
    jp, tp, jm, tm = _pair(data)
    jdt, tdt = DTYPES[dtype]
    js_ = jals.DenseALSSolver(jm, jp, data.train_mat, iu, ii, row_block=32,
                              dense_dtype=jdt, packed=packed,
                              cg_iters=cg_iters)
    ts_ = als.DenseALSSolver(tm, tp, data.train_mat, iu, ii, row_block=32,
                             dense_dtype=tdt, packed=packed,
                             cg_iters=cg_iters, device="cpu")
    assert ts_.dense.dtype == tdt
    np.testing.assert_array_equal(
        ts_.dense.float().numpy(), np.asarray(js_.dense, np.float32))
    js, ts = _states(jp, data)
    tol = (1e-4, 1e-5) if dtype == "f32" else (5e-3, 5e-3)
    for e in range(3):
        js = js_.epoch(js, 0.0, None)
        ts = ts_.epoch(ts, 0.0)
        if e == 0:
            _close(ts, js, *tol)
    _close(ts, js, *((2e-3, 2e-3) if dtype == "f32" else (5e-3, 5e-3)))


@pytest.mark.parametrize("nu_pad,ni_pad,want", [
    (1024, 1024, torch.float32), (32768, 16384, torch.float32),
    (32768, 17408, torch.bfloat16), (100352, 20480, torch.bfloat16)])
def test_dense_dtype_rule_matches_jax(nu_pad, ni_pad, want):
    """dense_dtype=None: f32 while the padded matrix takes at most 2 GiB
    in f32 (the edge included), else bf16 (JAX's als.py:452-456)."""
    assert als.default_dense_dtype(nu_pad, ni_pad) == want


def test_dense_als_guard_and_refusals_match_jax(setup_pos):
    """The padded-size guard (10 GiB, JAX's value) raises JAX's ValueError
    before anything is staged; gram_int8 without CG and reg_exponent are
    refused, as in JAX."""
    data, iu, ii = setup_pos
    assert als.DenseALSSolver.MAX_DENSE_BYTES == \
        jals.DenseALSSolver.MAX_DENSE_BYTES == 10 * 1024 ** 3
    p, jp = Params(fac_dim=4), JParams(fac_dim=4)
    for fn, m, kw in ((jals.DenseALSSolver, JModelMF(jp, 200_000, 50_000),
                       {}),
                      (als.DenseALSSolver, ModelMF(p, 200_000, 50_000),
                       dict(device="cpu"))):
        with pytest.raises(ValueError, match="GiB dense"):
            fn(m, jp if fn is jals.DenseALSSolver else p, None, None,
               None, **kw)
    jp, tp, jm, tm = _pair(data)
    with pytest.raises(ValueError, match="cg_iters"):
        als.DenseALSSolver(tm, tp, data.train_mat, iu, ii, row_block=32,
                           gram_int8=True, device="cpu")
    with pytest.raises(ValueError, match="cg_iters"):
        als.dense_als_sweep(torch.zeros(32, 4), torch.zeros(32, 4),
                            torch.zeros(32, 32), 0.1, 32, gram_int8=True)
    jp, tp, jm, tm = _pair(data, reg_exponent=0.3)
    with pytest.raises(ValueError, match="reg_exponent"):
        als.DenseALSSolver(tm, tp, data.train_mat, iu, ii, row_block=32,
                           device="cpu")


@pytest.mark.parametrize("reg", [0.001, 0.05])
def test_dense_als_int8_matches_jax(setup_pos, reg):
    """gram_int8 (CG 6): the int8 masks staged in each sweep's orientation
    equal JAX's, and so do the Grams (exact int32 sums times the same
    per-column scales), so a sweep differs only in the f32 CG's order:
    each user and item sweep of three epochs, started from JAX's tables,
    holds JAX's at rtol 1e-4 / atol 1e-5 of the table's largest entry
    (at reg 0.001 the ill-conditioned systems drive the factors to ~190
    from a 0.01 start). Chained epochs are compared for the first epoch at
    reg 0.05 only: the quantization is discontinuous (a last-bit change
    of a column's maximum moves that column's scale and can flip its
    roundings), so 1e-6 of order noise grows ~100x an epoch (1e-6, 3e-4,
    4e-2 in i_fac at reg 0.05)."""
    data, iu, ii = setup_pos
    jp, tp, jm, tm = _pair(data, u_reg=reg, i_reg=reg)
    js_ = jals.DenseALSSolver(jm, jp, data.train_mat, iu, ii, row_block=32,
                              dense_dtype=jnp.float32, cg_iters=6,
                              gram_int8=True)
    ts_ = als.DenseALSSolver(tm, tp, data.train_mat, iu, ii, row_block=32,
                             dense_dtype=torch.float32, cg_iters=6,
                             gram_int8=True, device="cpu")
    for a, b in ((ts_.mask_rows, js_.mask_rows),
                 (ts_.mask_cols, js_.mask_cols)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js, _ = _states(jp, data)
    pad = lambda a, n: np.pad(np.asarray(a), ((0, n - len(a)), (0, 0)))
    u, i = pad(js.u_fac, ts_.nu_pad), pad(js.i_fac, ts_.ni_pad)
    for _ in range(3):
        for side in ("u", "i"):
            tgt, src = (u, i) if side == "u" else (i, u)
            mj, mt = ((js_.mask_rows, ts_.mask_rows) if side == "u"
                      else (js_.mask_cols, ts_.mask_cols))
            want = np.array(jals._dense_als_sweep(
                jnp.asarray(tgt), jnp.asarray(src), js_.dense, reg, 32,
                transposed=side == "i", cg_iters=6, gram_int8=True,
                mask8=mj))
            got = als.dense_als_sweep(
                torch.from_numpy(tgt), torch.from_numpy(src), ts_.dense, reg,
                32, transposed=side == "i", cg_iters=6, gram_int8=True,
                mask8=mt).numpy()
            np.testing.assert_allclose(
                got, want, rtol=1e-4,
                atol=1e-5 * max(1.0, float(np.abs(want).max())))
            if side == "u":
                u = want
            else:
                i = want
    if reg > 0.01:
        js, ts = _states(jp, data)
        _close(ts_.epoch(ts, 0.0), js_.epoch(js, 0.0, None), 1e-4, 1e-5)


def test_int8_gram_scales_equal_jax_and_products_are_exact():
    """The quantization of QQ (per-column scale max|qq| / 127 + 1e-30,
    round half to even) equals JAX's expression, compiled as in its sweep,
    bit for bit, and the int8 x int8 product is the exact int32 sum."""
    rng = np.random.default_rng(3)
    qq = (rng.normal(size=(64, 10)) * rng.uniform(0.01, 3, 10)).astype(
        np.float32)
    scale, q8 = als.quantize_columns(torch.from_numpy(qq))

    @jax.jit
    def j_quantize(qq):
        s = jnp.max(jnp.abs(qq), axis=0) / 127.0 + 1e-30
        return s, jnp.round(qq / s).astype(jnp.int8)

    j_scale, j_q8 = j_quantize(jnp.asarray(qq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(j_q8))
    m8 = (rng.random((40, 64)) < 0.3).astype(np.int8)
    got = torch._int_mm(torch.from_numpy(m8), q8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), m8.astype(np.int64) @ np.asarray(j_q8, np.int64))


def test_dense_als_bf16_survives_indefinite_grams_like_jax(setup_pos):
    """JAX's case (tests/test_solvers.py:432): bf16 values at the default
    row_block, six epochs: the factors stay finite in both packages and
    val RMSE falls. The port's val RMSE holds JAX's at the bf16 class for
    three epochs; after that the two runs part (at this regularization the
    factors reach ~190, and f32 summation-order noise grows ~60x an epoch:
    4e-3 in u after three epochs, 1.2 after five). On the CPU no Gram of
    this case fails its Cholesky in the port, so the ridge retry itself is
    pinned by the constructed case below."""
    data, iu, ii = setup_pos
    jp, tp, jm, tm = _pair(data)
    js_ = jals.DenseALSSolver(jm, jp, data.train_mat, iu, ii,
                              dense_dtype=jnp.bfloat16)
    ts_ = als.DenseALSSolver(tm, tp, data.train_mat, iu, ii,
                             dense_dtype=torch.bfloat16, device="cpu")
    jev = JEvaluator(data, iu, ii, jp)
    tev = Evaluator(data, iu, ii, tp, "cpu")
    js, ts = _states(jp, data)
    jv, tv = [], []
    for e in range(6):
        js = js_.epoch(js, 0.0, None)
        ts = ts_.epoch(ts, 0.0)
        assert torch.isfinite(ts.u_fac).all() and \
            torch.isfinite(ts.i_fac).all(), e
        jv.append(jev.rmse(jm.eval_view(js), "val"))
        tv.append(tev.rmse(tm.eval_view(ts), "val"))
    assert tv[-1] < tv[0] and jv[-1] < jv[0]
    np.testing.assert_allclose(tv[:3], jv[:3], rtol=5e-3)


def test_dense_sweep_retries_an_indefinite_bf16_gram(monkeypatch):
    """Eight sources all at q = (1, 1 + 2^-8 + 2^-12, 0, 0), all rated by
    target row 0: in bf16 QQ both q0 q1 and q1 q1 round to 1 + 2^-7, so
    that row's Gram is indefinite. Its first Cholesky fails (NaN), the
    ridge retry solves it, and the sweep is finite and holds JAX's
    ``_dense_als_sweep`` on the same inputs at the bf16 class."""
    k, n, reg = 4, 8, 1e-3
    src = np.zeros((n, k), np.float32)
    src[:, 0], src[:, 1] = 1.0, 1.0 + 2.0 ** -8 + 2.0 ** -12
    vals = np.zeros((n, n), np.float32)
    vals[0] = 1.0
    failed = []
    orig = als.cholesky_nan

    def spy(g):
        out = orig(g)
        failed.append(torch.isnan(out).flatten(1).any(dim=1).tolist())
        return out

    monkeypatch.setattr(als, "cholesky_nan", spy)
    got = als.dense_als_sweep(torch.zeros(n, k), torch.from_numpy(src),
                              torch.from_numpy(vals).to(torch.bfloat16),
                              reg, n)
    assert failed[0] == [True] + [False] * (n - 1)
    assert not any(failed[1])
    assert torch.isfinite(got).all()
    want = jals._dense_als_sweep(jnp.zeros((n, k)), jnp.asarray(src),
                                 jnp.asarray(vals, jnp.bfloat16), reg, n)
    assert np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=5e-3)
