"""The port's row-dense solver (matfac_tpu_torch.solvers.block_sgd)
against the JAX BlockSGDSolver(engine="dense"): staging helpers, the tile
ladder's choices and grids, and whole epochs with the JAX solver's own
stripe order injected."""

import numpy as np
import pytest
import torch

import jax

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import low_rank_ratings
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.ops.block_sgd_kernel import device_diag_schedule
from matfac_tpu.solvers import block_sgd as jbs
from matfac_tpu.utils import freq
from matfac_tpu_torch.models.base import ModelMF, state_from_numpy
from matfac_tpu_torch.ops.dense_row_kernel import stripe_counts
from matfac_tpu_torch.solvers import block_sgd as tbs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(n_users=60, n_items=40, seed=7, stars=False):
    mat, _, _ = low_rank_ratings(n_users, n_items, 3, density=0.3,
                                 seed=seed, noise=0.05, nonneg=True)
    if stars:
        q = np.clip(np.round(mat.values / 0.5), 1, 10) * 0.5
        mat.values[:] = q.astype(np.float32)
    params = Params(fac_dim=4, u_reg=0.01, i_reg=0.02, learn_rate=0.05,
                    seed=2)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    return mat, params, iu, ii


def jax_stripe_orders(seed: int, NU: int, n_epochs: int):
    """The stripe orders the JAX dense solver draws: one key per epoch
    from default_rng(seed + 41), then device_diag_schedule(G=1)."""
    rng = np.random.default_rng(seed + 41)
    out = []
    for _ in range(n_epochs):
        ek = jax.random.PRNGKey(int(rng.integers(2**31)))
        out.append(np.asarray(device_diag_schedule(ek, NU, 1, 1)[0][:, 0]))
    return out


def inject_orders(solver, orders):
    it = iter(orders)
    solver._stripe_order = lambda: torch.from_numpy(
        np.asarray(next(it), np.int64))


def test_rating_code_scale_matches_jax():
    rng = np.random.default_rng(0)
    cases = [np.asarray([0.5, 1.0, 2.5, 5.0, 4.5], np.float32),
             np.asarray([1, 5, 3], np.float32),
             np.asarray([2.0, 3.0, 5.0], np.float32),
             np.asarray([0.0, 1.0], np.float32),
             rng.normal(size=50).astype(np.float32) + 3.0,
             np.arange(1, 200, dtype=np.float32),
             np.asarray([-2.0, -1.0, 1.0, 2.0], np.float32),
             np.asarray([], np.float32),
             np.asarray([1.0, np.inf], np.float32)]
    want = [0.5, 1.0, 1.0, None, None, None, 1.0, None, None]
    for v, w in zip(cases, want):
        assert tbs.rating_code_scale(v) == jbs.rating_code_scale(v) == w


@pytest.mark.parametrize("n,n_blocks,block", [(37, 4, 10), (100, 7, 16),
                                              (64, 1, 128)])
def test_balance_perm_matches_jax(n, n_blocks, block):
    freq_ = np.random.default_rng(n).integers(0, 20, n)
    got = tbs._balance_perm(freq_, n, n_blocks, block)
    assert np.array_equal(got, jbs._balance_perm(freq_, n, n_blocks, block))
    assert len(np.unique(got)) == n


# (data kind, solver kwargs, expected R dtype, W dtype or None). Auto
# sizing gives 8 stripes of bu=8 here, so the ladder reckons
# (8 + 1) * 8 * 128 slots; 4 B/slot admits bf16 R + int8 W but not f32 R.
LADDER = {
    "codes": ("stars", dict(dense_codes="codes"), "int8", None),
    "lossy": ("float", dict(dense_codes="lossy"), "int8", None),
    "auto_stars_small": ("stars", {}, "float32", "int8"),
    "int8w_f32r": ("float", dict(dense_codes="off"), "float32", "int8"),
    "budget_bf16r": ("float", dict(dense_codes="off",
                                   dense_budget_bytes=9 * 8 * 128 * 4),
                     "bfloat16", "int8"),
}


def _both_solvers(kind, kw, n_users=60, n_items=40, bu=None):
    mat, params, iu, ii = _setup(n_users, n_items, stars=kind == "stars")
    j = jbs.BlockSGDSolver(JModelMF(params, n_users, n_items), params, mat,
                           iu, ii, bu=bu, bi=None, engine="dense", **kw)
    t = tbs.BlockSGDSolver(ModelMF(params, n_users, n_items), params, mat,
                           iu, ii, bu=bu, bi=None, engine="dense",
                           device="cpu", **kw)
    return j, t, params


@pytest.mark.parametrize("case", list(LADDER))
def test_ladder_picks_and_grids_match_jax(case):
    kind, kw, r_dtype, w_dtype = LADDER[case]
    j, t, _ = _both_solvers(kind, kw)
    assert (t.bu, t.NU, t.n_items_pad) == (j.bu, j.NU, j.n_items_pad)
    assert str(t.R_rows.dtype) == f"torch.{r_dtype}" == \
        f"torch.{j.R_cells.dtype}"
    assert t.r_scale == j.r_scale
    if w_dtype is None:
        assert t.W_rows is None and j.W_cells is None
    else:
        assert str(t.W_rows.dtype) == f"torch.{w_dtype}" == \
            f"torch.{j.W_cells.dtype}"
        assert np.array_equal(t.W_rows.numpy(),
                              np.asarray(j.W_cells)[:j.NU])
    # the validity counts the stripe kernel reads, staged with the tiles
    for got, want in zip(t.counts, stripe_counts(t.R_rows, t.W_rows)):
        assert torch.equal(got, want)
    got = t.R_rows
    want = np.asarray(j.R_cells)[:j.NU]
    if r_dtype == "bfloat16":   # compare bit patterns
        got, want = got.view(torch.int16), want.view(np.int16)
    assert np.array_equal(got.numpy(), want)


def test_budget_error_raises_like_jax():
    mat, params, iu, ii = _setup()
    for pkg, model, extra in ((jbs, JModelMF, dict(bu=None, bi=None)),
                              (tbs, ModelMF, dict(bu=None, bi=None,
                                                  device="cpu"))):
        with pytest.raises(ValueError, match="dense_budget"):
            pkg.BlockSGDSolver(model(params, 60, 40), params, mat, iu, ii,
                               engine="dense", dense_codes="off",
                               dense_budget_bytes=1000, **extra)
    with pytest.raises(ValueError, match="star-grid"):
        tbs.BlockSGDSolver(ModelMF(params, 60, 40), params, mat, iu, ii,
                           bu=None, bi=None, engine="dense",
                           dense_codes="codes", device="cpu")


@pytest.mark.parametrize("collision_norm", [False, True])
@pytest.mark.parametrize("kind,codes", [("float", "off"), ("stars", "codes"),
                                        ("stars", "off")])
def test_two_epochs_match_jax_with_its_stripe_order(kind, codes,
                                                    collision_norm):
    kw = dict(dense_codes=codes, collision_norm=collision_norm,
              mm_bf16=False)
    j, t, params = _both_solvers(kind, kw, bu=16)
    assert j.NU == t.NU == 4
    inject_orders(t, jax_stripe_orders(params.seed, t.NU, 2))
    sj = j_init_state(params, 60, 40, seed=3)
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    for _ in range(2):
        sj = j.epoch(sj, params.learn_rate, None)
        st = t.epoch(st, params.learn_rate)
    np.testing.assert_allclose(st.u_fac.numpy(), np.asarray(sj.u_fac),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.i_fac.numpy(), np.asarray(sj.i_fac),
                               rtol=1e-5, atol=1e-6)


def test_second_epoch_uses_the_resident_tables():
    mat, params, iu, ii = _setup()
    t = tbs.BlockSGDSolver(ModelMF(params, 60, 40), params, mat, iu, ii,
                           bu=None, bi=None, engine="dense", device="cpu")
    calls = []
    stage = t.stage_factors
    t.stage_factors = lambda st: calls.append(1) or stage(st)
    sj = j_init_state(params, 60, 40, seed=3)
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    st = t.epoch(st, params.learn_rate)
    st = t.epoch(st, params.learn_rate)
    assert len(calls) == 1
    # a state the solver did not return (e.g. a rollback snapshot) restages
    st = t.epoch(st._replace(u_fac=st.u_fac.clone()), params.learn_rate)
    assert len(calls) == 2


def test_internal_state_round_trips_the_stripe_order():
    mat, params, iu, ii = _setup()
    mk = lambda: tbs.BlockSGDSolver(ModelMF(params, 60, 40), params, mat,
                                    iu, ii, bu=None, bi=None,
                                    engine="dense", device="cpu")
    a, b = mk(), mk()
    a._stripe_order()
    b.set_internal_state(a.internal_state())
    assert torch.equal(a._stripe_order(), b._stripe_order())


def test_unported_layouts_and_engines_raise():
    """The one-hot engines are ported (tests/test_torch_block_sgd.py); the
    dense engine's cell grid and its rank-mask tables are not."""
    from matfac_tpu_torch.models.longtail import ModelDropoutSigmoid
    mat, params, iu, ii = _setup()
    model = ModelMF(params, 60, 40)
    with pytest.raises(NotImplementedError, match="item 2"):
        tbs.BlockSGDSolver(model, params, mat, iu, ii, bu=None, bi=16,
                           engine="dense", device="cpu")
    uf, if_ = freq.row_col_freq(mat)
    tmf = ModelDropoutSigmoid(params, 60, 40, user_freq=uf, item_freq=if_)
    with pytest.raises(NotImplementedError, match="item 7"):
        tbs.BlockSGDSolver(tmf, params, mat, iu, ii, bu=None, bi=None,
                           engine="dense", device="cpu")
