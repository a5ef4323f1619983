"""The dense engine's diag cell grid in the port against the JAX package:
``dense_sweep_diag`` on the same tables, tiles and rounds,
``BlockSGDSolver(engine="dense", bi < catalog)`` epochs with the JAX
solver's rounds injected, the tile ladder and its guards, and the port's
dense grid against its own one-hot diag engine at batch = cell
(tests/test_dense_block.py's cases)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import low_rank_ratings
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.models.longtail import ModelInvPopMF as JModelInvPopMF
from matfac_tpu.ops import dense_block_kernel as jdbk
from matfac_tpu.ops.block_sgd_kernel import device_diag_schedule
from matfac_tpu.solvers import block_sgd as jbs
from matfac_tpu.utils import freq
from matfac_tpu_torch.models.base import ModelMF, state_from_numpy
from matfac_tpu_torch.models.longtail import (ModelDropoutSigmoid,
                                              ModelInvPopMF,
                                              ModelPoissonDropout)
from matfac_tpu_torch.ops import dense_block_kernel as tdbk
from matfac_tpu_torch.ops import dense_row_kernel as tdrk
from matfac_tpu_torch.solvers import block_sgd as tbs

U_REG, I_REG = 0.01, 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------------
# dense_sweep_diag against JAX's, on the same inputs
# ----------------------------------------------------------------------

KINDS = ["f32+W", "bf16+W", "codes", "f32+fW"]


def _cells(kind, rng, n_cells, bu, bi, density=0.3):
    """[n_cells + 1, bu, bi] numpy tiles, the dummy cell last (all
    invalid): (R, W or None, r_scale)."""
    valid = rng.random((n_cells + 1, bu, bi)) < density
    valid[-1] = False
    if kind == "codes":
        codes = np.where(valid, rng.integers(1, 11, valid.shape), 0)
        return codes.astype(np.int8), None, 0.5
    R = np.where(valid, rng.normal(3.0, 1.0, valid.shape), 0.0).astype(
        np.float32)
    if kind.endswith("+W"):
        W = valid.astype(np.int8)
    else:
        W = np.where(valid, rng.uniform(0.5, 2.0, valid.shape), 0.0).astype(
            np.float32)
    return R, W, None


def _torch_tile(a, kind):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if kind.startswith("bf16") and \
        t.dtype == torch.float32 else t


def _jax_tile(a, kind):
    j = jnp.asarray(a)
    return j.astype(jnp.bfloat16) if kind.startswith("bf16") and \
        j.dtype == jnp.float32 else j


def _rounds(NU, NI, seed):
    """JAX's on-device diag rounds for one key: [R, NI], NU = dummy."""
    return np.asarray(device_diag_schedule(jax.random.PRNGKey(seed), NU,
                                           NI, 1)[0])


@pytest.mark.parametrize("collision_norm", [False, True])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_sweep_diag_matches_jax(kind, mm_bf16, collision_norm):
    """f32 products at rtol 1e-5; bf16 operands at the 5e-3 class of
    tests/test_pallas_dense_rows.py:97 (XLA and PyTorch round the bf16
    operands of the same sums in other places)."""
    rng = np.random.default_rng(3)
    NU, NI, bu, bi, k = 5, 3, 12, 10, 6      # 5 user blocks on 3 lanes
    R, W, r_scale = _cells(kind, rng, NU * NI, bu, bi)
    u3 = (0.3 * rng.normal(size=(NU, bu, k))).astype(np.float32)
    i3 = (0.3 * rng.normal(size=(NI, bi, k))).astype(np.float32)
    ub_idx = np.concatenate([_rounds(NU, NI, 1), _rounds(NU, NI, 2)])
    assert (ub_idx == NU).any()               # dummy lanes
    lr = 0.05 if collision_norm else 0.01
    ju, ji = jdbk.dense_sweep_diag(
        jnp.asarray(np.concatenate([u3, np.zeros((1, bu, k), np.float32)])),
        jnp.asarray(i3), jnp.asarray(ub_idx), jnp.float32(lr),
        _jax_tile(R, kind), None if W is None else _jax_tile(W, kind), NI,
        U_REG, I_REG, collision_norm, mm_bf16, r_scale=r_scale)
    tiles = tdrk.StripeTiles(_torch_tile(R, kind),
                             None if W is None else _torch_tile(W, kind),
                             r_scale, k, U_REG, I_REG, collision_norm,
                             mm_bf16, NI=NI)
    tu, ti = tiles.cells_epoch(
        torch.from_numpy(u3.copy()), torch.from_numpy(i3.copy()),
        torch.from_numpy(ub_idx.astype(np.int64)), lr)
    tol = dict(rtol=5e-3, atol=5e-4) if mm_bf16 else dict(rtol=1e-5,
                                                          atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju)[:NU], **tol)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **tol)
    # the factors moved: the check is not of an idle epoch
    assert np.abs(tu.numpy() - u3).max() > 1e-3


def test_dummy_lanes_leave_the_tables_as_they_are():
    rng = np.random.default_rng(0)
    NU, NI, bu, bi, k = 2, 3, 4, 5, 3
    R, W, _ = _cells("f32+W", rng, NU * NI, bu, bi)
    u3 = torch.from_numpy(rng.normal(size=(NU, bu, k)).astype(np.float32))
    i3 = torch.from_numpy(rng.normal(size=(NI, bi, k)).astype(np.float32))
    ub_idx = torch.full((2, NI), NU, dtype=torch.int64)
    tiles = tdrk.StripeTiles(torch.from_numpy(R), torch.from_numpy(W), None,
                             k, U_REG, I_REG, True, True, NI=NI)
    tu, ti = tiles.cells_epoch(u3.clone(), i3.clone(), ub_idx, 0.05)
    assert torch.equal(tu, u3) and torch.equal(ti, i3)


@pytest.mark.parametrize("bad,match", [
    ("repeat", "twice in one round"), ("range", "lie in"),
    ("lanes", "ub_idx must be"), ("tiles", "cell tiles must"),
    ("codes", "int8 rating codes"), ("tables", "factor tables must")])
def test_cells_epoch_refuses_bad_inputs(bad, match):
    rng = np.random.default_rng(1)
    NU, NI, bu, bi, k = 3, 3, 4, 5, 2
    R, W, _ = _cells("f32+W", rng, NU * NI, bu, bi)
    R, W = torch.from_numpy(R), torch.from_numpy(W)
    u3 = torch.zeros((NU, bu, k))
    i3 = torch.zeros((NI, bi, k))
    ub_idx = torch.tensor([[0, 1, 2], [3, 3, 0]])
    if bad == "repeat":
        ub_idx = torch.tensor([[0, 1, 0]])
    elif bad == "range":
        ub_idx = torch.tensor([[0, 4, 1]])
    elif bad == "lanes":
        ub_idx = torch.tensor([[0, 1]])
    elif bad == "tiles":
        R, W = R[:-1], W[:-1]
    elif bad == "codes":
        W = None
    elif bad == "tables":
        i3 = i3[:, :-1].contiguous()
    with pytest.raises(ValueError, match=match):
        tdrk.StripeTiles(R, W, None, k, U_REG, I_REG, True, True,
                         NI=NI).cells_epoch(u3, i3, ub_idx, 0.05)


# ----------------------------------------------------------------------
# the solver's diag cell grid against JAX's
# ----------------------------------------------------------------------

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


def jax_dense_rounds(seed: int, NU: int, NI: int, n_epochs: int):
    """The rounds the JAX dense solver draws: one key per epoch from
    default_rng(seed + 41), then device_diag_schedule(G=NI)."""
    rng = np.random.default_rng(seed + 41)
    return [torch.from_numpy(_rounds(NU, NI, int(rng.integers(2**31)))
                             .astype(np.int64)) for _ in range(n_epochs)]


def _both(kind, kw, n_users=60, n_items=40, bu=16, bi=16):
    mat, params, iu, ii = _setup(n_users, n_items, stars=kind == "stars")
    j = jbs.BlockSGDSolver(JModelMF(params, n_users, n_items), params, mat,
                           iu, ii, bu=bu, bi=bi, engine="dense", **kw)
    t = tbs.BlockSGDSolver(ModelMF(params, n_users, n_items), params, mat,
                           iu, ii, bu=bu, bi=bi, engine="dense",
                           device="cpu", **kw)
    return j, t, params


def _same_tiles(t, j):
    if j is None:
        assert t is None
        return
    got, want = t.numpy() if t.dtype != torch.bfloat16 else \
        t.view(torch.int16).numpy(), np.asarray(j)
    if t.dtype == torch.bfloat16:
        want = want.view(np.int16)
    assert str(t.dtype) == f"torch.{j.dtype}"
    np.testing.assert_array_equal(got, want)


# (data kind, solver kwargs, R dtype, W dtype or None)
LADDER = {
    "codes": ("stars", dict(dense_codes="codes"), "int8", None),
    "lossy": ("float", dict(dense_codes="lossy"), "int8", None),
    "auto": ("stars", {}, "float32", "int8"),
    "int8w": ("float", dict(dense_codes="off"), "float32", "int8"),
    "budget_bf16r": ("float", dict(dense_codes="off",
                                   dense_budget_bytes=13 * 256 * 4),
                     "bfloat16", "int8"),
}


@pytest.mark.parametrize("case", list(LADDER))
def test_cell_grid_staging_matches_jax(case):
    kind, kw, r_dtype, w_dtype = LADDER[case]
    j, t, _ = _both(kind, kw)
    assert (t.NU, t.NI, t.schedule) == (j.NU, j.NI, "diag") == (4, 3, "diag")
    tiles = t.tiles
    assert (tiles.NU, tiles.NI, tiles.bu, tiles.width) == (4, 3, 16, 16)
    assert tuple(tiles.R.shape) == tuple(j.R_cells.shape) == (13, 16, 16)
    assert str(tiles.R.dtype) == f"torch.{r_dtype}"
    assert t.r_scale == tiles.r_scale == j.r_scale
    _same_tiles(tiles.R, j.R_cells)
    _same_tiles(tiles.W, j.W_cells)
    if w_dtype is not None:
        assert str(tiles.W.dtype) == f"torch.{w_dtype}"
    # the validity counts the kernel reads (staged on a CUDA device only)
    # are JAX's cells' valid slots, the dummy cell's none
    assert tiles.counts is None
    cnt_u, cnt_i = tdrk.stripe_counts(tiles.R, tiles.W)
    valid = np.asarray(j.R_cells if j.W_cells is None else j.W_cells,
                       np.float32) != 0
    np.testing.assert_array_equal(cnt_u.numpy(), valid.sum(2))
    np.testing.assert_array_equal(cnt_i.numpy(), valid.sum(1))
    assert float(cnt_u[-1].sum()) == 0.0


@pytest.mark.parametrize("collision_norm", [False, True])
@pytest.mark.parametrize("kind,codes", [("float", "off"), ("stars", "codes"),
                                        ("stars", "off")])
def test_cell_grid_epochs_match_jax_with_its_rounds(kind, codes,
                                                    collision_norm):
    kw = dict(dense_codes=codes, collision_norm=collision_norm,
              mm_bf16=False)
    j, t, params = _both(kind, kw)
    rounds = jax_dense_rounds(params.seed, t.NU, t.NI, 3)
    sj = j_init_state(params, 60, 40, seed=3)
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    for ub_idx in rounds:
        sj = j.epoch(sj, params.learn_rate, None)
        st = t.epoch_with(st, params.learn_rate, ub_idx)
    np.testing.assert_allclose(st.u_fac.numpy(), np.asarray(sj.u_fac),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.i_fac.numpy(), np.asarray(sj.i_fac),
                               rtol=1e-5, atol=1e-6)


def test_bf16_cell_grid_epochs_match_jax_at_the_bf16_class():
    j, t, params = _both("float", dict(mm_bf16=True, collision_norm=True))
    rounds = jax_dense_rounds(params.seed, t.NU, t.NI, 2)
    sj = j_init_state(params, 60, 40, seed=3)
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    for ub_idx in rounds:
        sj = j.epoch(sj, params.learn_rate, None)
        st = t.epoch_with(st, params.learn_rate, ub_idx)
    np.testing.assert_allclose(st.u_fac.numpy(), np.asarray(sj.u_fac),
                               rtol=5e-3, atol=5e-4)


def test_weighted_cell_grid_matches_jax():
    """IFWMF's per-example weights ride f32 W cells under the default
    budget, as in JAX (tests/test_dense_block.py:113-147)."""
    mat, params, iu, ii = _setup()
    uf, itf = freq.row_col_freq(mat)
    uf, itf = np.resize(uf, 60), np.resize(itf, 40)
    jm = JModelInvPopMF(params, 60, 40, uf, itf, invalid_users=iu,
                        invalid_items=ii)
    tm = ModelInvPopMF(params, 60, 40, uf, itf, invalid_users=iu,
                       invalid_items=ii)
    kw = dict(bu=16, bi=16, collision_norm=True, mm_bf16=False,
              engine="dense")
    j = jbs.BlockSGDSolver(jm, params, mat, iu, ii, **kw)
    t = tbs.BlockSGDSolver(tm, params, mat, iu, ii, device="cpu", **kw)
    assert t.tiles.W.dtype == torch.float32 and j.W_cells.dtype == \
        jnp.float32
    _same_tiles(t.tiles.W, j.W_cells)
    sj = j_init_state(params, 60, 40, seed=3)
    st = state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")
    for ub_idx in jax_dense_rounds(params.seed, t.NU, t.NI, 2):
        sj = j.epoch(sj, params.learn_rate, None)
        st = t.epoch_with(st, params.learn_rate, ub_idx)
    np.testing.assert_allclose(st.u_fac.numpy(), np.asarray(sj.u_fac),
                               rtol=1e-5, atol=1e-6)


def test_plain_mf_w_is_int8_and_holds_every_rating():
    j, t, _ = _both("float", {})
    assert t.tiles.W.dtype == torch.int8
    assert int(t.tiles.W.sum()) == t.nnz == j.nnz


@pytest.mark.parametrize("n_users,n_items,bi", [(120, 80, 16), (900, 300, 128),
                                                (5000, 700, 256)])
def test_auto_user_blocks_match_jax(n_users, n_items, bi):
    """bu=None with a bi below the catalog: JAX's rule of >= 8 user blocks
    a cell column."""
    mat, params, iu, ii = _setup(n_users, n_items)
    j = jbs.BlockSGDSolver(JModelMF(params, n_users, n_items), params, mat,
                           iu, ii, bu=None, bi=bi, engine="dense")
    t = tbs.BlockSGDSolver(ModelMF(params, n_users, n_items), params, mat,
                           iu, ii, bu=None, bi=bi, engine="dense",
                           device="cpu")
    assert (t.bu, t.NU, t.NI) == (j.bu, j.NU, j.NI)


def test_budget_guard_raises_like_jax():
    mat, params, iu, ii = _setup()
    for pkg, model, extra in ((jbs, JModelMF, {}),
                              (tbs, ModelMF, dict(device="cpu"))):
        with pytest.raises(ValueError, match="dense_budget"):
            pkg.BlockSGDSolver(model(params, 60, 40), params, mat, iu, ii,
                               bu=16, bi=16, engine="dense",
                               dense_budget_bytes=1024, **extra)


@pytest.mark.parametrize("model", ["tmf", "tmfdropout"])
def test_masked_models_are_refused_on_the_cell_grid(model):
    """JAX threads no rank masks on the diag grid
    (matfac_tpu/solvers/block_sgd.py:281, :343); the port raises JAX's
    errors, and the same models train in the row layout."""
    mat, params, iu, ii = _setup()
    uf, itf = freq.row_col_freq(mat)
    cls = ModelDropoutSigmoid if model == "tmf" else ModelPoissonDropout
    m = cls(params, 60, 40, user_freq=uf, item_freq=itf)
    with pytest.raises(ValueError, match="row layout"):
        tbs.BlockSGDSolver(m, params, mat, iu, ii, bu=16, bi=16,
                           engine="dense", device="cpu")
    rows = tbs.BlockSGDSolver(m, params, mat, iu, ii, bu=16, bi=None,
                              engine="dense", device="cpu")
    assert rows.schedule == "row"


# ----------------------------------------------------------------------
# the port's dense grid against its own one-hot diag engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
def test_cell_grid_matches_the_one_hot_diag_engine(collision_norm, weighted):
    """batch = cell: one dense GD step a cell is the one-hot engine's
    single batch (the separability argument of
    ops/dense_block_kernel.py); both solvers draw the same rounds from
    the same schedule rng (tests/test_dense_block.py:85-147)."""
    mat, params, iu, ii = _setup()
    if weighted:
        uf, itf = freq.row_col_freq(mat)
        model = ModelInvPopMF(params, 60, 40, np.resize(uf, 60),
                              np.resize(itf, 40), invalid_users=iu,
                              invalid_items=ii)
    else:
        model = ModelMF(params, 60, 40)
    kw = dict(bu=16, bi=16, collision_norm=collision_norm, mm_bf16=False,
              device="cpu")
    dense = tbs.BlockSGDSolver(model, params, mat, iu, ii, engine="dense",
                               **kw)
    onehot = tbs.BlockSGDSolver(model, params, mat, iu, ii,
                                batch_size=1 << 20, engine="xla",
                                schedule="diag", **kw)
    assert onehot.bs == onehot.S
    s0 = j_init_state(params, 60, 40, seed=3)
    sd = so = state_from_numpy(*(np.asarray(a) for a in s0), device="cpu")
    for _ in range(3):
        sd = dense.epoch(sd, params.learn_rate)
        so = onehot.epoch(so, params.learn_rate)
    np.testing.assert_allclose(sd.u_fac.numpy(), so.u_fac.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sd.i_fac.numpy(), so.i_fac.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_cell_grid_converges():
    """tests/test_dense_block.py:150: 60 epochs of 16 x 16 cells reach the
    synthetic noise floor."""
    mat, params, iu, ii = _setup(n_users=120, n_items=80)
    dense = tbs.BlockSGDSolver(ModelMF(params, 120, 80), params, mat, iu, ii,
                               bu=16, bi=16, collision_norm=True,
                               engine="dense", device="cpu")
    s0 = j_init_state(params, 120, 80, seed=1)
    state = state_from_numpy(*(np.asarray(a) for a in s0), device="cpu")
    for _ in range(60):
        state = dense.epoch(state, params.learn_rate)
    r, c, v = mat.to_coo()
    keep = ~iu[r] & ~ii[c]
    r, c, v = r[keep], c[keep], v[keep]
    U, I = state.u_fac.numpy(), state.i_fac.numpy()
    rmse = float(np.sqrt(np.mean((np.sum(U[r] * I[c], axis=1) - v) ** 2)))
    assert rmse < 0.15


def test_cell_grid_keeps_its_tables_resident_and_resumes():
    mat, params, iu, ii = _setup()
    mk = lambda: tbs.BlockSGDSolver(ModelMF(params, 60, 40), params, mat,
                                    iu, ii, bu=16, bi=16, engine="dense",
                                    device="cpu")
    t = mk()
    calls = []
    stage = t.stage_factors
    t.stage_factors = lambda st: calls.append(1) or stage(st)
    s0 = j_init_state(params, 60, 40, seed=3)
    st = state_from_numpy(*(np.asarray(a) for a in s0), device="cpu")
    st = t.epoch(st, params.learn_rate)
    st = t.epoch(st, params.learn_rate)
    assert len(calls) == 1
    # an exact resume: the schedule rng's state carries over
    a, b = mk(), mk()
    a.draw_schedule()
    b.set_internal_state(a.internal_state())
    assert torch.equal(a.draw_schedule(), b.draw_schedule())
