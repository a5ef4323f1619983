"""The port's one-hot cell engine (matfac_tpu_torch.solvers.block_sgd with
engine "xla" / "pallas", and ops/block_sgd_kernel's plain versions) against
the JAX BlockSGDSolver: the numpy staging helpers, the staged streams bit
for bit, the row schedule's draws, whole epochs of the row schedule (JAX's
Pallas kernel in interpret mode and its XLA engine) and of the diag
schedule with JAX's on-device schedule injected, plain MF, IFWMF and TMF,
and the solver's guards."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import low_rank_ratings
from matfac_tpu.models import longtail as jlt
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import ModelMFBias as JModelMFBias
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.ops import block_sgd_kernel as jbsk
from matfac_tpu.solvers import block_sgd as jbs
from matfac_tpu.utils import freq
from matfac_tpu_torch.models import longtail as tlt
from matfac_tpu_torch.models.base import ModelMF, state_from_numpy
from matfac_tpu_torch.ops import block_sgd_kernel as tbsk
from matfac_tpu_torch.solvers import block_sgd as tbs

# the class the JAX package pins between its two engines
# (tests/test_block_sgd.py): summation order only. It holds at mm_bf16 too:
# on the CPU the plain version rounds at JAX's points and sums in an order
# close enough that no bf16 rounding flips in these epochs
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(n_users=60, n_items=40, seed=7):
    mat, _, _ = low_rank_ratings(n_users, n_items, 3, density=0.3,
                                 seed=seed, noise=0.05, nonneg=True)
    params = Params(fac_dim=4, u_reg=0.01, i_reg=0.02, learn_rate=0.05,
                    seed=2)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    return mat, params, iu, ii


def _models(algo, params, mat, n_users, n_items, iu, ii):
    """(JAX model, port model) of one algo on the same frequencies."""
    if algo == "mf":
        return (JModelMF(params, n_users, n_items),
                ModelMF(params, n_users, n_items))
    uf, if_ = freq.row_col_freq(mat)
    if algo == "ifwmf":
        return tuple(m(params, n_users, n_items, uf, if_, iu, ii)
                     for m in (jlt.ModelInvPopMF, tlt.ModelInvPopMF))
    return tuple(m(params, n_users, n_items, uf, if_)
                 for m in (jlt.ModelDropoutSigmoid, tlt.ModelDropoutSigmoid))


def _both(algo="mf", **kw):
    """(JAX solver, port solver, params) on the same data; JAX's Pallas
    engine runs in interpret mode."""
    mat, params, iu, ii = _setup()
    jm, tm = _models(algo, params, mat, 60, 40, iu, ii)
    kw = dict(dict(batch_size=8, bu=16, bi=8), **kw)
    j = jbs.BlockSGDSolver(jm, params, mat, iu, ii,
                           interpret=kw.get("engine") == "pallas", **kw)
    t = tbs.BlockSGDSolver(tm, params, mat, iu, ii, device="cpu", **kw)
    return j, t, params


def _states(params):
    sj = j_init_state(params, 60, 40, seed=3)
    return sj, state_from_numpy(*(np.asarray(a) for a in sj), device="cpu")


def _assert_factors(st, sj):
    np.testing.assert_allclose(st.u_fac.numpy(), np.asarray(sj.u_fac),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.i_fac.numpy(), np.asarray(sj.i_fac),
                               rtol=RTOL, atol=ATOL)


def _jax_diag_schedule(j):
    """The schedule the JAX solver's next diag epoch draws: one integer
    from its numpy schedule rng as a PRNG key, then device_diag_schedule
    (read from a copy of the rng, so the solver still draws it)."""
    rng = np.random.default_rng()
    rng.bit_generator.state = j._sched_rng.bit_generator.state
    ek = jax.random.PRNGKey(int(rng.integers(2**31)))
    return jbsk.device_diag_schedule(ek, j.NU, j.NI, j.S // j.bs)


# ----------------------------------------------------------------------
# numpy helpers and staging
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s0,lanes", [(100, 1), (5000, 1), (30000, 53),
                                      (300, 8)])
def test_auto_batch_size_matches_jax(s0, lanes):
    assert tbs.auto_batch_size(s0, lanes) == jbs.auto_batch_size(s0, lanes)


@pytest.mark.parametrize("bs,width", [(4, 5), (16, 8)])
def test_stage_batch_collision_counts_matches_jax(bs, width):
    rng = np.random.default_rng(bs)
    wts = (rng.random((6, 32)) < 0.7) * rng.uniform(0.1, 1, (6, 32))
    loc = rng.integers(0, width, (6, 32)).astype(np.int32)
    got = tbs.stage_batch_collision_counts(wts.astype(np.float32), loc, bs,
                                           width)
    want = jbs.stage_batch_collision_counts(wts.astype(np.float32), loc, bs,
                                            width)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("collision_norm", [False, True])
@pytest.mark.parametrize("algo", ["mf", "ifwmf", "tmf"])
@pytest.mark.parametrize("schedule", ["row", "diag"])
def test_staged_streams_match_jax(schedule, algo, collision_norm):
    j, t, _ = _both(algo, schedule=schedule, collision_norm=collision_norm)
    assert (t.NU, t.NI, t.S, t.bs, t.nnz) == (j.NU, j.NI, j.S, j.bs, j.nnz)
    assert t.pad_frac == j.pad_frac and t.use_mask == j.use_mask
    assert t.use_mask == (algo == "tmf")
    assert np.array_equal(t.u_perm, j.u_perm)
    assert np.array_equal(t.i_perm, j.i_perm)
    for name in ("u_loc", "i_loc", "vals", "wts", "lams"):
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    if collision_norm:
        for name in ("cnu", "cni"):
            assert np.array_equal(getattr(t, name).numpy(),
                                  np.asarray(getattr(j, name))), name
    else:
        assert t.cnu is None and t.cni is None
    if schedule == "diag":   # the all-invalid dummy cell
        assert t.u_loc.shape[0] == t.NU * t.NI + 1
        assert not bool(t.wts[-1].any())
    if algo == "ifwmf":      # float example weights ride the stream
        w = t.wts[t.wts > 0]
        assert bool(((w > 0) & (w < 1)).all())


def test_row_schedule_draws_match_jax():
    j, t, _ = _both()
    for _ in range(3):
        for got, want in zip(t._build_schedule(), j._build_schedule()):
            assert np.array_equal(got, np.asarray(want))


def test_diag_draw_keeps_the_numpy_stream_in_step_and_round_trips():
    """draw_schedule takes the one integer JAX draws for its PRNG key per
    diag epoch, so the numpy schedule rng stays in step with JAX's; the
    solver's internal state round-trips it."""
    j, t, _ = _both(schedule="diag")
    a = t.draw_schedule()
    j._sched_rng.integers(2**31)
    assert t._sched_rng.bit_generator.state == j._sched_rng.bit_generator.state
    _, twin, _ = _both(schedule="diag")
    twin.set_internal_state(t.internal_state())
    for x, y in zip(t.draw_schedule(), twin.draw_schedule()):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(a, t.draw_schedule()))


@pytest.mark.parametrize("NU,G,n_steps", [(5, 3, 2), (7, 7, 1), (261, 53, 1),
                                          (4, 5, 3)])
def test_diag_schedule_has_the_jax_structure(NU, G, n_steps):
    """Rounds of G lanes, identity item lanes, every real cell exactly once
    per epoch, real user blocks distinct within a round, dummy lanes NU,
    offsets in range: the structure of JAX's device_diag_schedule."""
    got = tbsk.diag_schedule(torch.Generator().manual_seed(1), NU, G,
                             n_steps)
    want = jbsk.device_diag_schedule(jax.random.PRNGKey(1), NU, G, n_steps)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
    ub, ib, bo = (x.numpy() for x in got)
    assert (ib == np.arange(G)).all()
    assert bo.min() >= 0 and bo.max() < max(n_steps, 1)
    real = ub < NU
    cells = sorted(zip(ub[real].tolist(), ib[real].tolist()))
    assert cells == [(u, i) for u in range(NU) for i in range(G)]
    for t in range(ub.shape[0]):
        assert len(set(ub[t][real[t]].tolist())) == real[t].sum()
    assert (~real).sum() == np.sum(np.asarray(want[0]) == NU)


# ----------------------------------------------------------------------
# epochs against JAX
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_row_epochs_match_jax(engine, collision_norm, mm_bf16):
    """Two row-schedule epochs, each solver drawing its own (identical)
    schedule, against JAX's Pallas kernel (interpret mode) and XLA
    engine."""
    j, t, params = _both(engine=engine, collision_norm=collision_norm,
                         mm_bf16=mm_bf16)
    sj, st = _states(params)
    for _ in range(2):
        sj = j.epoch(sj, params.learn_rate, None)
        st = t.epoch(st, params.learn_rate)
    _assert_factors(st, sj)


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
def test_diag_epochs_match_jax_with_its_schedule(collision_norm, mm_bf16):
    j, t, params = _both(schedule="diag", collision_norm=collision_norm,
                         mm_bf16=mm_bf16)
    sj, st = _states(params)
    for _ in range(2):
        sched = _jax_diag_schedule(j)
        sj = j.epoch(sj, params.learn_rate, None)
        st = t.epoch_with(st, params.learn_rate, sched)
    _assert_factors(st, sj)


@pytest.mark.parametrize("schedule", ["row", "diag"])
@pytest.mark.parametrize("algo", ["ifwmf", "tmf"])
def test_longtail_epochs_match_jax(algo, schedule):
    """IFWMF's float weights and TMF's static per-pair ranks through the
    engine (f32 products)."""
    j, t, params = _both(algo, schedule=schedule, mm_bf16=False)
    sj, st = _states(params)
    for _ in range(2):
        if schedule == "diag":
            sched = _jax_diag_schedule(j)
            sj = j.epoch(sj, params.learn_rate, None)
            st = t.epoch_with(st, params.learn_rate, sched)
        else:
            sj = j.epoch(sj, params.learn_rate, None)
            st = t.epoch(st, params.learn_rate)
    _assert_factors(st, sj)


@pytest.mark.parametrize("schedule", ["row", "diag"])
def test_pad_k_is_accepted_and_exact(schedule):
    """pad_k only filled the TPU's matrix lanes: the port accepts it and
    trains at fac_dim, equal to JAX's padded epoch."""
    j, t, params = _both(schedule=schedule, pad_k=16, mm_bf16=False)
    assert t.pad_k == 16
    sj, st = _states(params)
    if schedule == "diag":
        st = t.epoch_with(st, params.learn_rate, _jax_diag_schedule(j))
    else:
        st = t.epoch(st, params.learn_rate)
    sj = j.epoch(sj, params.learn_rate, None)
    assert tuple(st.u_fac.shape) == (60, 4)
    _assert_factors(st, sj)


def _dyadic(rng, shape):
    """+-m / 256 with m in [65, 127]: exact in bf16, and products summed
    over k in any order are exact in f32."""
    m = rng.integers(65, 128, shape)
    return (np.where(rng.random(shape) < 0.5, -1, 1) * m / 256.0).astype(
        np.float32)


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
def test_batch_update_matches_jax(collision_norm, use_mask, mm_bf16):
    """One minibatch (JAX _batch_update) with ids repeating within the
    batch, float weights, padding slots and rank masks; factors exact in
    bf16, so both precisions hold at the f32 class."""
    rng = np.random.default_rng(3)
    bu, bi, k, b = 8, 6, 16, 40
    U, I = _dyadic(rng, (bu, k)), _dyadic(rng, (bi, k))
    valid = rng.random(b) < 0.8
    u = np.where(valid, rng.integers(0, bu, b), 0).astype(np.int32)
    i = np.where(valid, rng.integers(0, bi, b), 0).astype(np.int32)
    r = rng.normal(3, 1, b).astype(np.float32)
    w = (valid * rng.uniform(0.2, 1, b)).astype(np.float32)
    lam = np.where(valid, rng.integers(1, k + 1, b), 1).astype(np.int32)
    cnu = tbs.stage_batch_collision_counts(w[None], u[None], b, bu)[0]
    cni = tbs.stage_batch_collision_counts(w[None], i[None], b, bi)[0]
    lr, u_reg, i_reg = 0.05, 0.01, 0.02
    ju, ji = jbsk._batch_update(
        jnp.asarray(U), jnp.asarray(I), jnp.asarray(u), jnp.asarray(i),
        jnp.asarray(r), jnp.asarray(w), jnp.asarray(cnu), jnp.asarray(cni),
        jnp.asarray(lam), jnp.float32(lr), k, bu, bi, u_reg, i_reg,
        collision_norm, use_mask, jnp.bfloat16 if mm_bf16 else jnp.float32)
    t = lambda a: torch.from_numpy(a)[None]
    tu, ti = tbsk.batch_update(t(U), t(I), t(u), t(i), t(r), t(w), t(cnu),
                               t(cni), t(lam), lr, u_reg, i_reg,
                               collision_norm, use_mask, mm_bf16)
    np.testing.assert_allclose(tu[0].numpy(), np.asarray(ju), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ti[0].numpy(), np.asarray(ji), rtol=RTOL,
                               atol=ATOL)


# ----------------------------------------------------------------------
# the solver around the epochs
# ----------------------------------------------------------------------

def test_second_epoch_uses_the_resident_tables():
    _, t, params = _both(schedule="diag")
    _, st = _states(params)
    calls = []
    stage = t.stage_factors
    t.stage_factors = lambda s: calls.append(1) or stage(s)
    st = t.epoch(st, params.learn_rate)
    st = t.epoch(st, params.learn_rate)
    assert len(calls) == 1
    t.epoch(st._replace(i_fac=st.i_fac.clone()), params.learn_rate)
    assert len(calls) == 2


def test_cpu_route_runs_the_plain_version_and_counts_no_launch():
    _, t, params = _both()
    _, st = _states(params)
    before = (tbsk.block_sgd_epoch.launches,
              tbsk.block_sgd_diag_epoch.launches)
    u_tab, i_tab = t.stage_factors(st)
    sched = t._build_schedule()
    kw = t.sweep_kwargs()
    want = tbsk.block_sweep_rows(u_tab.clone(), i_tab.clone(), *sched,
                                 0.05, *t.streams, **kw)
    got = tbsk.block_sgd_epoch(u_tab.clone(), i_tab.clone(), *sched, 0.05,
                               *t.streams, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (tbsk.block_sgd_epoch.launches,
            tbsk.block_sgd_diag_epoch.launches) == before


def test_wrappers_check_their_inputs():
    _, t, params = _both(schedule="diag")
    _, st = _states(params)
    u_tab, i_tab = t.stage_factors(st)
    sched = t.draw_schedule()
    kw = t.sweep_kwargs()
    streams = list(t.streams)
    bad = streams[0].clone()
    bad[0, 0] = t.bu
    with pytest.raises(ValueError, match="outside"):
        tbsk.block_sgd_diag_epoch(u_tab, i_tab, *sched, 0.05, bad,
                                  *streams[1:], **kw)
    with pytest.raises(ValueError, match="float32"):
        tbsk.block_sgd_diag_epoch(u_tab.double(), i_tab, *sched, 0.05,
                                  *streams, **kw)
    with pytest.raises(ValueError, match="cnu"):
        tbsk.block_sgd_diag_epoch(u_tab, i_tab, *sched, 0.05,
                                  *streams[:4], None, None, None, **kw)
    with pytest.raises(ValueError, match="whole batches"):
        tbsk.block_sgd_diag_epoch(u_tab, i_tab, *sched, 0.05, *streams,
                                  **dict(kw, bs=t.bs + 1))


class _Sampled(tlt.ModelDropoutSigmoid):
    name = "tmf_dropout"
    stochastic_rank = True


class _SideGated(ModelMF):
    name = "mf_freq"

    def update_side_masks(self, u_idx, i_idx):
        return torch.ones(u_idx.shape + (1,)), torch.ones(i_idx.shape + (1,))


class _Bias(ModelMF):
    name = "mf_bias"
    use_bias = True
    use_factors = False


def _guard_models(case, params, mat, iu, ii):
    uf, if_ = freq.row_col_freq(mat)
    if case == "sampled_ranks":
        return (jlt.ModelPoissonDropout(params, 60, 40, uf, if_),
                _Sampled(params, 60, 40, uf, if_))
    if case == "side_gates":
        g_u, g_i = np.ones(60, bool), np.ones(40, bool)
        return (jlt.ModelSideGatedMF(params, 60, 40, g_u, g_i),
                _SideGated(params, 60, 40))
    if case == "bias":
        return JModelMFBias(params, 60, 40), _Bias(params, 60, 40)
    return JModelMF(params, 60, 40), ModelMF(params, 60, 40)


@pytest.mark.parametrize("case,kw", [
    ("sampled_ranks", {}), ("side_gates", {}), ("bias", {}),
    ("mf", dict(schedule="diag", engine="pallas")),
    ("mf", dict(pad_k=2)), ("mf", dict(schedule="cols"))])
def test_guards_raise_like_jax(case, kw):
    mat, params, iu, ii = _setup()
    jm, tm = _guard_models(case, params, mat, iu, ii)
    with pytest.raises(ValueError) as je:
        jbs.BlockSGDSolver(jm, params, mat, iu, ii, batch_size=8, bu=16,
                           bi=8, **kw)
    with pytest.raises(ValueError) as te:
        tbs.BlockSGDSolver(tm, params, mat, iu, ii, batch_size=8, bu=16,
                           bi=8, device="cpu", **kw)
    assert str(te.value) == str(je.value)


def test_constructor_defaults_are_the_jax_solvers():
    """The same constructor call builds the same engine in both packages:
    every argument the two signatures share has the same default."""
    tp = inspect.signature(tbs.BlockSGDSolver.__init__).parameters
    jp = inspect.signature(jbs.BlockSGDSolver.__init__).parameters
    shared = [n for n in tp if n in jp and n != "self"]
    assert {"batch_size", "bu", "bi", "engine", "schedule", "pad_k",
            "collision_norm", "mm_bf16", "interpret"} <= set(shared)
    for n in shared:
        assert tp[n].default == jp[n].default, n
    mat, params, iu, ii = _setup()
    t = tbs.BlockSGDSolver(ModelMF(params, 60, 40), params, mat, iu, ii,
                           device="cpu")
    assert (t.engine, t.schedule, t.bu, t.bi, t.bs) == ("xla", "row", 1024,
                                                        1024, 256)


# ----------------------------------------------------------------------
# the CUDA kernel's host side: lane tables, staged slices, staged checks
# ----------------------------------------------------------------------

def _diag_lanes_per_round(ub, ib, bo, NU, NI):
    """The per-round lanes of the one-launch-per-round wrapper the epoch
    table replaced: each round's real lanes, in order."""
    rounds = []
    for t in range(ub.shape[0]):
        v = ub[t] < NU
        if len(set(ub[t][v].tolist())) < v.sum() or \
                len(set(ib[t][v].tolist())) < v.sum():
            raise ValueError(f"round {t} has lanes that share a block")
        rounds.append([(int(u), int(i), int(u) * NI + int(i), int(b))
                       for u, i, b in zip(ub[t][v], ib[t][v], bo[t][v])])
    return rounds


@pytest.mark.parametrize("NU,G,n_steps,seed", [(5, 3, 2, 0), (261, 53, 1, 1),
                                               (7, 7, 3, 2), (4, 5, 2, 3)])
def test_epoch_lanes_equal_the_rounds(NU, G, n_steps, seed):
    """The diag schedule's epoch table holds each round's real lanes in
    place (dummy lanes -1), the lanes the per-round launches ran."""
    sched = [x.numpy() for x in tbsk.diag_schedule(
        torch.Generator().manual_seed(seed), NU, G, n_steps)]
    table = tbsk.epoch_lanes(*sched, NU, G, n_steps)
    assert table.shape == (sched[0].shape[0], G, 4)
    assert table.dtype == np.int32
    want = _diag_lanes_per_round(*sched, NU, G)
    for t, lanes in enumerate(want):
        real = table[t][table[t, :, 0] >= 0]
        assert [tuple(x) for x in real.tolist()] == lanes
    assert ((table[:, :, 0] < 0) == (sched[0] >= NU)).all()


def test_row_lanes_walk_the_rows_in_order():
    """The row schedule's table: one round per cell, user rows in row_of
    order, each sweeping its cells in ib_seq order (the lanes the
    per-row launches walked)."""
    rng = np.random.default_rng(4)
    NU, NI, n_steps = 5, 3, 4
    row_of = rng.permutation(NU)
    ib_seq = np.stack([rng.permutation(NI) for _ in range(NU)])
    boff = rng.integers(0, n_steps, (NU, NI))
    table = tbsk.row_lanes(row_of, ib_seq, boff, NU, NI, n_steps)
    want = [(ro, ib, ro * NI + ib, boff[t, j]) for t, ro in enumerate(row_of)
            for j, ib in enumerate(ib_seq[t])]
    assert table.shape == (NU * NI, 1, 4)
    assert [tuple(x) for x in table[:, 0].tolist()] == want


def test_lane_tables_refuse_what_the_kernel_cannot_take():
    ub = np.array([[0, 1], [1, 1]])
    ib = np.array([[0, 1], [0, 1]])
    with pytest.raises(ValueError, match="round 1 has lanes that share"):
        tbsk.epoch_lanes(ub, ib, np.zeros((2, 2)), 2, 2, 1)
    # dummy lanes may repeat; real ones may not
    tbsk.epoch_lanes(np.array([[2, 2]]), ib[:1], np.zeros((1, 2)), 2, 2, 1)
    with pytest.raises(ValueError, match="ranges"):
        tbsk.epoch_lanes(ub[:1], ib[:1], np.full((1, 2), 3), 2, 2, 2)
    with pytest.raises(ValueError, match="permute"):
        tbsk.row_lanes(np.array([0, 0]), np.zeros((2, 1)), np.zeros((2, 1)),
                       2, 1, 1)
    with pytest.raises(ValueError, match="boff"):
        tbsk.row_lanes(np.array([1, 0]), np.zeros((2, 1)), np.ones((2, 1)),
                       2, 1, 1)


def _streams(rng, rows, S, bs, bu, bi, k, valid_first):
    valid = rng.random((rows, S)) < 0.7
    if valid_first:   # as the solver stages a cell: valid slots first
        valid = np.sort(valid, axis=1)[:, ::-1]
    u = np.where(valid, rng.integers(0, bu, (rows, S)), 0).astype(np.int32)
    i = np.where(valid, rng.integers(0, bi, (rows, S)), 0).astype(np.int32)
    r = np.where(valid, rng.normal(3, 1, (rows, S)), 0).astype(np.float32)
    w = (valid * rng.uniform(0.2, 1, (rows, S))).astype(np.float32)
    lam = np.where(valid, rng.integers(1, k + 1, (rows, S)), 1).astype(
        np.int32)
    cnu = tbs.stage_batch_collision_counts(w, u, bs, bu)
    cni = tbs.stage_batch_collision_counts(w, i, bs, bi)
    return tuple(torch.from_numpy(a) for a in (u, i, r, w, cnu, cni, lam))


@pytest.mark.parametrize("range_size", [4, 8])
@pytest.mark.parametrize("valid_first", [True, False])
def test_slice_tables_hold_every_valid_slot_once(valid_first, range_size):
    """Each batch slice's valid slots, sorted per side by row with a stable
    order, cut into segments (runs of one row within a range of 4 or 8
    sorted slots), one entry per touched row, and the per-slice valid
    counts (the solver's cells keep valid slots first, so a slice past a
    cell's count holds none: the kernel skips it)."""
    rng = np.random.default_rng(5)
    rows, S, bs, bu, bi, k = 4, 96, 32, 70, 5, 8
    streams = _streams(rng, rows, S, bs, bu, bi, k, valid_first)
    t = tbsk.slice_tables(streams, bs, bu, bi, True, True, range_size)
    n_sl = rows * S // bs
    for name, dt, shape in (("meta", torch.int32, (n_sl, bs, 4)),
                            ("own", torch.int16, (n_sl, bs)),
                            ("seg", torch.int16, (n_sl, bs)),
                            ("ent", torch.int32, (n_sl, bs))):
        for key in ("_u", "_i"):   # what the kernel reads, as it reads it
            x = t[name + key]
            assert (x.dtype, tuple(x.shape)) == (dt, shape), name + key
            assert x.is_contiguous()
    assert (t["cnt"].dtype, tuple(t["cnt"].shape)) == (torch.int32,
                                                       (n_sl, 8))
    u, i, r, w, cnu, cni, lam = (x.numpy().reshape(-1, bs) for x in streams)
    for sl in range(rows * S // bs):
        v = np.nonzero(w[sl] != 0)[0]
        c = t["cnt"][sl].numpy()
        assert c[2] == len(v)
        for side, (own, oth, cn, key) in enumerate(((u, i, cnu, "u"),
                                                    (i, u, cni, "i"))):
            order = sorted(v, key=lambda j: own[sl, j])
            n = len(order)
            m = t["meta_" + key][sl, :n].numpy()
            rows_s = own[sl, order]
            assert np.array_equal(t["own_" + key][sl, :n].numpy(), rows_s)
            assert np.array_equal(m[:, 0] & 0xffff, oth[sl, order])
            assert np.array_equal(m[:, 0] >> 16, lam[sl, order])
            for col, want in ((1, r), (2, w), (3, cn)):
                assert np.array_equal(m[:, col].view(np.float32),
                                      want[sl, order])
            pos = np.arange(n)
            new = np.r_[True, rows_s[1:] != rows_s[:-1]] if n else \
                np.zeros(0, bool)
            seg = np.cumsum(new | (pos % range_size == 0)) - 1
            assert np.array_equal(t["seg_" + key][sl, :n].numpy(), seg)
            n_rows = int(new.sum())
            assert (c[side], c[3 + side]) == (n_rows, seg[-1] + 1 if n
                                              else 0)
            ent = t["ent_" + key][sl, :n_rows].numpy()
            assert np.array_equal(ent & 0x7fff, rows_s[new])
            assert np.array_equal(ent >> 16, seg[new])
    if valid_first:
        per_cell = (w != 0).reshape(rows, S).sum(1)
        nv = t["cnt"][:, 2].numpy().reshape(rows, S // bs)
        want = np.clip(per_cell[:, None] - bs * np.arange(S // bs), 0, bs)
        assert np.array_equal(nv, want)


def _kernel_step_model(U, I, t, sl, k, lr, u_reg, i_reg, cn, mask, mm):
    """One step as the CUDA kernel computes it, read from the staged
    slices alone: each sorted slot's prediction from its own row and the
    partner row, its term summed into its segment, each row's segments
    summed in order, and every touched row adding that sum once."""
    bf = lambda x: x.to(torch.bfloat16).to(torch.float32) if mm else x
    c = t["cnt"][sl]
    new = []
    for side, key in enumerate(("u", "i")):
        own_t, oth_t = (U, I) if side == 0 else (I, U)
        n = int(c[2])
        m = t["meta_" + key][sl, :n]
        own = t["own_" + key][sl, :n].long()
        seg = t["seg_" + key][sl, :n].long()
        oth = (m[:, 0] & 0xffff).long()
        lam = (m[:, 0] >> 16) if mask else torch.full((n,), k)
        r, w, cv = (m[:, col].view(torch.float32) for col in (1, 2, 3))
        po, pp = bf(own_t[own]), bf(oth_t[oth])
        keep = torch.arange(k) < lam[:, None]
        pred = (po * pp * keep).sum(1)
        coeff = w * (r - pred)
        reg = 2.0 * (u_reg if side == 0 else i_reg)
        g = -2.0 * coeff[:, None] * pp + reg * (w > 0).float()[:, None] * po
        if mask:
            g = g * keep
        if cn:
            g = g / cv[:, None]
        n_seg = int(c[3 + side])
        sums = torch.zeros((n_seg, k)).index_add_(0, seg, bf(-lr * g))
        ent = t["ent_" + key][sl, :int(c[side])]
        firsts = (ent >> 16).long().tolist() + [n_seg]
        delta = torch.zeros_like(own_t)
        for e, row in enumerate((ent & 0x7fff).long().tolist()):
            delta[row] = sums[firsts[e]:firsts[e + 1]].sum(0)
        new.append(own_t + delta)
    return new


@pytest.mark.parametrize("mm_bf16,range_size", [(False, 8), (True, 4)])
@pytest.mark.parametrize("collision_norm,use_mask", [(False, False),
                                                     (True, True)])
def test_kernel_model_on_the_slices_matches_batch_update(
        collision_norm, use_mask, mm_bf16, range_size):
    """What the kernel reads from the staged slices is enough to compute
    the plain version's step: the model above, fed only the tables, equals
    batch_update on the streams at f32 rtol 1e-5 / atol 1e-6 (factors exact
    in bf16, so both precisions hold at that class); the few rows make rows
    span several ranges."""
    rng = np.random.default_rng(6)
    rows, S, bs, bu, bi, k = 3, 64, 32, 12, 5, 16
    streams = _streams(rng, rows, S, bs, bu, bi, k, False)
    t = tbsk.slice_tables(streams, bs, bu, bi, collision_norm, use_mask,
                          range_size)
    assert (t["cnt"][:, 4] > t["cnt"][:, 1]).any()   # split rows
    U = torch.from_numpy(_dyadic(rng, (bu, k)))
    I = torch.from_numpy(_dyadic(rng, (bi, k)))
    lr, u_reg, i_reg = 0.05, 0.01, 0.02
    for sl in range(rows * S // bs):
        got = _kernel_step_model(U, I, t, sl, k, lr, u_reg, i_reg,
                                 collision_norm, use_mask, mm_bf16)
        cut = [x.reshape(-1, bs)[sl][None] for x in streams]
        want = tbsk.batch_update(U[None], I[None], *cut, lr, u_reg, i_reg,
                                 collision_norm, use_mask, mm_bf16)
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_[0], rtol=RTOL, atol=ATOL)


def test_stream_checks_are_made_once_per_staged_tensor():
    """The id-range check syncs once, where the streams are staged
    (``stage_slices``, as the solver stages them on the card): an epoch
    handed the staged slices checks nothing, one without them checks its
    streams again. A stream with an id out of range is refused either way,
    and slices staged from other streams or options are refused."""
    _, t, params = _both(schedule="diag")
    _, st = _states(params)
    u_tab, i_tab = t.stage_factors(st)
    sched = t.draw_schedule()
    kw = t.sweep_kwargs()
    stage = lambda streams: tbsk.stage_slices(
        streams, t.bs, t.bu, t.bi, t.collision_norm, t.use_mask, 8)
    calls = []
    real = torch.aminmax
    try:
        torch.aminmax = lambda x: calls.append(1) or real(x)
        slices = stage(t.streams)
        assert len(calls) == 2           # u_loc and i_loc, once each
        for _ in range(2):
            tbsk.block_sgd_diag_epoch(u_tab.clone(), i_tab.clone(), *sched,
                                      0.05, *t.streams, **kw, slices=slices)
        assert len(calls) == 2
        tbsk.block_sgd_diag_epoch(u_tab.clone(), i_tab.clone(), *sched, 0.05,
                                  *t.streams, **kw)
        assert len(calls) == 4
    finally:
        torch.aminmax = real
    want = tbsk.slice_tables(t.streams, t.bs, t.bu, t.bi, t.collision_norm,
                             t.use_mask, 8)
    assert slices["range"] == 8
    assert all(torch.equal(slices[x], want[x]) for x in tbsk._TABLES)
    bad = t.streams[0].clone()
    bad[0, 0] = t.bu
    streams = (bad,) + t.streams[1:]
    with pytest.raises(ValueError, match="outside"):
        stage(streams)
    with pytest.raises(ValueError, match="outside"):
        tbsk.block_sgd_diag_epoch(u_tab, i_tab, *sched, 0.05, *streams, **kw)
    with pytest.raises(ValueError, match="staged from other"):
        tbsk.block_sgd_diag_epoch(u_tab, i_tab, *sched, 0.05, *streams, **kw,
                                  slices=slices)
    assert t.collision_norm
    with pytest.raises(ValueError, match="staged from other"):
        tbsk.block_sgd_diag_epoch(
            u_tab, i_tab, *sched, 0.05, *t.streams, slices=slices,
            **dict(kw, collision_norm=False))
