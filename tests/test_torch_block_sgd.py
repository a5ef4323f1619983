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
