"""The port's multi-device layer (matfac_tpu_torch.parallel) against the
JAX package's on the CPU: the port's 8-shard CPU mesh beside JAX's 8
virtual host devices. Case for case the tests of tests/test_parallel.py
(less JAX's graft entry-point test), plus: every staged array equal to
JAX's bit for bit, epochs with the JAX key chain's draws injected through
``epoch_with`` (f32 products at JAX's atol 2e-5 / rtol 1e-4, bf16 at the
5e-3 class), train_model's mesh routing, and 2-process gloo runs
(tests/torch_mesh_worker.py) equal to 1-process runs bit for bit."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from matfac_tpu.config import Params as JParams
from matfac_tpu.data.synthetic import synthetic_data as j_synthetic_data
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.models.longtail import (ModelDropoutSigmoid as JTMF,
                                        ModelInvPopMF as JInvPop,
                                        ModelPoissonDropout as JPois)
from matfac_tpu.ops.block_sgd_kernel import device_diag_schedule
from matfac_tpu.parallel.block_dsgd import (
    BlockDSGDSolver as JBlockDSGD, DenseBlockDSGDSolver as JDenseDSGD,
    _interleave_local as j_interleave, _pair_hash as j_pair_hash)
from matfac_tpu.parallel.distributed import (
    host_local_ratings as j_host_local_ratings,
    host_user_range as j_host_user_range)
from matfac_tpu.parallel.dsgd import DSGDShardedSolver as JDSGD
from matfac_tpu.parallel.mesh import make_mesh as j_make_mesh
from matfac_tpu.data.batching import (
    latin_square_schedule as j_latin, user_item_block_partition as j_part)
from matfac_tpu.train.loop import train_model as j_train_model

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.batching import (latin_square_schedule,
                                            user_item_block_partition)
from matfac_tpu_torch.data.synthetic import synthetic_data
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.models.base import (ModelMF, init_state,
                                          state_from_numpy)
from matfac_tpu_torch.models.longtail import (ModelDropoutSigmoid,
                                              ModelInvPopMF,
                                              ModelPoissonDropout)
from matfac_tpu_torch.parallel import distributed
from matfac_tpu_torch.parallel.block_dsgd import (BlockDSGDSolver,
                                                  DenseBlockDSGDSolver,
                                                  _interleave_local,
                                                  _pair_hash)
from matfac_tpu_torch.parallel.dsgd import DSGDShardedSolver
from matfac_tpu_torch.parallel.mesh import (factor_sharding, make_mesh,
                                            pad_to_multiple, shard_state)
from matfac_tpu_torch.train.loop import train_model
from matfac_tpu_torch.utils import freq

NOISE = 0.05
CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_mesh_worker import (COORD_MODES, problem, small_batches,  # noqa: E402,E501
                               train, train_coord)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tmesh(n):
    return make_mesh((n,), ("u",), devices=[CPU] * n)


def jmesh(n):
    return j_make_mesh((n,), ("u",), devices=jax.devices()[:n])


def stacked(xs):
    """A solver's per-local-shard tensors as one host array."""
    return np.stack([x.cpu().float().numpy() if x.dtype == torch.bfloat16
                     else x.cpu().numpy() for x in xs])


def tstate(js):
    return state_from_numpy(*(np.asarray(a) for a in js), device="cpu")


def close(got, want, rtol, atol):
    for g, w in ((got.u_fac, want.u_fac), (got.i_fac, want.i_fac)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


# ----------------------------------------------------------------------
# mesh, distributed helpers, batching
# ----------------------------------------------------------------------

def test_mesh_construction():
    mesh = make_mesh(devices=[CPU] * 8)
    assert mesh.devices.size == 8 and mesh.size == 8
    assert mesh.shape == {"u": 8, "i": 1}
    mesh2 = make_mesh((4, 2), ("u", "i"), devices=[CPU] * 8)
    assert mesh2.shape == {"u": 4, "i": 2}
    assert mesh2.local_blocks("u") == [0, 1, 2, 3]
    assert mesh2.local_shards() == list(range(8))
    with pytest.raises(ValueError):
        make_mesh((3, 2), devices=[CPU] * 8)
    jm = j_make_mesh((4, 2), ("u", "i"))
    assert dict(jm.shape) == mesh2.shape


def test_shard_state_placement():
    params = Params(fac_dim=4)
    mesh = make_mesh((4, 2), ("u", "i"), devices=[CPU] * 8)
    state = init_state(params, 64, 32, device="cpu")
    assert factor_sharding(mesh) == (("u", None), ("i", None))
    assert factor_sharding(tmesh(8)) == (("u", None), (None, None))
    sharded = shard_state(state, mesh)
    for a, b in zip(sharded, state):
        assert a.device == CPU and torch.equal(a, b)
    assert pad_to_multiple(10, 4) == 12


def test_distributed_helpers_match_jax(tmp_path):
    """host_user_range / host_local_ratings, the partition helpers of
    data/batching.py and the staging hashes equal JAX's; the collectives
    are identities in one process."""
    data, *_ = synthetic_data(n_users=64, n_items=48, k=3, density=0.3,
                              seed=11)
    for n_sh in (1, 2, 3, 8):
        for s in range(n_sh):
            assert distributed.host_user_range(64, n_sh, s) == \
                j_host_user_range(64, n_sh, s)
            for a, b in zip(distributed.host_local_ratings(
                    data.train_mat, 64, n_sh, s),
                    j_host_local_ratings(data.train_mat, 64, n_sh, s)):
                np.testing.assert_array_equal(a, b)
    for got, want in zip(user_item_block_partition(50, 30, 4, 3),
                         j_part(50, 30, 4, 3)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        latin_square_schedule(6, np.random.default_rng(2)),
        j_latin(6, np.random.default_rng(2)))
    rng = np.random.default_rng(0)
    r, c = rng.integers(0, 10**6, 500), rng.integers(0, 10**5, 500)
    np.testing.assert_array_equal(_pair_hash(r, c, 5), j_pair_hash(r, c, 5))
    np.testing.assert_array_equal(_interleave_local(np.arange(50), 4, 16),
                                  j_interleave(np.arange(50), 4, 16))
    assert distributed.process_count() == 1
    assert distributed.allgather(np.arange(3)).shape == (1, 3)
    assert distributed.all_reduce_sum([1.5, 2.0]) == [1.5, 2.0]
    distributed.initialize()            # no MASTER_ADDR: a no-op
    assert not torch.distributed.is_initialized()


# ----------------------------------------------------------------------
# the shared problem of tests/test_parallel.py
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    data, _, _ = synthetic_data(n_users=160, n_items=96, k=4, density=0.3,
                                seed=9, noise=NOISE)
    jdata, _, _ = j_synthetic_data(n_users=160, n_items=96, k=4,
                                   density=0.3, seed=9, noise=NOISE)
    for a, b in zip(data.train_mat.to_coo(), jdata.train_mat.to_coo()):
        np.testing.assert_array_equal(a, b)
    kw = dict(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.02,
              seed=5, batch_size=256)
    params, jparams = Params(**kw), JParams(**kw)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    ev = Evaluator(data, iu, ii, params, "cpu")
    model = ModelMF(params, data.n_users, data.n_items)
    jmodel = JModelMF(jparams, data.n_users, data.n_items)
    return dict(data=data, jdata=jdata, params=params, jparams=jparams,
                ev=ev, model=model, jmodel=jmodel, iu=iu, ii=ii)


def _freqs(data):
    uf, itf = freq.row_col_freq(data.train_mat)
    return (np.pad(uf, (0, data.n_users - len(uf))),
            np.pad(itf, (0, data.n_items - len(itf))))


def _run(solver, params, n_users, n_items, lr, epochs):
    state = init_state(params, n_users, n_items, device="cpu")
    for _ in range(epochs):
        state = solver.epoch(state, lr)
    return state


def test_balanced_split():
    split = distributed.balanced_split
    assert split([1, 1, 1, 1, 4], 2) == [range(0, 4), range(4, 5)]
    assert split([], 3) == [range(0, 0)] * 3
    assert split([0, 0], 2) == [range(0, 2), range(2, 2)]
    rng = np.random.default_rng(0)
    for parts in (1, 2, 3, 8):
        work = rng.integers(1, 100, 37)
        runs = split(work, parts)
        assert len(runs) == parts
        assert [j for r in runs for j in r] == list(range(37))
        loads = [int(work[r.start:r.stop].sum()) for r in runs]
        # each part within one batch of its even share
        assert max(loads) <= work.sum() / parts + work.max()


@pytest.mark.parametrize("method", ["als", "als_cg", "ialspp", "alsdense"])
def test_split_solvers_in_one_process_equal_unsplit(setup, monkeypatch,
                                                    method):
    """In one process the split solvers (all batches this process's, the
    all-gather a no-op) train the bits of the unsplit ones, through the
    same batches (JAX's bucket chunks, cut small here; 16-row blocks of
    the dense matrix)."""
    from matfac_tpu_torch.solvers import als
    monkeypatch.setattr(als, "CHUNK_ELEMS", 64)
    S = setup
    d, p = S["data"], S["params"]
    cls, kw = {"als": (als.ALSSolver, {}),
               "als_cg": (als.ALSSolver, dict(cg_iters=3)),
               "ialspp": (als.SubspaceALSSolver, {}),
               "alsdense": (als.DenseALSSolver, dict(row_block=16))}[method]
    make = lambda split: cls(S["model"], p, d.train_mat, S["iu"], S["ii"],
                             device="cpu", split=split, **kw)
    a, b = make(False), make(True)
    if method != "alsdense":
        assert len(b._stage[0]) == len(a._stage[0]) > 1
        assert torch.equal(torch.cat(b._solved[0]),
                           torch.cat([c[5] for c in a._stage[0]]))
    sa = sb = init_state(p, d.n_users, d.n_items, device="cpu")
    for _ in range(2):
        sa, sb = a.epoch(sa, 0.0), b.epoch(sb, 0.0)
    assert torch.equal(sa.u_fac, sb.u_fac) and torch.equal(sa.i_fac,
                                                           sb.i_fac)


# ----------------------------------------------------------------------
# DSGDShardedSolver
# ----------------------------------------------------------------------

def _dsgd_pair(S, model, jmodel, params=None, jparams=None, n=8, **kw):
    params, jparams = params or S["params"], jparams or S["jparams"]
    d = S["data"]
    ts = DSGDShardedSolver(model, params, d.train_mat, S["iu"], S["ii"],
                           tmesh(n), **kw)
    js = JDSGD(jmodel, jparams, d.train_mat, S["iu"], S["ii"], jmesh(n),
               **kw)
    return ts, js


def _assert_dsgd_staging(ts, js):
    assert (ts.S, ts.bs, ts.bu, ts.bi, ts.nnz) == (js.S, js.bs, js.bu,
                                                   js.bi, js.nnz)
    for name in ("u_loc", "i_loc", "vals", "wts", "lams"):
        np.testing.assert_array_equal(stacked(getattr(ts, name)),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)


def test_dsgd_partition_covers_all_ratings(setup):
    S = setup
    ts, js = _dsgd_pair(S, S["model"], S["jmodel"])
    _assert_dsgd_staging(ts, js)
    wts = stacked(ts.wts)
    assert int((wts > 0).sum()) == ts.nnz
    u_loc, i_loc = stacked(ts.u_loc), stacked(ts.i_loc)
    N = ts.n_shards
    for shard in range(N):
        for rnd in range(N):
            mask = wts[shard, rnd] > 0
            gu = u_loc[shard, rnd][mask] + shard * ts.bu
            blk = (shard + rnd) % N
            gi = i_loc[shard, rnd][mask] + blk * ts.bi
            assert (gu < S["data"].n_users).all()
            assert (gi < S["data"].n_items).all()
            assert (gu // ts.bu == shard).all()
            assert (gi // ts.bi == blk).all()


def _jax_dsgd_draws(js, key):
    """The JAX DSGD epoch's draws from ``key``: one batch offset a round
    (replicated over shards) and, for TMF+Dropout, a Poisson draw a batch
    from the same chain on each shard's lambdas, in slot order."""
    N, bs = js.n_shards, js.bs
    n_steps = js.S // bs
    lams = np.asarray(js.lams)
    ranks = np.zeros((N, N, js.S), np.int64) if js.sample_poisson else None
    boff = []
    for t in range(N):
        key, pk = jax.random.split(key)
        bo = int(jax.random.randint(pk, (), 0, n_steps))
        boff.append(bo)
        for s in range(n_steps):
            if js.sample_poisson:
                key, sk = jax.random.split(key)
                a = ((s + bo) % n_steps) * bs
                for b in range(N):
                    lam = jax.numpy.asarray(lams[b, t, a:a + bs], np.float32)
                    ranks[t, b, a:a + bs] = np.clip(np.asarray(
                        jax.random.poisson(sk, lam)).astype(np.int32), 1,
                        js.model.k)
    return 0, torch.tensor(boff), ranks


@pytest.mark.parametrize("algo", ["mf", "ifwmf", "tmf", "tmfdropout"])
@pytest.mark.parametrize("balance", [False, True])
def test_dsgd_epochs_match_jax(setup, algo, balance):
    """Two epochs from one initial state, the port fed the JAX key chain's
    batch offsets and Poisson ranks: staged streams bit for bit, factors at
    JAX's atol 2e-5 / rtol 1e-4."""
    S = setup
    d = S["data"]
    n, m = d.n_users, d.n_items
    uf, itf = _freqs(d)
    kw = dict(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.02,
              seed=5, batch_size=64, rho_rms=1.0, alpha=0.0)
    p, jp = Params(**kw), JParams(**kw)
    model, jmodel = {
        "mf": lambda: (ModelMF(p, n, m), JModelMF(jp, n, m)),
        "ifwmf": lambda: (ModelInvPopMF(p, n, m, uf, itf, S["iu"], S["ii"]),
                          JInvPop(jp, n, m, uf, itf, S["iu"], S["ii"])),
        "tmf": lambda: (ModelDropoutSigmoid(p, n, m, uf, itf),
                        JTMF(jp, n, m, uf, itf)),
        "tmfdropout": lambda: (ModelPoissonDropout(p, n, m, uf, itf),
                               JPois(jp, n, m, uf, itf))}[algo]()
    ts, js = _dsgd_pair(S, model, jmodel, p, jp, batch_size=64,
                        balance_items=balance)
    _assert_dsgd_staging(ts, js)
    assert ts.sample_poisson == js.sample_poisson == (algo == "tmfdropout")
    st_j = j_init_state(jp, n, m)
    st_t = tstate(st_j)
    key = jax.random.PRNGKey(0)
    for _ in range(2):
        key, ek = jax.random.split(key)
        st_t = ts.epoch_with(st_t, 0.02, _jax_dsgd_draws(js, ek))
        st_j = js.epoch(st_j, 0.02, ek)
    close(st_t, st_j, 1e-4, 2e-5)


def test_dsgd_converges_on_mesh(setup):
    S = setup
    d = S["data"]
    ts = DSGDShardedSolver(S["model"], S["params"], d.train_mat, S["iu"],
                           S["ii"], tmesh(8), batch_size=256)
    state = _run(ts, S["params"], d.n_users, d.n_items, 0.02, 60)
    val = S["ev"].rmse(S["model"].eval_view(state), "val")
    assert val < 3 * NOISE + 0.05, f"val RMSE {val}"


def test_dsgd_single_shard_matches_convergence(setup):
    """1-shard DSGD is plain minibatch SGD: the same convergence regime."""
    S = setup
    d = S["data"]
    ts = DSGDShardedSolver(S["model"], S["params"], d.train_mat, S["iu"],
                           S["ii"], tmesh(1), batch_size=256)
    state = _run(ts, S["params"], d.n_users, d.n_items, 0.02, 60)
    val = S["ev"].rmse(S["model"].eval_view(state), "val")
    assert val < 3 * NOISE + 0.1


def test_dsgd_with_ifwmf_weights(setup):
    S = setup
    d = S["data"]
    uf, itf = _freqs(d)
    m = ModelInvPopMF(S["params"], d.n_users, d.n_items, uf, itf,
                      invalid_users=S["iu"], invalid_items=S["ii"])
    jm = JInvPop(S["jparams"], d.n_users, d.n_items, uf, itf,
                 invalid_users=S["iu"], invalid_items=S["ii"])
    ts, js = _dsgd_pair(S, m, jm, batch_size=256)
    _assert_dsgd_staging(ts, js)
    wts = stacked(ts.wts)
    real = wts[wts > 0]
    assert (real <= 1.0 + 1e-6).all() and real.min() < 1.0
    state = _run(ts, S["params"], d.n_users, d.n_items, 0.02, 30)
    assert S["ev"].rmse(m.eval_view(state), "val") < 0.5


def test_dsgd_with_tmf_rank_tables(setup):
    """DSGD staging honours TMF's static pair ranks and TMF+Poisson's
    sampling flag, as in JAX."""
    S = setup
    d = S["data"]
    uf, itf = _freqs(d)
    kw = dict(fac_dim=4, u_reg=0.001, i_reg=0.001, rho_rms=1.0, alpha=0.0,
              seed=5, batch_size=256)
    p, jp = Params(**kw), JParams(**kw)
    for cls, jcls, sampled in ((ModelDropoutSigmoid, JTMF, False),
                               (ModelPoissonDropout, JPois, True)):
        m = cls(p, d.n_users, d.n_items, uf, itf)
        ts, js = _dsgd_pair(S, m, jcls(jp, d.n_users, d.n_items, uf, itf),
                            p, jp, batch_size=256)
        _assert_dsgd_staging(ts, js)
        assert ts.sample_poisson == sampled
        lams = stacked(ts.lams)
        real = stacked(ts.wts) > 0
        assert lams[real].min() >= 1 and lams[real].max() <= p.fac_dim
        state = _run(ts, p, d.n_users, d.n_items, 0.02, 10)
        assert np.isfinite(S["ev"].rmse(m.eval_view(state), "val"))


def test_dsgd_item_balancing():
    """balance_items spreads a power-law item distribution over the blocks
    (the same permutation and staging as JAX) and still converges."""
    data, _, _ = synthetic_data(n_users=160, n_items=96, k=4, density=0.3,
                                seed=13, noise=0.05, power_law=1.2)
    kw = dict(fac_dim=4, u_reg=0.001, i_reg=0.001, seed=5, batch_size=256)
    p, jp = Params(**kw), JParams(**kw)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMF(p, data.n_users, data.n_items)
    plain = DSGDShardedSolver(model, p, data.train_mat, iu, ii, tmesh(8),
                              batch_size=256)
    bal = DSGDShardedSolver(model, p, data.train_mat, iu, ii, tmesh(8),
                            batch_size=256, balance_items=True)
    jbal = JDSGD(JModelMF(jp, data.n_users, data.n_items), jp,
                 data.train_mat, iu, ii, jmesh(8), batch_size=256,
                 balance_items=True)
    np.testing.assert_array_equal(bal.item_perm, jbal.item_perm)
    _assert_dsgd_staging(bal, jbal)
    assert bal.S <= plain.S
    assert sorted(bal.item_perm) == list(range(data.n_items))
    ev = Evaluator(data, iu, ii, p, "cpu")
    vals = {}
    for name, solver in (("plain", plain), ("balanced", bal)):
        state = _run(solver, p, data.n_users, data.n_items, 0.02, 40)
        vals[name] = ev.rmse(model.eval_view(state), "val")
    assert vals["balanced"] <= vals["plain"] + 0.05, vals
    assert vals["balanced"] < 0.8, vals


def test_dsgd_balance_items_hooks_use_original_ids(setup):
    """balance_items relabels item ids; the IFWMF weights come from the
    original ids (review r3 of the JAX package)."""
    S = setup
    d = S["data"]
    uf, itf = _freqs(d)
    m = ModelInvPopMF(S["params"], d.n_users, d.n_items, uf, itf,
                      invalid_users=S["iu"], invalid_items=S["ii"])
    s = DSGDShardedSolver(m, S["params"], d.train_mat, S["iu"], S["ii"],
                          tmesh(8), balance_items=True, batch_size=256)
    wts = stacked(s.wts)
    r, c, _ = d.train_mat.to_coo()
    expect = m.example_weight(torch.from_numpy(r.astype(np.int64)),
                              torch.from_numpy(c.astype(np.int64))).numpy()
    keep = ~S["iu"][r] & ~S["ii"][c]
    assert sorted(np.round(wts[wts > 0], 6).tolist()) == \
        sorted(np.round(expect[keep], 6).tolist())


# ----------------------------------------------------------------------
# BlockDSGDSolver
# ----------------------------------------------------------------------

def _block_pair(S, model, jmodel, n=8, mm_bf16=True, **kw):
    d = S["data"]
    kw = dict(sub_bu=8, sub_bi=4, batch_size=16, **kw)
    ts = BlockDSGDSolver(model, S["params"], d.train_mat, S["iu"], S["ii"],
                         tmesh(n), mm_bf16=mm_bf16, **kw)
    js = JBlockDSGD(jmodel, S["jparams"], d.train_mat, S["iu"], S["ii"],
                    jmesh(n), mm_bf16=mm_bf16, **kw)
    return ts, js


def _assert_block_staging(ts, js):
    assert (ts.S, ts.bs, ts.SU, ts.SI, ts.nnz, ts.pad_frac) == (
        js.S, js.bs, js.SU, js.SI, js.nnz, js.pad_frac)
    np.testing.assert_array_equal(ts.u_perm, js.u_perm)
    np.testing.assert_array_equal(ts.i_perm, js.i_perm)
    names = ["u_loc", "i_loc", "vals", "wts", "lams"]
    if ts.collision_norm:
        names += ["cnu", "cni"]
    for name in names:
        np.testing.assert_array_equal(stacked(getattr(ts, name)),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)


def test_block_dsgd_partition_covers_all_ratings(setup):
    S = setup
    ts, js = _block_pair(S, S["model"], S["jmodel"])
    _assert_block_staging(ts, js)
    wts = stacked(ts.wts)          # [N, N, SU*SI+1, S] cell-major
    assert int((wts > 0).sum()) == ts.nnz
    assert (wts[:, :, -1, :] == 0).all()
    u_loc, i_loc, vals = (stacked(ts.u_loc), stacked(ts.i_loc),
                          stacked(ts.vals))
    u_inv = ts.u_perm_inv_dev.numpy()
    i_inv = ts.i_perm_inv_dev.numpy()
    r, c, v = S["data"].train_mat.to_coo()
    truth = {(int(a), int(b)): float(x) for a, b, x in zip(r, c, v)}
    N, SU, SI = ts.n_shards, ts.SU, ts.SI
    for sh in range(N):
        for t in range(N):
            blk = (sh + t) % N
            for cell in range(SU * SI):
                su, si = divmod(cell, SI)
                mask = wts[sh, t, cell] > 0
                gu = sh * ts.bu + su * ts.sub_bu + u_loc[sh, t, cell]
                gi = blk * ts.bi + si * ts.sub_bi + i_loc[sh, t, cell]
                for j in np.nonzero(mask)[0]:
                    assert truth[(int(u_inv[gu[j]]), int(i_inv[gi[j]]))] \
                        == vals[sh, t, cell, j]


def _jax_block_draws(js, key):
    """The JAX block-DSGD epoch's diag schedules: a split of the epoch key
    a round, folded with each shard id."""
    out = {}
    n_steps = js.S // js.bs
    for t in range(js.n_shards):
        key, ks = jax.random.split(key)
        for b in range(js.n_shards):
            out[(t, b)] = tuple(
                torch.from_numpy(np.asarray(x).astype(np.int64))
                for x in device_diag_schedule(jax.random.fold_in(ks, b),
                                              js.SU, js.SI, n_steps))
    return out


@pytest.mark.parametrize("algo", ["mf", "tmf"])
@pytest.mark.parametrize("mm_bf16,rtol,atol",
                         [(False, 1e-4, 2e-5), (True, 5e-3, 5e-4)])
def test_block_dsgd_epochs_match_jax(setup, algo, mm_bf16, rtol, atol):
    """Two epochs of the one-hot engine under the rotation, the port fed
    JAX's diag schedules: f32 products at JAX's atol 2e-5 / rtol 1e-4,
    bf16 operands at the 5e-3 class (JAX pads k to no lanes here)."""
    S = setup
    d = S["data"]
    n, m = d.n_users, d.n_items
    model, jmodel = S["model"], S["jmodel"]
    if algo == "tmf":
        uf, itf = _freqs(d)
        p = S["params"].replace(rho_rms=1.0, alpha=0.0)
        jp = S["jparams"].replace(rho_rms=1.0, alpha=0.0)
        model, jmodel = (ModelDropoutSigmoid(p, n, m, uf, itf),
                         JTMF(jp, n, m, uf, itf))
    ts, js = _block_pair(S, model, jmodel, mm_bf16=mm_bf16)
    _assert_block_staging(ts, js)
    assert ts.use_mask == (algo == "tmf")
    st_j = j_init_state(S["jparams"], n, m)
    st_t = tstate(st_j)
    key = jax.random.PRNGKey(1)
    for _ in range(2):
        key, ek = jax.random.split(key)
        st_t = ts.epoch_with(st_t, 0.02, _jax_block_draws(js, ek))
        st_j = js.epoch(st_j, 0.02, ek)
    close(st_t, st_j, rtol, atol)


def test_block_dsgd_converges_on_mesh(setup):
    S = setup
    d = S["data"]
    s = BlockDSGDSolver(S["model"], S["params"], d.train_mat, S["iu"],
                        S["ii"], tmesh(8), sub_bu=8, sub_bi=4, batch_size=16)
    state = _run(s, S["params"], d.n_users, d.n_items, 0.02, 60)
    val = S["ev"].rmse(S["model"].eval_view(state), "val")
    assert val < 3 * NOISE + 0.05, f"val RMSE {val}"


def test_block_dsgd_single_shard_converges(setup):
    S = setup
    d = S["data"]
    s = BlockDSGDSolver(S["model"], S["params"], d.train_mat, S["iu"],
                        S["ii"], tmesh(1), sub_bu=16, sub_bi=8,
                        batch_size=32)
    state = _run(s, S["params"], d.n_users, d.n_items, 0.02, 60)
    val = S["ev"].rmse(S["model"].eval_view(state), "val")
    assert val < 3 * NOISE + 0.1, f"val RMSE {val}"


def test_block_dsgd_tmf_rank_mask(setup):
    """TMF rank masks ride the staged stream in block-DSGD too."""
    S = setup
    d = S["data"]
    uf, itf = _freqs(d)
    m = ModelDropoutSigmoid(S["params"].replace(rho_rms=1.0, alpha=0.0),
                            d.n_users, d.n_items, uf, itf)
    s = BlockDSGDSolver(m, S["params"], d.train_mat, S["iu"], S["ii"],
                        tmesh(4), sub_bu=8, sub_bi=4, batch_size=16)
    assert s.use_mask
    state = init_state(S["params"], d.n_users, d.n_items, device="cpu")
    before = S["ev"].rmse(m.eval_view(state), "val")
    for _ in range(30):
        state = s.epoch(state, 0.02)
    assert S["ev"].rmse(m.eval_view(state), "val") < before


def test_block_dsgd_streams_balanced_under_power_law():
    """Frequency-interleaved staging keeps per-shard streams balanced
    (max/median <= 2) under power-law data at N=8, with JAX's streams."""
    data, _, _ = synthetic_data(n_users=320, n_items=160, k=4,
                                density=0.25, seed=17, noise=0.05,
                                power_law=1.3, nonneg=True)
    kw = dict(fac_dim=4, u_reg=0.01, i_reg=0.01, seed=5, batch_size=64)
    p, jp = Params(**kw), JParams(**kw)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    s = BlockDSGDSolver(ModelMF(p, data.n_users, data.n_items), p,
                        data.train_mat, iu, ii, tmesh(8), sub_bu=8,
                        sub_bi=4, batch_size=16)
    js = JBlockDSGD(JModelMF(jp, data.n_users, data.n_items), jp,
                    data.train_mat, iu, ii, jmesh(8), sub_bu=8, sub_bi=4,
                    batch_size=16)
    _assert_block_staging(s, js)
    per_shard = (stacked(s.wts) > 0).reshape(8, -1).sum(axis=1)
    assert per_shard.max() / max(np.median(per_shard), 1) <= 2.0, per_shard
    assert s.pad_frac < 6.0, s.pad_frac


def test_block_dsgd_guards(setup):
    S = setup
    d = S["data"]
    uf, itf = _freqs(d)
    pois = ModelPoissonDropout(S["params"], d.n_users, d.n_items, uf, itf)
    with pytest.raises(ValueError, match="Poisson"):
        BlockDSGDSolver(pois, S["params"], d.train_mat, S["iu"], S["ii"],
                        tmesh(2))
    with pytest.raises(ValueError, match="no axis"):
        BlockDSGDSolver(S["model"], S["params"], d.train_mat, S["iu"],
                        S["ii"], tmesh(2), axis="i")


# ----------------------------------------------------------------------
# DenseBlockDSGDSolver
# ----------------------------------------------------------------------

def _dense_pair(S, mat=None, n=4, **kw):
    d = S["data"]
    mat = d.train_mat if mat is None else mat
    ts = DenseBlockDSGDSolver(S["model"], S["params"], mat, S["iu"],
                              S["ii"], tmesh(n), **kw)
    js = JDenseDSGD(S["jmodel"], S["jparams"], mat, S["iu"], S["ii"],
                    jmesh(n), **kw)
    return ts, js


def _assert_dense_staging(ts, js):
    assert (ts.SU, ts.sub_bu, ts.bi, ts.nnz, ts.r_scale) == (
        js.SU, js.sub_bu, js.bi, js.nnz, js.r_scale)
    np.testing.assert_array_equal(ts.u_perm, js.u_perm)
    np.testing.assert_array_equal(ts.i_perm, js.i_perm)
    np.testing.assert_array_equal(stacked(ts.R_tiles),
                                  np.asarray(js.R_tiles, np.float32))
    assert (ts.W_tiles is None) == (js.W_tiles is None)
    if ts.W_tiles is not None:
        assert ts.W_tiles[0].dtype == torch.int8
        np.testing.assert_array_equal(stacked(ts.W_tiles),
                                      np.asarray(js.W_tiles))


def test_dense_block_dsgd_tiles_cover_all_ratings(setup):
    """Every kept rating lands in one (shard, round, stripe) tile slot;
    the tiles equal JAX's bit for bit (bf16 R, int8 W)."""
    S = setup
    ts, js = _dense_pair(S, sub_bu=16)
    _assert_dense_staging(ts, js)
    W, R = stacked(ts.W_tiles), stacked(ts.R_tiles)
    assert int((W > 0).sum()) == ts.nnz
    r, c, v = S["data"].train_mat.to_coo()
    keep = ~S["iu"][r] & ~S["ii"][c]
    r, c, v = r[keep], c[keep], v[keep]
    r2, c2 = ts.u_perm[r], ts.i_perm[c]
    sh = r2 // ts.bu
    t = (c2 // ts.bi - sh) % ts.n_shards
    su = (r2 % ts.bu) // ts.sub_bu
    got = R[sh, t, su, r2 % ts.sub_bu, c2 % ts.bi]
    np.testing.assert_allclose(got, v, rtol=1e-2)   # bf16 tiles


def _jax_dense_draws(SU, N, key):
    """The JAX dense block-DSGD epoch's stripe orders: a split of the
    epoch key a round, folded with each shard id."""
    out = {}
    for t in range(N):
        key, ks = jax.random.split(key)
        for b in range(N):
            out[(t, b)] = torch.from_numpy(np.asarray(jax.random.permutation(
                jax.random.fold_in(ks, b), SU)).astype(np.int64))
    return out


@pytest.mark.parametrize("n,mm_bf16,rtol,atol", [
    (1, False, 1e-4, 2e-5), (4, False, 1e-4, 2e-5), (8, False, 1e-4, 2e-5),
    (4, True, 5e-3, 5e-4)])
def test_dense_block_dsgd_matches_manual_round(setup, n, mm_bf16, rtol,
                                               atol):
    """Epochs on 1, 4 and 8 shards against the JAX solver from one state,
    the port fed JAX's stripe orders (N=1: JAX's test of one epoch against
    its host replica of the stripe sweep): f32 at JAX's atol 2e-5 /
    rtol 1e-4, bf16 operands at the 5e-3 class."""
    S = setup
    sub = 32 if n == 1 else 8
    ts, js = _dense_pair(S, n=n, sub_bu=sub, mm_bf16=mm_bf16)
    _assert_dense_staging(ts, js)
    d = S["data"]
    st_j = j_init_state(S["jparams"], d.n_users, d.n_items)
    st_t = tstate(st_j)
    key = jax.random.PRNGKey(4)
    for _ in range(1 if n == 1 else 2):
        key, ek = jax.random.split(key)
        st_t = ts.epoch_with(st_t, 0.02,
                             _jax_dense_draws(ts.SU, ts.n_shards, ek))
        st_j = js.epoch(st_j, 0.02, ek)
    close(st_t, st_j, rtol, atol)


# ----------------------------------------------------------------------
# the phase-attribution epochs (scripts/scaling_curve.py --phase-split)
# ----------------------------------------------------------------------

def _jax_mode_epochs(js, mode, st_j, key, epochs=2):
    """``epochs`` epochs of the JAX solver built in ``mode``; returns the
    state and the epoch keys."""
    js._epoch = js._build_epoch(mode)
    keys = []
    for _ in range(epochs):
        key, ek = jax.random.split(key)
        keys.append(ek)
        st_j = js.epoch(st_j, 0.02, ek)
    return st_j, keys


@pytest.mark.parametrize("mode", ["nopermute", "permuteonly"])
@pytest.mark.parametrize("solver", ["dsgd", "dsgd_tmfdropout", "block",
                                    "dense"])
def test_phase_modes_match_jax(setup, solver, mode):
    """Each mesh solver's "nopermute" (the rounds without the item-block
    rotation) and "permuteonly" (the rotation alone) epochs against JAX's
    ``_build_epoch(mode)`` on the 8-shard mesh, the port fed the same
    draws: f32 products at JAX's atol 2e-5 / rtol 1e-4, as for "full".
    permuteonly leaves the tables as they were; nopermute trains them."""
    S = setup
    d = S["data"]
    n, m = d.n_users, d.n_items
    if solver.startswith("dsgd"):
        uf, itf = _freqs(d)
        kw = dict(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.02,
                  seed=5, batch_size=64, rho_rms=1.0, alpha=0.0)
        p, jp = Params(**kw), JParams(**kw)
        models = ((ModelPoissonDropout(p, n, m, uf, itf),
                   JPois(jp, n, m, uf, itf)) if solver == "dsgd_tmfdropout"
                  else (ModelMF(p, n, m), JModelMF(jp, n, m)))
        ts, js = _dsgd_pair(S, *models, p, jp, batch_size=64)
        draws = lambda ek: _jax_dsgd_draws(js, ek)
    elif solver == "block":
        p = S["jparams"]
        ts, js = _block_pair(S, S["model"], S["jmodel"], mm_bf16=False)
        draws = lambda ek: _jax_block_draws(js, ek)
    else:
        p = S["jparams"]
        ts, js = _dense_pair(S, n=8, sub_bu=8, mm_bf16=False)
        draws = lambda ek: _jax_dense_draws(ts.SU, ts.n_shards, ek)
    st_j0 = j_init_state(p, n, m)
    st_j, keys = _jax_mode_epochs(js, mode, st_j0, jax.random.PRNGKey(2))
    st_t = tstate(st_j0)
    for ek in keys:
        st_t = ts.epoch_with(st_t, 0.02, draws(ek), mode=mode)
    close(st_t, st_j, 1e-4, 2e-5)
    moved = not np.array_equal(st_t.u_fac.numpy(), np.asarray(st_j0.u_fac))
    assert moved == (mode == "nopermute")


def test_phase_modes_are_checked(setup):
    S = setup
    ts = DSGDShardedSolver(S["model"], S["params"], S["data"].train_mat,
                           S["iu"], S["ii"], tmesh(2))
    st = init_state(S["params"], S["data"].n_users, S["data"].n_items,
                    device="cpu")
    with pytest.raises(ValueError, match="mode"):
        ts.epoch(st, 0.02, mode="commonly")


def test_dense_block_dsgd_converges_on_mesh(setup):
    S = setup
    d = S["data"]
    s = DenseBlockDSGDSolver(S["model"], S["params"], d.train_mat, S["iu"],
                             S["ii"], tmesh(4), sub_bu=16)
    state = _run(s, S["params"], d.n_users, d.n_items, 0.05, 60)
    val = S["ev"].rmse(S["model"].eval_view(state), "val")
    assert val < 3 * NOISE + 0.05, f"val RMSE {val}"


def test_dense_block_dsgd_guards(setup):
    S = setup
    d = S["data"]
    uf = d.train_mat.row_degrees().astype(np.float32)
    itf = d.train_mat.col_degrees().astype(np.float32)
    p2 = Params(fac_dim=4, rho_rms=1.0, alpha=0.0, seed=1)
    tmf = ModelDropoutSigmoid(p2, d.n_users, d.n_items, uf, itf)
    with pytest.raises(ValueError):
        DenseBlockDSGDSolver(tmf, p2, d.train_mat, S["iu"], S["ii"],
                             tmesh(2))
    with pytest.raises(ValueError):
        DenseBlockDSGDSolver(S["model"], S["params"], d.train_mat, S["iu"],
                             S["ii"], tmesh(2), dense_budget_bytes=1024)
    with pytest.raises(ValueError, match="star-grid"):
        DenseBlockDSGDSolver(S["model"], S["params"], d.train_mat, S["iu"],
                             S["ii"], tmesh(2), dense_codes="codes")


def _star(mat):
    mat = mat.copy()
    mat.values[:] = (np.clip(np.round(mat.values / 0.5), 1, 10)
                     * 0.5).astype(np.float32)
    return mat


def test_dense_block_dsgd_codes_bit_exact(setup):
    """Star-grid data: int8 rating-code tiles (W None) train bit for bit
    as the float tiles, and stage as JAX's."""
    S = setup
    mat = _star(S["data"].train_mat)
    code, jcode = _dense_pair(S, mat, sub_bu=16, mm_bf16=False,
                              dense_codes="codes")
    assert code.W_tiles is None and code.r_scale == 0.5
    _assert_dense_staging(code, jcode)
    flt = DenseBlockDSGDSolver(S["model"], S["params"], mat, S["iu"],
                               S["ii"], tmesh(4), sub_bu=16, mm_bf16=False,
                               dense_codes="off")
    assert flt.W_tiles is not None
    d = S["data"]
    sc = init_state(S["params"], d.n_users, d.n_items, device="cpu")
    sf = init_state(S["params"], d.n_users, d.n_items, device="cpu")
    for _ in range(3):
        sched = code.draw_schedule()
        sc = code.epoch_with(sc, 0.03, sched)
        sf = flt.epoch_with(sf, 0.03, sched)
    assert torch.equal(sc.u_fac, sf.u_fac)
    assert torch.equal(sc.i_fac, sf.i_fac)


# ----------------------------------------------------------------------
# train_model under a mesh
# ----------------------------------------------------------------------

def test_train_model_with_mesh(setup):
    """train_model with a mesh routes the sgd spellings through the
    sharded DSGD solver and the full termination loop."""
    S = setup
    p = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.02,
               max_iter=25, seed=5, batch_size=256, disp_iter=1000)
    rep, model, ev, _ = train_model(S["data"], p, algo="mf",
                                    mf_method="sgdpar",
                                    log_fn=lambda s: None, mesh=tmesh(8))
    assert isinstance(rep.solver, DSGDShardedSolver)
    assert ev.mesh is not None
    assert rep.best_metric < 1.0, rep.best_metric


def test_train_model_mesh_auto_and_bias_guard(setup):
    """auto under a mesh resolves to ALS for plain MF, which trains on the
    process's device bit for bit as without a mesh; the DSGD-family
    refusals are JAX's."""
    S = setup
    mesh = tmesh(8)
    p = Params(fac_dim=4, u_reg=0.01, i_reg=0.01, max_iter=6, seed=5,
               disp_iter=10 ** 6)
    logs = []
    rep, *_ = train_model(S["data"], p, algo="mf", mf_method="auto",
                          log_fn=logs.append, mesh=mesh)
    assert any("resolved to 'als'" in s for s in logs), logs
    assert np.isfinite(rep.best_metric)
    rep0, *_ = train_model(S["data"], p, algo="mf", mf_method="auto",
                           log_fn=lambda s: None, device="cpu")
    for a, b in zip(rep.best_state, rep0.best_state):
        assert torch.equal(a, b)
    assert rep.best_metric == rep0.best_metric
    with pytest.raises(ValueError, match="bias models"):
        train_model(S["data"], p, algo="mf_bias", mf_method="auto",
                    log_fn=lambda s: None, mesh=mesh)
    with pytest.raises(ValueError, match="sampled"):
        train_model(S["data"], p, algo="dropoutmf", mf_method="sgd",
                    log_fn=lambda s: None, mesh=mesh)
    with pytest.raises(ValueError, match="gates"):
        train_model(S["data"], p, algo="mf_loc", mf_method="sgd",
                    log_fn=lambda s: None, mesh=mesh)
    with pytest.raises(ValueError, match="single device"):
        train_model(S["data"], p, algo="mf_freq", mf_method="sgd",
                    log_fn=lambda s: None, mesh=mesh)


@pytest.mark.parametrize("algo,method,solver", [
    ("tmf", "auto", "BlockDSGDSolver"), ("tmf", "blocksgd",
                                         "BlockDSGDSolver"),
    ("tmfdropout", "blocksgd", "DSGDShardedSolver"),
    ("ifwmf", "sgd", "DSGDShardedSolver"),
    ("mf", "densesgd", "DenseBlockDSGDSolver")])
def test_train_model_mesh_routes_as_jax(setup, algo, method, solver):
    """Each mesh method builds the solver JAX's front door builds."""
    S = setup
    p = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.02,
               max_iter=1, seed=5, disp_iter=10 ** 6, rho_rms=1.0,
               alpha=0.0)
    jp = JParams(**{f: getattr(p, f) for f in ("fac_dim", "u_reg", "i_reg",
                                                "learn_rate", "max_iter",
                                                "seed", "disp_iter",
                                                "rho_rms", "alpha")})
    logs, jlogs = [], []
    rep, *_ = train_model(S["data"], p, algo=algo, mf_method=method,
                          log_fn=logs.append, mesh=tmesh(4))
    jrep, *_ = j_train_model(S["jdata"], jp, algo=algo, mf_method=method,
                             log_fn=jlogs.append, mesh=jmesh(4))
    assert type(rep.solver).__name__ == solver
    assert ("fell back" in " ".join(logs)) == (
        "fell back" in " ".join(jlogs))
    assert np.isfinite(rep.best_metric)


def _patch_dense_draws(monkeypatch):
    """DenseBlockDSGDSolver.draw_schedule drawing the JAX loop's key chain
    (PRNGKey(seed), one split an epoch) through JAX's stripe orders."""
    def draw(self):
        if not hasattr(self, "_jax_key"):
            self._jax_key = jax.random.PRNGKey(self.params.seed)
        self._jax_key, ek = jax.random.split(self._jax_key)
        return _jax_dense_draws(self.SU, self.n_shards, ek)
    monkeypatch.setattr(DenseBlockDSGDSolver, "draw_schedule", draw)


def test_dense_block_dsgd_train_model_dispatch(setup, monkeypatch):
    """mesh + densesgd drives DenseBlockDSGDSolver through the loop to
    JAX's threshold, and trains as JAX's front door does (JAX's stripe
    orders injected: val RMSE of the first 4 epochs and the state at rtol
    1e-3, before the bf16 operand roundings compound); a rank-masked model
    falls back to mesh blocksgd with JAX's log line."""
    S = setup
    _patch_dense_draws(monkeypatch)
    kw = dict(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.05,
              max_iter=25, seed=5, disp_iter=10 ** 6)
    rep, *_ = train_model(S["data"], Params(**kw), algo="mf",
                          mf_method="densesgd", log_fn=lambda s: None,
                          mesh=tmesh(4))
    assert rep.best_metric < 3 * NOISE + 0.1, rep.best_metric
    kw["max_iter"] = 4
    p, jp = Params(**kw), JParams(**kw)
    js = j_init_state(jp, S["data"].n_users, S["data"].n_items)
    rep, *_ = train_model(S["data"], p, algo="mf", mf_method="densesgd",
                          init_state_override=tstate(js),
                          log_fn=lambda s: None, mesh=tmesh(4))
    jrep, *_ = j_train_model(S["jdata"], jp, algo="mf",
                             mf_method="densesgd", init_state_override=js,
                             log_fn=lambda s: None, mesh=jmesh(4))
    np.testing.assert_allclose([h.val_rmse for h in rep.history],
                               [h.val_rmse for h in jrep.history],
                               rtol=1e-3)
    close(rep.state, jrep.state, 1e-3, 1e-4)
    logs = []
    p3 = Params(fac_dim=4, rho_rms=1.0, alpha=0.0, learn_rate=0.05,
                max_iter=3, seed=5, disp_iter=10 ** 6)
    rep3, *_ = train_model(S["data"], p3, algo="TMF", mf_method="densesgd",
                           log_fn=logs.append, mesh=tmesh(4))
    assert any("falling back" in s for s in logs), logs[:3]
    assert isinstance(rep3.solver, BlockDSGDSolver)


def test_train_model_mesh_resume_is_exact(setup, tmp_path):
    """A mesh run stopped after 2 epochs and resumed from its checkpoint
    ends where an uninterrupted run of 4 ends (the epoch rng rides
    internal_state)."""
    S = setup
    kw = dict(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.05,
              seed=5, disp_iter=10 ** 6, save_iter=1)
    full, *_ = train_model(S["data"], Params(max_iter=4, **kw),
                           algo="mf", mf_method="densesgd",
                           log_fn=lambda s: None, mesh=tmesh(4))
    prefix = str(tmp_path / "run")
    train_model(S["data"], Params(max_iter=2, **kw), algo="mf",
                mf_method="densesgd", prefix=prefix,
                log_fn=lambda s: None, mesh=tmesh(4))
    res, *_ = train_model(S["data"], Params(max_iter=4, **kw), algo="mf",
                          mf_method="densesgd", prefix=prefix, resume=True,
                          log_fn=lambda s: None, mesh=tmesh(4))
    for a, b in zip(res.state, full.state):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# 2-process gloo runs
# ----------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("mode", ["dsgd", "tmfdropout", "block",
                                  "dense_float", "dense_codes", "als",
                                  "ialspp", "alsdense"])
def test_two_process_run_equals_one_process(tmp_path, monkeypatch, mode):
    """Two gloo processes, each staging only its host-local rows and its 4
    of 8 shards, train the factors one process trains on the 8-shard mesh,
    bit for bit (block: and the sharded checkpoint round-trips across both
    processes). The coordinate modes train through train_model(mesh=...):
    each process gathers the whole train matrix from the host-local rows,
    solves its share of every half-sweep and all-gathers the rest."""
    worker = os.path.join(HERE, "torch_mesh_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + env.get("PYTHONPATH", "").split(os.pathsep))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, worker, port, str(i), str(tmp_path), mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i}:\n{outs[i]}"
        assert "WORKER_OK" in outs[i]
        if mode == "block":
            assert "CKPT_OK" in outs[i]
    multi = np.load(str(tmp_path / f"multi_{mode}.npz"))

    data, params, model_fn, solver_fn = problem(mode)
    if mode in COORD_MODES:
        small_batches(monkeypatch.setattr)
        rep = train_coord(data, params, mode, tmesh(8))
        assert np.array_equal(rep.state.u_fac.numpy(), multi["u_fac"])
        assert np.array_equal(rep.state.i_fac.numpy(), multi["i_fac"])
        # both processes solved user rows
        assert len(multi["solved"]) == 2 and min(multi["solved"]) > 0
        return
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    solver = solver_fn(model_fn(), data.train_mat, iu, ii, tmesh(8))
    state = train(solver, params, data.n_users, data.n_items)
    assert np.array_equal(state.u_fac.numpy(), multi["u_fac"])
    assert np.array_equal(state.i_fac.numpy(), multi["i_fac"])
