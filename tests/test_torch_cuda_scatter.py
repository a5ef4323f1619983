"""The scatter-add engines are reproducible on the card: colliding rows are
summed in a fixed order (matfac_tpu_torch/ops/scatter.py), so two runs of
an epoch give the same bits and a resumed run equals the uninterrupted
one. The route is the hand-written kernel csrc/ordered_scatter.cu: it
equals PyTorch's ``index_put_(accumulate=True)`` bit for bit on 2-D
tables, with a staged plan as with one made per call, and so do the sgd
engine's fused steps and the stream BPR epochs. Every test here is marked ``cuda`` and skips
without a CUDA device. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_scatter.py
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from matfac_tpu_torch import (Data, Params, low_rank_ratings,
                              split_train_test_val)
from matfac_tpu_torch.data.synthetic import synthetic_data
from matfac_tpu_torch.models.base import MFState, ModelMF, init_state
from matfac_tpu_torch.models.bpr import ModelMFBPR
from matfac_tpu_torch.models.increment import train_increment
from matfac_tpu_torch.ops.scatter import (index_add_ordered_,
                                          ordered_scatter,
                                          ordered_scatter_plain,
                                          plan_ordered, stage_plans)
from matfac_tpu_torch.ops.svd_init import svd_init
from matfac_tpu_torch.parallel.dsgd import DSGDShardedSolver
from matfac_tpu_torch.parallel.mesh import make_mesh
from matfac_tpu_torch.solvers import bpr as bpr_mod
from matfac_tpu_torch.solvers.bpr import BPRSolver
from matfac_tpu_torch.solvers.bpr_dense import DenseBPRSolver
from matfac_tpu_torch.solvers.sgd import SGDSolver
from matfac_tpu_torch.train.loop import train_model
from matfac_tpu_torch.utils import freq


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card's "
                    "scatter order")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data():
    mat, _, _ = low_rank_ratings(600, 500, k=4, density=0.1, seed=2,
                                 noise=0.1, nonneg=True)
    tr, te, va = split_train_test_val(mat, 0.1, 0.1, seed=1)
    return Data(train_mat=tr, test_mat=te, val_mat=va)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _start(n_users, n_items, k, seed=4):
    g = torch.Generator().manual_seed(seed)
    return MFState(torch.randn(n_users, k, generator=g) * 0.1,
                   torch.randn(n_items, k, generator=g) * 0.1,
                   torch.zeros(n_users), torch.zeros(n_items),
                   torch.zeros(()))


def _on(state, dev):
    return type(state)(*(t.to(dev, copy=True) for t in state))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_index_add_ordered_is_reproducible(dtype, dim):
    """A batch whose first row is hit 6,000 times (and the rest at random)
    sums to the same bits over 5 calls. An f32 table equals the CPU's
    ``index_add_`` within rtol / atol 1e-5. A bf16 table is rounded to
    bf16 at every add, each duplicate in the index's order (the hot row
    drifts ~0.45 from the exact sum): it is held to that same-order sum
    on the CPU, ``index_put_(accumulate=True)``, at torch's bf16
    tolerance (rtol 1.6e-2, atol 1e-5). The CPU's ``index_add_`` on bf16
    does not round at every add, so it is not that reference."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    n_rows, k, n = 3000, 64, 16_384
    idx = np.where(rng.random(n) < 6000 / n, 0, rng.integers(0, n_rows, n))
    index = torch.from_numpy(idx.astype(np.int64))
    table = torch.from_numpy(rng.normal(0, 1, (n_rows, k)).astype(
        np.float32))
    src = torch.from_numpy(rng.normal(0, 1e-2, (n, k)).astype(np.float32))
    if dim == 1:
        table, src = table.t().contiguous(), src.t().contiguous()
    table, src = table.to(dtype), src.to(dtype)
    runs = [index_add_ordered_(table.to(dev, copy=True), dim, index.to(dev),
                               src.to(dev)) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    want = table.clone()
    if dtype == torch.float32:
        want.index_add_(dim, index, src)
        tol = (1e-5, 1e-5)
    else:
        want.movedim(dim, 0).index_put_((index,), src.movedim(dim, 0),
                                        accumulate=True)
        tol = (1.6e-2, 1e-5)
    torch.testing.assert_close(runs[0].cpu(), want, rtol=tol[0],
                               atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["mf", "tmf_bias"])
def test_scatter_resume_is_bit_exact_on_the_card(algo, tmp_path):
    """mf_method="sgd" (and tmf_bias, an othersrc model on the same
    engine) stopped after 2 epochs and resumed to 4 equals the
    uninterrupted 4-epoch run, bit for bit."""
    _cuda()
    data = _data()
    p = Params(fac_dim=16, u_reg=0.01, i_reg=0.01, learn_rate=0.05,
               max_iter=4, seed=1, disp_iter=1000, save_iter=1,
               batch_size=512)
    run = lambda prefix, params, resume: train_model(
        data, params, algo=algo, mf_method="sgd", device="cuda",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=2), False)
    res = run("part", p, True)
    assert full.state.u_fac.device.type == "cuda"
    assert _same(full.state, res.state)
    assert full.best_metric == res.best_metric


@pytest.mark.cuda
def test_stream_bpr_epoch_is_reproducible():
    """Two runs of one stream BPR epoch on the same draws: the same bits."""
    dev = _cuda()
    data = _data()
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    p = Params(fac_dim=16, u_reg=0.001, i_reg=0.001, seed=3,
               batch_size=512)
    s = BPRSolver(ModelMFBPR(p, data.n_users, data.n_items), p,
                  data.train_mat, iu, ii, device=dev)
    border, bits = s.draw()
    s0 = _start(data.n_users, data.n_items, p.fac_dim)
    a = s.epoch_with(_on(s0, dev), 0.1, border, bits)
    b = s.epoch_with(_on(s0, dev), 0.1, border, bits)
    torch.cuda.synchronize()
    assert _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cn", [False, True])
def test_dense_bpr_panel_epoch_is_reproducible(cn):
    """Two runs of the dense BPR panel epoch (its Cn / C / count scatters
    in a fixed order) on the same draws: the same bits."""
    dev = _cuda()
    data = _data()
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    p = Params(fac_dim=16, u_reg=0.001, i_reg=0.001, seed=3,
               batch_size=512)
    model = ModelMFBPR(p, data.n_users, data.n_items)
    make = lambda: DenseBPRSolver(model, p, data.train_mat, iu, ii, bu=128,
                                  panel_q=16, collision_norm=cn, device=dev)
    s1, s2 = make(), make()
    row_of, d = s1.draw()
    s0 = _start(data.n_users, data.n_items, p.fac_dim)
    a = s1.epoch_with(_on(s0, dev), 0.05, row_of, d)
    b = s2.epoch_with(_on(s0, dev), 0.05, row_of, d)
    torch.cuda.synchronize()
    assert _same(a, b)


@pytest.mark.cuda
def test_scatter_dsgd_epoch_is_reproducible():
    """Two runs of one scatter DSGD epoch on 4 shards of the card, one
    schedule: the same bits."""
    dev = _cuda()
    data, _, _ = synthetic_data(n_users=600, n_items=400, k=4, density=0.2,
                                seed=9, noise=0.05, nonneg=True)
    p = Params(fac_dim=32, u_reg=0.01, i_reg=0.01, learn_rate=0.05, seed=5)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    mesh = make_mesh((4,), ("u",), devices=[dev] * 4)
    s = DSGDShardedSolver(ModelMF(p, data.n_users, data.n_items), p,
                          data.train_mat, iu, ii, mesh, batch_size=256)
    sched = s.draw_schedule()
    st = init_state(p, data.n_users, data.n_items, device="cpu")
    a = s.epoch_with(_on(st, dev), 0.005, sched)
    b = s.epoch_with(_on(st, dev), 0.005, sched)
    torch.cuda.synchronize()
    assert _same(a, b)


@pytest.mark.cuda
def test_increment_is_reproducible():
    """Two runs of train_increment for 6 epochs (one growth step, decided
    by the probe sums) on the card: the same bits and ranks."""
    _cuda()
    data = _data()
    data.graph_mat = data.val_mat
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    p = Params(fac_dim=16, u_reg=0.01, i_reg=0.01, learn_rate=0.05,
               max_iter=6, seed=1, batch_size=512)
    runs = [train_increment(data, p, iu, ii, log_fn=lambda s: None,
                            device="cuda")[0] for _ in range(2)]
    assert runs[0].state.u_fac.device.type == "cuda"
    assert _same(runs[0].state, runs[1].state)
    assert np.array_equal(runs[0].rank_u, runs[1].rank_u)
    assert np.array_equal(runs[0].rank_i, runs[1].rank_i)
    assert runs[0].history == runs[1].history


@pytest.mark.cuda
def test_svd_init_is_reproducible():
    """svd_init twice on the card: the same bits."""
    _cuda()
    data = _data()
    runs = [svd_init(data.train_mat, 16, seed=3, device="cuda")
            for _ in range(2)]
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


def _put(table, dim, index, source, plan=None):
    """The reference route: PyTorch's sort-based fixed-order sum."""
    table.movedim(dim, 0).index_put_((index,), source.movedim(dim, 0),
                                     accumulate=True)
    return table


def _hot_case(dtype, k, dim, dev, n_rows=3000, n=16_384, seed=0):
    """A batch whose first row is hit about 6,000 times, the rest at
    random; the table and source along ``dim``."""
    rng = np.random.default_rng(seed)
    idx = np.where(rng.random(n) < 6000 / n, 0, rng.integers(0, n_rows, n))
    index = torch.from_numpy(idx.astype(np.int64)).to(dev)
    table = torch.from_numpy(rng.normal(0, 1, (n_rows, k)).astype(
        np.float32))
    src = torch.from_numpy(rng.normal(0, 1e-2, (n, k)).astype(np.float32))
    if dim == 1:
        table, src = table.t().contiguous(), src.t().contiguous()
    return table.to(dev, dtype), index, src.to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_equals_index_put(dtype, k, dim):
    """The kernel, with a plan made per call and with a staged int32 plan,
    gives the bits of ``index_put_(accumulate=True)`` and of its plain
    version on the card; one launch a call."""
    dev = _cuda()
    table, index, src = _hot_case(dtype, k, dim, dev)
    want = _put(table.clone(), dim, index, src)
    launches = ordered_scatter.launches
    got = index_add_ordered_(table.clone(), dim, index, src)
    staged = stage_plans(index.view(1, -1), table.shape[dim])[0]
    got_staged = index_add_ordered_(table.clone(), dim, index, src, staged)
    plain = ordered_scatter_plain(table.clone(), dim, src,
                                  plan_ordered(index))
    torch.cuda.synchronize()
    assert ordered_scatter.launches == launches + 2
    assert torch.equal(got, want)
    assert torch.equal(got_staged, want)
    assert torch.equal(plain, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_kernel_on_strided_and_odd_shapes(dtype):
    """k of 1, 3, 100 and 200 (scalar and vector lanes, several column
    passes), a table whose rows are strided, a source that is a column
    slice: the kernel equals its plain version bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    for k in (1, 3, 100, 200):
        idx = np.where(rng.random(5000) < 0.3, 7, rng.integers(0, 90, 5000))
        index = torch.from_numpy(idx.astype(np.int64)).to(dev)
        big = torch.from_numpy(rng.normal(0, 1, (90, k + 5))).to(dev, dtype)
        table = big[:, 2:2 + k]
        src = torch.from_numpy(rng.normal(0, 1e-2, (5000, k + 1))).to(
            dev, dtype)[:, 1:]
        plan = plan_ordered(index)
        got = index_add_ordered_(table.clone(), 0, index, src)
        strided = big.clone()
        index_add_ordered_(strided[:, 2:2 + k], 0, index, src, plan)
        want = ordered_scatter_plain(table.clone(), 0, src, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), k
        assert torch.equal(strided[:, 2:2 + k], want), k
        assert torch.equal(strided[:, :2], big[:, :2]), k
        assert torch.equal(strided[:, 2 + k:], big[:, 2 + k:]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_1d_tables_are_run_to_run_identical(dtype):
    """A bias table: five calls give the same bits, which are the plain
    version's (the adds in the index's order)."""
    dev = _cuda()
    table, index, src = _hot_case(dtype, 1, 0, dev)
    table, src = table[:, 0].contiguous(), src[:, 0].contiguous()
    plan = plan_ordered(index)
    runs = [index_add_ordered_(table.clone(), 0, index, src, plan)
            for _ in range(5)]
    want = ordered_scatter_plain(table.clone(), 0, src, plan)
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert torch.equal(runs[0], want)


@pytest.mark.cuda
def test_a_staged_call_makes_no_host_sync():
    dev = _cuda()
    table, index, src = _hot_case(torch.float32, 64, 0, dev)
    plan = stage_plans(index.view(1, -1), table.shape[0])[0]
    index_add_ordered_(table, 0, index, src, plan)     # builds, loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            index_add_ordered_(table, 0, index, src, plan)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_an_id_out_of_range_traps():
    """An id past the table stops the card's work in its process (the
    kernel traps, as index_put_'s device assert does): the process fails
    at its next sync and the table is never written past its end."""
    _cuda()
    code = textwrap.dedent("""
        import torch
        from matfac_tpu_torch.ops.scatter import index_add_ordered_
        t = torch.zeros(10, 64, device="cuda")
        i = torch.tensor([3, 10, 3], device="cuda")
        index_add_ordered_(t, 0, i, torch.ones(3, 64, device="cuda"))
        torch.cuda.synchronize()
        print("no trap")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode != 0 and "no trap" not in out.stdout, out


def _epoch_through(module, route, run):
    """``run()`` with ``module.index_add_ordered_`` swapped for
    ``route``."""
    real = module.index_add_ordered_
    module.index_add_ordered_ = route
    try:
        return run()
    finally:
        module.index_add_ordered_ = real


@pytest.mark.cuda
def test_sgd_epoch_equals_the_index_put_route():
    """Each batch of one SGDSolver epoch: the fused step's scatters, by the
    staged plans, equal ``index_put_(accumulate=True)`` of the step's own
    gradient rows onto the batch's starting tables, bit for bit."""
    dev = _cuda()
    data = _data()
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    p = Params(fac_dim=64, u_reg=0.01, i_reg=0.01, seed=3, batch_size=512)
    s = SGDSolver(ModelMF(p, data.n_users, data.n_items), p,
                  data.train_mat, iu, ii, device=dev)
    U, I, bu, bi, _ = _on(_start(data.n_users, data.n_items, p.fac_dim),
                          dev)
    U0 = U.clone()
    step = s.step.epoch(U, I, bu, bi, 0.05)
    gu, gi, _, _ = s.step._scratch
    B = s.batch_size
    for b in s.batch_order().tolist():
        sl = slice(b * B, (b + 1) * B)
        want_u, want_i = U.clone(), I.clone()
        step(b, s.valid[sl].clone(), None, None)
        want_u.index_put_((s.rows[sl],), gu, accumulate=True)
        want_i.index_put_((s.cols[sl],), gi, accumulate=True)
        torch.cuda.synchronize()
        assert torch.equal(U, want_u) and torch.equal(I, want_i), b
    assert not torch.equal(U, U0)


@pytest.mark.cuda
def test_stream_bpr_epoch_equals_the_index_put_route():
    """One stream BPR epoch (user side staged, item side sorted per call)
    equals, bit for bit, the same epoch through
    ``index_put_(accumulate=True)``."""
    dev = _cuda()
    data = _data()
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    p = Params(fac_dim=64, u_reg=0.001, i_reg=0.001, seed=3,
               batch_size=512)
    s = BPRSolver(ModelMFBPR(p, data.n_users, data.n_items), p,
                  data.train_mat, iu, ii, device=dev)
    border, bits = s.draw()
    s0 = _start(data.n_users, data.n_items, p.fac_dim)
    a = s.epoch_with(_on(s0, dev), 0.1, border, bits)
    b = _epoch_through(bpr_mod, _put,
                       lambda: s.epoch_with(_on(s0, dev), 0.1, border, bits))
    torch.cuda.synchronize()
    assert _same(a, b)
