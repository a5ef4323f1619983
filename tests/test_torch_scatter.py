"""The ordered scatter's plans and its plain version on the CPU
(matfac_tpu_torch/ops/scatter.py): ``plan_ordered`` and ``stage_plans``
are stable sorts that keep every run, ``ordered_scatter_plain`` adds each
run in the plan's order rounding at every add (CPU
``index_put_(accumulate=True)``, a loop of single adds), a call with a
plan equals one without, the plans the engines stage on the card are
their batches' stable sorts (a CPU solver stages none), the kernel
wrapper refuses what it does not take before it builds anything, and
``scatter.staged`` counts only while a profiler records. The kernel
itself is held on the card: tests/test_torch_cuda_scatter.py."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.synthetic import leave_one_out_data, \
    synthetic_data
from matfac_tpu_torch.models.base import init_state
from matfac_tpu_torch.ops import scatter
from matfac_tpu_torch.ops.scatter import (Plan, index_add_ordered_,
                                          ordered_scatter,
                                          ordered_scatter_plain,
                                          plan_ordered, stage_plans)
from matfac_tpu_torch.train import profiler as tprof
from matfac_tpu_torch.train.loop import train_model

INDICES = {
    "empty": [],
    "single": [3],
    "all_equal": [2] * 37,
    "distinct": [5, 0, 7, 1],
    "runs": [4, 1, 4, 4, 0, 1, 6, 4, 0, 0, 6, 1],
}


def _hot(n=3000, n_rows=50, seed=0):
    """Row 0 hit about 40% of the time, the rest at random. (Kept under
    32,768 values at k 8: above that a CPU f32 ``index_put_`` with
    accumulate may add in parallel, in no fixed order.)"""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < 0.4, 0, rng.integers(0, n_rows, n))


def _case(idx, k, dtype, dim, seed=1):
    rng = np.random.default_rng(seed)
    index = torch.as_tensor(np.asarray(idx, np.int64))
    n_rows = int(index.max()) + 3 if index.numel() else 4
    table = torch.from_numpy(rng.normal(0, 1, (n_rows, k)).astype(
        np.float32)).to(dtype)
    src = torch.from_numpy(rng.normal(0, 1e-2, (len(idx), k)).astype(
        np.float32)).to(dtype)
    if dim == 1:
        table, src = table.t().contiguous(), src.t().contiguous()
    return table, index, src


def _one_by_one(table, dim, index, src):
    """Each entry added alone, in the index's order, rounded each time."""
    view, s = table.movedim(dim, 0), src.movedim(dim, 0)
    acc = torch.float64 if table.dtype == torch.float64 else torch.float32
    for j, r in enumerate(index.tolist()):
        view[r] = (view[r].to(acc) + s[j].to(acc)).to(table.dtype)
    return table


@pytest.mark.parametrize("name", list(INDICES))
def test_plan_ordered_is_a_stable_sort_that_keeps_every_run(name):
    index = torch.tensor(INDICES[name], dtype=torch.int64)
    order, rows = plan_ordered(index)
    n = index.numel()
    assert order.dtype == rows.dtype == torch.int64
    assert torch.equal(rows, torch.sort(index).values)
    assert torch.equal(index[order], rows)
    assert sorted(order.tolist()) == list(range(n))
    # stable: within a run the positions ascend
    for r in set(INDICES[name]):
        run = order[rows == r].tolist()
        assert run == sorted(run) == [j for j in range(n)
                                      if INDICES[name][j] == r]
    # the plan's heads are the distinct rows
    heads = [j for j in range(n) if j == 0 or rows[j] != rows[j - 1]]
    assert rows[heads].tolist() == sorted(set(INDICES[name]))


def test_plan_ordered_takes_int32():
    order, rows = plan_ordered(torch.tensor([3, 1, 3, 0], dtype=torch.int32))
    assert rows.tolist() == [0, 1, 3, 3] and order.tolist() == [3, 1, 0, 2]


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("name", list(INDICES) + ["hot"])
def test_plain_version_adds_in_order_and_rounds_each_add(name, dtype, dim):
    """The plain version of the kernel equals a loop of single adds in the
    index's order, and the CPU's ``index_put_(accumulate=True)``, bit for
    bit."""
    idx = _hot() if name == "hot" else INDICES[name]
    table, index, src = _case(idx, 8, dtype, dim)
    want = _one_by_one(table.clone(), dim, index, src)
    t = table.clone()
    got = ordered_scatter_plain(t, dim, src, plan_ordered(index))
    assert got is t
    assert torch.equal(got, want)
    put = table.clone()
    put.movedim(dim, 0).index_put_((index,), src.movedim(dim, 0),
                                   accumulate=True)
    assert torch.equal(got, put)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_on_a_1d_table(dtype):
    table, index, src = _case(_hot(), 1, dtype, 0)
    table, src = table[:, 0].contiguous(), src[:, 0].contiguous()
    want = _one_by_one(table.clone(), 0, index, src)
    got = ordered_scatter_plain(table.clone(), 0, src, plan_ordered(index))
    assert torch.equal(got, want)


def test_plain_version_takes_a_staged_plan():
    """An int32 staged plan gives the bits of the plan made per call."""
    idx = _hot(n=4096)
    table, index, src = _case(idx, 8, torch.bfloat16, 0)
    plans = stage_plans(index.view(4, 1024), table.shape[0])
    a, b = table.clone(), table.clone()
    for j, plan in enumerate(plans):
        sl = slice(j * 1024, (j + 1) * 1024)
        ordered_scatter_plain(a, 0, src[sl], plan)
        ordered_scatter_plain(b, 0, src[sl], plan_ordered(index[sl]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_plan_changes_nothing_on_the_cpu(dtype, dim, staged):
    """With or without a plan, a CPU table takes ``index_add_``."""
    idx = _hot(n=2048)
    table, index, src = _case(idx, 8, dtype, dim)
    plan = (stage_plans(index.view(1, -1), table.shape[dim])[0] if staged
            else plan_ordered(index))
    want = index_add_ordered_(table.clone(), dim, index, src)
    got = index_add_ordered_(table.clone(), dim, index, src, plan)
    assert torch.equal(got, want)
    assert torch.equal(want, table.clone().index_add_(dim, index, src))


def test_stage_plans_sorts_each_batch_and_checks_ids():
    index = torch.tensor([[2, 0, 2, 1], [1, 1, 0, 3]])
    plans = stage_plans(index, 4)
    assert [p.rows.tolist() for p in plans] == [[0, 1, 2, 2], [0, 1, 1, 3]]
    assert [p.order.tolist() for p in plans] == [[1, 3, 0, 2], [2, 0, 1, 3]]
    assert all(p.rows.dtype == p.order.dtype == torch.int32 for p in plans)
    assert all(p.rows.is_contiguous() and p.order.is_contiguous()
               for p in plans)
    with pytest.raises(ValueError, match="out of range"):
        stage_plans(index, 3)
    with pytest.raises(ValueError, match="out of range"):
        stage_plans(index - 1, 4)
    with pytest.raises(ValueError, match="n_batches"):
        stage_plans(index.view(-1), 4)
    assert stage_plans(torch.zeros(0, 5, dtype=torch.int64), 4) == []


def _argsort_plans(index2d):
    return [(torch.argsort(r, stable=True), torch.sort(r, stable=True)[0])
            for r in index2d]


def _held_to_argsort(plans, index2d):
    want = _argsort_plans(index2d)
    assert len(plans) == len(want)
    for p, (o, r) in zip(plans, want):
        assert torch.equal(p.order.long(), o)
        assert torch.equal(p.rows.long(), r)


def _sgd_solver():
    data, _, _ = synthetic_data(n_users=48, n_items=36, k=3, density=0.3,
                                seed=4)
    p = Params(fac_dim=4, learn_rate=0.01, max_iter=1, seed=2,
               batch_size=64, disp_iter=1000, save_iter=1000)
    rep, *_ = train_model(data, p, algo="mf", mf_method="sgd", device="cpu",
                          log_fn=lambda s: None)
    return rep.solver, data, p


def _bpr_solver():
    data = leave_one_out_data(n_users=40, n_items=30, per_user=8, seed=5,
                              structured=True)
    p = Params(fac_dim=4, learn_rate=0.1, max_iter=1, seed=2, batch_size=64,
               disp_iter=1000, save_iter=1000)
    rep, *_ = train_model(data, p, algo="bpr", device="cpu",
                          log_fn=lambda s: None)
    return rep.solver, data, p


def _stage_as_on_the_card(s):
    """The plans a solver stages on a CUDA device (sgd: its step's),
    staged here on the CPU from the solver's own static index (the CPU
    solver stages none)."""
    if hasattr(s, "pos_u"):
        s.u_plans = stage_plans(s.pos_u.view(s.n_batches, s.batch_size),
                                s.model.n_users)
        return
    shape = (s.n_batches, s.batch_size)
    s.step.u_plans = stage_plans(s.rows.view(shape), s.model.n_users)
    s.step.i_plans = stage_plans(s.cols.view(shape), s.model.n_items)


def test_sgd_solver_stages_each_batch_stable_sort():
    """On the CPU the solver's step stages nothing; the plans it would
    stage on the card are each batch's stable sort, both sides."""
    s, _, _ = _sgd_solver()
    assert s.step.u_plans is None and s.step.i_plans is None
    _stage_as_on_the_card(s)
    shape = (s.n_batches, s.batch_size)
    _held_to_argsort(s.step.u_plans, s.rows.view(shape))
    _held_to_argsort(s.step.i_plans, s.cols.view(shape))


def test_bpr_solver_stages_the_user_side_of_each_batch():
    s, _, _ = _bpr_solver()
    assert s.u_plans is None
    _stage_as_on_the_card(s)
    _held_to_argsort(s.u_plans, s.pos_u.view(s.n_batches, s.batch_size))


def _plan(n, dtype=torch.int64):
    return Plan(torch.arange(n, dtype=dtype), torch.arange(n, dtype=dtype))


@pytest.mark.parametrize("bad,err", [
    (lambda t, s, p: (t, 0, s, p), "CUDA device"),
    (lambda t, s, p: (t.to(torch.int32), 0, s.to(torch.int32), p),
     "one type"),
    (lambda t, s, p: (t, 0, s.double(), p), "one type"),
    (lambda t, s, p: (t[None], 0, s, p), "1-D or 2-D"),
    (lambda t, s, p: (t, 2, s, p), "1-D or 2-D"),
    (lambda t, s, p: (t, 0, s, Plan(p.order.int(), p.rows)), "int32 or"),
    (lambda t, s, p: (t, 0, s, Plan(p.order.float(), p.rows.float())),
     "int32 or"),
])
def test_the_kernel_route_refuses_what_it_does_not_take(bad, err,
                                                       monkeypatch):
    """Each refusal comes before the library is built or loaded."""
    def no_build():
        raise AssertionError("built the kernel for a refused call")
    monkeypatch.setattr(scatter, "library", no_build)
    table, src = torch.zeros(6, 4), torch.ones(5, 4)
    with pytest.raises((TypeError, ValueError), match=err):
        ordered_scatter(*bad(table, src, _plan(5)))


@pytest.fixture
def _clean():
    tprof.reset()
    yield
    tprof.reset()


def test_staged_is_counted_only_while_a_profiler_records(_clean):
    table, index, src = _case(_hot(n=256), 4, torch.float32, 0)
    plan = plan_ordered(index)
    index_add_ordered_(table, 0, index, src, plan)
    assert tprof.records()["counts"] == {}
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    for _ in range(3):
        index_add_ordered_(table, 0, index, src, plan)
    index_add_ordered_(table, 0, index, src)
    prof.stop()
    index_add_ordered_(table, 0, index, src, plan)
    rec = tprof.records()
    assert rec["counts"] == {"scatter.staged": 3}
    assert [s.name for s in rec["spans"]] == ["scatter.ordered"] * 4


@pytest.mark.parametrize("method,share", [("sgd", 1.0), ("bpr", 0.5)])
def test_an_engines_epoch_counts_its_staged_calls(method, share, _clean):
    """With the plans a card stages, sgd passes one to every call and
    stream BPR to the user side's; with none (the CPU) no call counts."""
    s, data, p = _sgd_solver() if method == "sgd" else _bpr_solver()
    s0 = init_state(p, data.n_users, data.n_items, device="cpu")

    def epoch():
        if method == "sgd":
            return s.epoch_with(s0, 0.01, s.batch_order())
        return s.epoch_with(s0, 0.1, *s.draw())

    def counted():
        tprof.reset()
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        epoch()
        prof.stop()
        rec = tprof.records()
        n = sum(1 for sp in rec["spans"] if sp.name == "scatter.ordered")
        assert n > 0
        return rec["counts"].get("scatter.staged", 0) / n

    assert counted() == 0.0
    _stage_as_on_the_card(s)
    assert counted() == share
