"""The benchmark's TMF+Dropout cell (``ml20m-tmfdropout-densesgd``) on the
CPU: the plain reference (``benchmark/reference/tmf_stripes.py``) against
the program's tables and draws, the program's epochs against the
reference within the cell's limits, planted faults that the limits catch,
the tiny cell end to end, the heavy-tailed generator, the masked work
count, the ``stripes.ranks`` span, and the front door's engine choice at
the cell's shape. The program's CPU route is the stripe
kernel's plain version."""

import json
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, masked_work
from benchmark.reference import tmf_stripes
from benchmark.tests import _tiny
from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import init_state
from matfac_tpu_torch.models.longtail import ModelPoissonDropout
from matfac_tpu_torch.ops.dense_block_kernel import visit_quantiles
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
from matfac_tpu_torch.train import profiler as tprof
from matfac_tpu_torch.train.loop import _auto_method

CELL = "ml20m-tmfdropout-densesgd"
CONFIG = "ml20m-tmfdropout-k128"
TINY = dict(n_users=600, n_items=300, n_ratings=20000)
SEED = 3000000019


@pytest.fixture
def one_thread():
    """CPU index_add_ over many threads is slow on small tables."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    tprof.reset()
    yield
    tprof.reset()


def _tiny_cell(k: int):
    cell = harness.load_cell(CELL)
    cell.config = dict(cell.config, fac_dim=k, **TINY)
    return cell


def _bundle(k: int, seed: int = 11, rho: float = 1.0, alpha: float = 0.0):
    cell = _tiny_cell(k)
    cell.config.update(rho_rms=rho, alpha=alpha)
    return cell, cell.module("data", cell.config["generator"]).make(
        cell.config, seed, "cpu")


def _model(bundle, k, rho, alpha):
    rows, cols, _ = bundle["train"]
    nu, ni = bundle["n_users"], bundle["n_items"]
    p = Params(fac_dim=k, rho_rms=rho, alpha=alpha)
    return ModelPoissonDropout(p, nu, ni,
                               np.bincount(rows.numpy(), minlength=nu),
                               np.bincount(cols.numpy(), minlength=ni))


@pytest.mark.parametrize("k,rho,alpha", [(16, 1.0, 0.0), (128, 1.0, 0.0),
                                         (64, 2.0, 0.5)])
def test_reference_tables_equal_the_program(k, rho, alpha):
    """The reference's lambda tables, inference ranks and visit quantile
    rows, worked out again, equal ModelPoissonDropout's and
    ``visit_quantiles``' exactly."""
    _, bundle = _bundle(k, rho=rho, alpha=alpha)
    model = _model(bundle, k, rho, alpha)
    lam_u, lam_i, C, eff = tmf_stripes.tables(
        bundle["train"], bundle["n_users"], bundle["n_items"], k, rho,
        alpha)
    assert torch.equal(lam_u, model.lambda_u.long())
    assert torch.equal(lam_i, model.lambda_i.long())
    assert torch.equal(eff[lam_u - 1], model.rank_u.long())
    assert torch.equal(eff[lam_i - 1], model.rank_i.long())
    assert torch.equal(C, torch.from_numpy(model.poisson_cdf_table()))
    # the draws bite: lambdas spread and ranks below k
    assert int(lam_u.min()) < int(lam_i.max()) and int(eff.min()) < k
    u = torch.rand(64, generator=torch.Generator().manual_seed(3))
    u[:3] = torch.tensor([0.0, 1.0 - 2 ** -24, float(C[5, 5])])
    want = visit_quantiles(torch.from_numpy(model.poisson_cdf_table()), u)
    assert torch.equal(tmf_stripes.visit_rows(C, u), want.long())


@pytest.fixture(scope="module", params=[16, 128])
def program_run(request):
    """The driver's run of the tiny cell at k 16 and 128 on the CPU: the
    program's 3 checked epochs from seeded random factors, the reference's,
    and the limits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = _tiny_cell(request.param)
        driver = cell.module("drivers", cell.traffic["driver"])
        out = driver.run(cell, SEED + request.param, 0.0, False, "cpu",
                         time.perf_counter())
    finally:
        torch.set_num_threads(n)
    return cell, driver, out


def test_program_and_reference_agree_within_the_limits(program_run):
    cell, _, out = program_run
    ok, table = harness.judge(out["checks"], cell.limits)
    assert ok, table
    assert len(out["ref"]["states"]) == cell.traffic["checked_epochs"]


@pytest.mark.parametrize("fault", ["static_ranks", "rank_plus_one",
                                   "shuffled_user_lambdas", "half_batch",
                                   "bf16"])
def test_a_planted_fault_fails_the_check(program_run, fault, one_thread):
    """The reference with TMF's static ranks, with each drawn rank off by
    one, with the users' lambdas dealt to other users, with half of each
    stripe, or computed in bf16 (the control), held to the true reference
    as the program is: not correct."""
    cell, driver, out = program_run
    inp = out["inputs"]
    kw = dict(dtype=torch.bfloat16) if fault == "bf16" else dict(fault=fault)
    bad = tmf_stripes.follow(inp, driver.hyper(cell),
                             cell.traffic["checked_epochs"], **kw)
    checks = harness.training_checks(bad, out["ref"], inp["u0"], inp["i0"])
    assert not harness.judge(checks, cell.limits)[0], checks


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    dest = _tiny.tiny_copy(tmp_path_factory.mktemp("bench"))
    cfg = dest / "benchmark" / "configs" / f"{CONFIG}.json"
    d = json.loads(cfg.read_text())
    d.update(TINY)
    cfg.write_text(json.dumps(d))
    return dest


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_and_is_correct(tiny, trace):
    rc, out, err = _tiny.run(tiny, ["--workload", CELL, "--seed",
                                    str(SEED), "--seconds", "0.5",
                                    "--trace", str(trace)],
                             patch="import torch; torch.set_num_threads(1)")
    assert rc == 0, err[-3000:]
    res = _tiny.result(out)
    assert res["correct"] is True, res
    assert res["attempted"] > 0 and res["failed"] == 0
    m = res["metrics"]
    if not trace:
        assert sorted(m) == ["setup_s", "train_ratings_per_s"]
        return
    # the device's metrics are left out without a card; the host's stay
    assert sorted(m) == ["enqueue_ms.ratings", "eval_ms.rmse",
                         "mfu.ratings", "rank_ms.tmf", "sync_ms.ratings"]
    assert 0 < m["mfu.ratings"]["value"] <= 100
    assert m["rank_ms.tmf"]["value"] > 0


def _generator(name: str):
    return harness.load_file(harness.BENCH / "data" / f"{name}.py")


def test_user_counts_are_heavy_tailed_at_the_cell_shape():
    """The cell's user activity at the whole ML-20M shape: at least 20
    ratings a user, the README's 20,000,263 in all, a long tail; and the
    user lambdas it gives (train frequencies against the item law's) are
    not one value, as a uniform draw's are."""
    cfg = harness.load_cell(CELL).config
    a = cfg["assumed"]
    nu, ni, n = cfg["n_users"], cfg["n_items"], cfg["n_ratings"]
    c = _generator("explicit_heavyusers").user_counts(
        nu, ni, n, a, torch.Generator().manual_seed(SEED), "cpu")
    assert int(c.sum()) == n and int(c.min()) == 20
    assert 70 <= float(c.double().median()) <= 100
    assert 2_000 < int(c.max()) <= ni // 2
    train = 1.0 - a["test_share"] - a["val_share"]
    w = 1.0 / torch.arange(1, ni + 1, dtype=torch.float64) \
        ** a["item_power_law"]
    fu = (c * train).round()
    f = torch.cat([fu, (w / w.sum() * fu.sum()).round()])
    lam_u = tmf_stripes.lambda_table(fu, float(f.mean()),
                                     float(f.std(unbiased=False)),
                                     cfg["rho_rms"], cfg["alpha"],
                                     cfg["fac_dim"])
    assert int(lam_u.max()) - int(lam_u.min()) > 30
    assert float((lam_u > lam_u.median()).double().mean()) > 0.1


def test_user_counts_fill_up_to_the_cap():
    """Where the log-normal shares would pass half the items, those users
    stop there and the rest share what is left; the sum stays exact."""
    a = dict(user_min_ratings=20, user_activity_sigma=3.0,
             user_activity_z_max=4.5)
    c = _generator("explicit_heavyusers").user_counts(
        600, 300, 20000, a, torch.Generator().manual_seed(5), "cpu")
    assert int(c.sum()) == 20000 and int(c.min()) == 20
    assert int(c.max()) == 150 and int((c == 150).sum()) > 1
    with pytest.raises(ValueError):
        _generator("explicit_heavyusers").user_counts(
            600, 300, 11000, a, torch.Generator(), "cpu")


def test_heavy_user_generator_draws_distinct_pairs():
    """At a small size: exactly the configuration's ratings, every pair
    once, each user at least 20 and at most half the items, sorted by row
    then column; item popularity and the rating grid as explicit_lowrank
    makes them; the same seed, the same data."""
    cfg = dict(harness.load_cell(CELL).config, n_users=3000, n_items=800,
               n_ratings=120000)
    heavy = _generator("explicit_heavyusers")
    b = heavy.make(cfg, 12345, "cpu")
    parts = [b[s] for s in ("train", "val", "test")]
    rows = torch.cat([p[0] for p in parts])
    cols = torch.cat([p[1] for p in parts])
    vals = torch.cat([p[2] for p in parts])
    assert rows.numel() == cfg["n_ratings"]
    assert torch.unique(rows * 800 + cols).numel() == rows.numel()
    per_user = torch.bincount(rows, minlength=3000)
    assert int(per_user.min()) >= 20 and int(per_user.max()) <= 400
    assert float(per_user.double().std()) > 2 * float(
        per_user.double().mean()) ** 0.5
    key = b["train"][0] * 800 + b["train"][1]
    assert bool((key[1:] > key[:-1]).all())
    flat = _generator("explicit_lowrank").make(cfg, 12345, "cpu")
    fcols = torch.cat([flat[s][1] for s in ("train", "val", "test")])
    fvals = torch.cat([flat[s][2] for s in ("train", "val", "test")])
    top = lambda c: float(torch.bincount(c, minlength=800).sort(
        descending=True).values[:100].sum()) / c.numel()
    assert abs(top(cols) - top(fcols)) < 0.03
    grid = torch.arange(1, 11) * 0.5
    share = lambda v: torch.stack([(v == x).double().mean() for x in grid])
    assert float((share(vals) - share(fvals)).abs().max()) < 0.03
    again = heavy.make(cfg, 12345, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(b["train"], again["train"]))


def _pmf_mean(lam: int, k: int) -> float:
    """E[clip(Poisson(lam), 1, k)] summed over the pmf directly."""
    total, x = 0.0, 0
    while x < 20 * k + 100:
        p = math.exp(-lam + x * math.log(lam) - math.lgamma(x + 1))
        total += p * min(max(x, 1), k)
        x += 1
    return total


@pytest.mark.parametrize("k", [4, 16, 128])
def test_expected_rank_is_the_poisson_mean_of_the_clipped_draw(k):
    C64 = tmf_stripes.poisson_cdf(k)
    direct = torch.tensor([_pmf_mean(lam, k) for lam in range(1, k + 1)],
                          dtype=torch.float64)
    torch.testing.assert_close(masked_work.expected_ranks(C64), direct,
                               rtol=1e-12, atol=1e-12)
    # the f32 table the program draws from: its rounding alone
    torch.testing.assert_close(masked_work.expected_ranks(C64.float()),
                               direct, rtol=0, atol=k * 1e-6)


def test_masked_work_counts_each_rating_at_its_expected_rank():
    k = 8
    C = tmf_stripes.poisson_cdf(k).float()
    er = masked_work.expected_ranks(C)
    lam_pair = torch.tensor([1, 3, 3, 8])
    lam_u = torch.tensor([2, 8, 5])
    flops, nbytes, dims = masked_work.tmf_epoch_work(lam_pair, lam_u, 5, k,
                                                     C)
    want = float(er[0] + 2 * er[2] + er[7])
    assert dims == pytest.approx(want, rel=1e-12)
    assert flops == pytest.approx(10 * want, rel=1e-12)
    user_dims = float(er[1] + er[7] + er[4])
    assert nbytes == pytest.approx(8 * 4 + 8 * 4 + 8 * (user_dims + 5 * k),
                                   rel=1e-12)


def _solver(k: int = 16):
    _, bundle = _bundle(k)
    data = harness.port_data(bundle)
    nu, ni = bundle["n_users"], bundle["n_items"]
    rows, cols, _ = bundle["train"]
    fu = np.bincount(rows.numpy(), minlength=nu)
    fi = np.bincount(cols.numpy(), minlength=ni)
    p = Params(fac_dim=k, u_reg=0.005, i_reg=0.005, learn_rate=0.05, seed=7)
    model = ModelPoissonDropout(p, nu, ni, fu, fi)
    solver = BlockSGDSolver(model, p, data.train_mat, fu == 0, fi == 0,
                            engine="dense", bu=None, bi=None, device="cpu")
    return solver, model, p, bundle


def test_nothing_is_kept_without_a_profiler(one_thread):
    solver, model, p, _ = _solver()
    state = init_state(p, model.n_users, model.n_items, device="cpu")
    solver.epoch(state, p.learn_rate)
    assert tprof.records() == dict(spans=[], counts={})


def test_a_masked_epoch_draws_in_ranks_not_schedule(one_thread):
    """Under the profiler a TMF+Dropout epoch opens ``stripes.schedule``
    once (the order and uniforms) and ``stripes.ranks`` once, inside the
    launch: the visits' ranks drawn from the staged CDF table (the rank
    values are checked when the tiles are staged, not an epoch); it keeps
    no counter."""
    solver, model, p, _ = _solver()
    state = init_state(p, model.n_users, model.n_items, device="cpu")
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    solver.epoch(state, p.learn_rate)
    prof.stop()
    rec = tprof.records()
    names = [s.name for s in rec["spans"]]
    assert sorted(names) == ["stripes.epoch", "stripes.launch",
                             "stripes.ranks", "stripes.schedule"]
    ranks = [s for s in rec["spans"] if s.name == "stripes.ranks"]
    assert [s.parent for s in ranks] == ["stripes.launch"]
    assert rec["counts"] == {}


def test_auto_picks_densesgd_at_the_cell_shape():
    cfg = json.loads((_tiny.ROOT / "benchmark" / "configs" /
                      f"{CONFIG}.json").read_text())
    vals = np.arange(1, 11, dtype=np.float32) * 0.5
    data = SimpleNamespace(
        n_users=cfg["n_users"], n_items=cfg["n_items"],
        train_mat=SimpleNamespace(values=np.tile(vals, 1000),
                                  nnz=17_000_000))
    assert _auto_method("tmfdropout", data, Params(fac_dim=128)) == \
        "densesgd"
    # the same shape with ratings off the half-star grid: 3 B a slot
    data.train_mat.values = np.linspace(0.1, 5.0, 10_000).astype(np.float32)
    assert _auto_method("tmfdropout", data, Params(fac_dim=128)) == "sgd"
