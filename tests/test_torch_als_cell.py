"""The benchmark's bucketed ALS cell (``ml20m-mf-als``) on the CPU: the
plain reference (``benchmark/reference/mf_als.py``) against the program's
``ALSSolver`` epochs, planted faults that the cell's limits catch, the tiny
cell end to end, the ALS work count (``benchmark/als_work.py``), the
sweep's spans and counters, and the front door's engine choice at the
cell's shape."""

import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import als_work, harness, roofline
from benchmark.reference import mf_als
from benchmark.tests import _tiny
from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import ModelMF
from matfac_tpu_torch.solvers.als import ALSSolver
from matfac_tpu_torch.train import profiler as tprof
from matfac_tpu_torch.train.loop import _auto_method
from matfac_tpu_torch.utils import freq as ufreq

CELL = "ml20m-mf-als"
CONFIG = "ml20m-mf-als-k64"
# the tiny shape's ratings: ~85 train ratings a user and 140 or more an
# item at k 16, about the cell's 1.9 ratings a rank dimension or more, so
# that a row's Gram is well conditioned, as it is at the cell's shape.
# With 20,000 ratings (28 a user) the tail's Grams are near singular, and
# a reference in f64 moves 2% from the same reference in f32 in 3 epochs.
TINY = dict(n_users=600, n_items=300, n_ratings=60000)
SEED = 3000000019


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    tprof.reset()
    yield
    tprof.reset()


def _tiny_cell(k: int = 16):
    cell = harness.load_cell(CELL)
    cell.config = dict(cell.config, fac_dim=k, **TINY)
    return cell


def _bundle(k: int, seed: int = 11, drop=((), ())):
    """The generator's tiny data; the train ratings of the users and items
    in ``drop`` left out, so that they are invalid."""
    cell = _tiny_cell(k)
    b = cell.module("data", cell.config["generator"]).make(cell.config, seed,
                                                          "cpu")
    rows, cols, vals = b["train"]
    keep = ~(torch.isin(rows, torch.tensor(drop[0], dtype=torch.int64))
             | torch.isin(cols, torch.tensor(drop[1], dtype=torch.int64)))
    b["train"] = (rows[keep], cols[keep], vals[keep])
    return cell, b


def _solver(bundle, k: int, reg: float):
    data = harness.port_data(bundle)
    nu, ni = bundle["n_users"], bundle["n_items"]
    iu, ii = ufreq.invalid_users_items(data.train_mat, nu, ni)
    p = Params(fac_dim=k, u_reg=reg, i_reg=reg, seed=7)
    return ALSSolver(ModelMF(p, nu, ni), p, data.train_mat, iu, ii,
                     device="cpu"), p


@pytest.mark.parametrize("k,reg,drop", [(8, 0.002, ((), ())),
                                        (16, 0.002, ((3, 17), (5,))),
                                        (16, 0.5, ((0,), (0, 299)))])
def test_program_epochs_follow_the_reference(k, reg, drop, one_thread):
    """Three epochs of the port's ``ALSSolver`` from seeded random factors
    against ``mf_als.follow``, in f32: each table within 2e-4 of the
    reference's largest entry. Both sum the same products in f32, the
    program by a batched product over each bucket's gathered rows, the
    reference by a dense product over every column, so the Grams differ by
    rounding (~1e-7 relative), and each solve scales that by its row's
    condition number, over six half-sweeps: the gaps measured here grow
    from 2e-7 after the first half-sweep to 5e-5 of the largest entry
    after the sixth, under 2e-4 by 3.8x. The users and
    items without a train rating keep their factors, bit for bit."""
    _, bundle = _bundle(k, drop=drop)
    nu, ni = bundle["n_users"], bundle["n_items"]
    solver, p = _solver(bundle, k, reg)
    u0, i0 = harness.job_factors(nu, ni, k, SEED, 0, "cpu")
    state = harness.job_state(nu, ni, k, SEED, 0, "cpu")
    ref = mf_als.follow(dict(bundle, u0=u0, i0=i0, seed=SEED, skip=0),
                        dict(k=k, u_reg=reg, i_reg=reg), 3)
    for U, V in ref["states"]:
        state = solver.epoch(state, p.learn_rate)
        for got, want in ((state.u_fac, U), (state.i_fac, V)):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 2e-4 * scale
    for row in drop[0]:
        assert torch.equal(state.u_fac[row], u0[row])
    for col in drop[1]:
        assert torch.equal(state.i_fac[col], i0[col])
    assert not torch.equal(state.u_fac, u0)


@pytest.fixture(scope="module")
def program_run():
    """``drivers/train_als.py``'s run of the tiny cell on the CPU: its 3
    checked epochs from seeded random factors, the reference's, and the
    limits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = _tiny_cell()
        driver = cell.module("drivers", cell.traffic["driver"])
        out = driver.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    finally:
        torch.set_num_threads(n)
    return cell, driver, out


def test_program_and_reference_agree_within_the_limits(program_run):
    cell, _, out = program_run
    ok, table = harness.judge(out["checks"], cell.limits)
    assert ok, table
    assert len(out["ref"]["states"]) == cell.traffic["checked_epochs"]


@pytest.mark.parametrize("fault", ["jacobi", "no_reg", "users_only",
                                   "half_batch"])
def test_a_planted_fault_fails_the_check(program_run, fault, one_thread):
    """The reference with the item pass reading the old user table (a
    Jacobi sweep), with lambda left out, with the item pass skipped, or
    with each row's equations from half its ratings, held to the true
    reference as the program is: not correct."""
    cell, driver, out = program_run
    inp = out["inputs"]
    bad = mf_als.follow(inp, driver.hyper(cell),
                        cell.traffic["checked_epochs"], fault=fault)
    checks = harness.training_checks(bad, out["ref"], inp["u0"], inp["i0"])
    assert not harness.judge(checks, cell.limits)[0], checks


def test_the_programs_bf16_tables_fail_the_check(program_run, one_thread):
    """The calibration's control, the program's own bf16 tables (each
    solved row rounded to bf16), is not correct."""
    cell, driver, _ = program_run
    out = driver.run(cell, SEED, 0.0, False, "cpu", time.perf_counter(),
                     dtype=torch.bfloat16)
    assert not harness.judge(out["checks"], cell.limits)[0], out["checks"]


def test_the_reference_stands_alone():
    """The reference imports neither the program nor JAX, and runs with
    TF32 off."""
    code = ("import sys; from benchmark.reference import mf_als; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matfac_tpu_torch', 'matfac_tpu', 'jax', 'jaxlib')]; "
            "print(bad)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=_tiny.ROOT, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr
    _, bundle = _bundle(8)
    u0, i0 = harness.job_factors(bundle["n_users"], bundle["n_items"], 8,
                                 SEED, 0, "cpu")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        mf_als.follow(dict(bundle, u0=u0, i0=i0), dict(u_reg=0.1,
                                                       i_reg=0.1), 1)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    dest = _tiny.tiny_copy(tmp_path_factory.mktemp("bench"))
    cfg = dest / "benchmark" / "configs" / f"{CONFIG}.json"
    d = json.loads(cfg.read_text())
    d.update(_tiny.TINY_CONFIGS["ml20m-mf-k64"], **TINY)
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
    # every job that ended in the window ran its 20 epochs (a loaded CPU
    # may end none in 0.5 s)
    assert re.search(r"jobs ended: \{('max_iter': \d+)?\} ", err), err
    m = res["metrics"]
    if not trace:
        assert sorted(m) == ["setup_s", "train_ratings_per_s"]
        return
    # the device's metrics are left out without a card; the host's stay
    assert sorted(m) == ["enqueue_ms.ratings", "eval_ms.rmse",
                         "mfu.ratings", "rated_share.als", "sync_ms.als"]
    assert 0 < m["mfu.ratings"]["value"] <= 100
    assert 50 < m["rated_share.als"]["value"] < 100


def _direct_count(indptr, n_rows, k):
    """FLOPs of one side counted operation by operation: each rating's
    multiply and add into the Gram's upper triangle and the right-hand
    side; each row's textbook Cholesky factor and two triangular solves."""
    flops = 0
    for r in range(n_rows):
        for _ in range(indptr[r], indptr[r + 1]):
            for a in range(k):
                for b in range(a, k):
                    flops += 2          # G[a, b] += q[a] * q[b]
                flops += 2              # rhs[a] += r * q[a]
        if indptr[r + 1] == indptr[r]:
            continue
        for j in range(k):
            flops += 2 * j + 1          # L[j, j] = sqrt(G - sum L[j, :j]^2)
            for _ in range(j + 1, k):
                flops += 2 * j + 1      # L[i, j] = (G - sum) / L[j, j]
        flops += 2 * k * k              # forward and back substitution
    return flops


def test_als_work_counts_against_a_direct_count():
    """At a tiny shape, ``als_epoch_work``'s FLOPs equal a count operation
    by operation, but for the Cholesky factor's terms below k^3 / 3 (the
    model's count keeps the leading term; the textbook factor adds k^2 / 2
    + k / 6 a row), and its bytes the
    sizes of the arrays an epoch must read and write: each side's CSR
    (int32 columns, f32 values, int64 pointers) once, each f32 table once
    each way."""
    rng = np.random.default_rng(0)
    nu, ni, k = 7, 5, 4
    dense = rng.random((nu, ni)) < 0.6
    dense[:, 0] = True
    flops, nbytes = 0, 0
    for m in (dense, dense.T):
        r, c = np.nonzero(m)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(
            r, minlength=m.shape[0]))]).astype(np.int64)
        cols, vals = c.astype(np.int32), np.ones(r.size, np.float32)
        flops += _direct_count(indptr, m.shape[0], k)
        nbytes += indptr.nbytes + cols.nbytes + vals.nbytes
    tables = np.zeros((nu + ni, k), np.float32)
    nbytes += 2 * tables.nbytes
    n = int(dense.sum())
    assert dense.any(1).all() and dense.any(0).all()
    want_f, want_b = als_work.als_epoch_work(n, nu, ni, k)
    lower = (nu + ni) * (k * k / 2 + k / 6)
    assert want_f == pytest.approx(flops - lower, rel=1e-12)
    assert want_b == nbytes
    # the cell's: 1.62e11 FLOPs and 0.36 GB, bound by operations
    f, b = als_work.als_epoch_work(17_000_000, 138_493, 26_744, 64)
    assert f == pytest.approx(1.62e11, rel=0.01)
    assert b == pytest.approx(3.58e8, rel=0.01)
    assert roofline.bound_by(f, b) == "operations"


def test_nothing_is_kept_without_a_profiler(one_thread):
    _, bundle = _bundle(8)
    solver, p = _solver(bundle, 8, 0.002)
    state = harness.job_state(bundle["n_users"], bundle["n_items"], 8, SEED,
                              0, "cpu")
    solver.epoch(state, p.learn_rate)
    assert tprof.records() == dict(spans=[], counts={})


def test_an_epoch_keeps_its_spans_and_the_layouts_sums(one_thread):
    """Under the profiler an epoch opens ``als.epoch`` once and, in it,
    ``als.gram`` and ``als.solve`` once a chunk; the counters add each
    chunk's real rows, gathered slots (nb x cap) and rated slots, whose
    sums are the bucket layout's."""
    _, bundle = _bundle(8, drop=((2,), (1,)))
    solver, p = _solver(bundle, 8, 0.002)
    nu, ni = bundle["n_users"], bundle["n_items"]
    state = harness.job_state(nu, ni, 8, SEED, 0, "cpu")
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    solver.epoch(state, p.learn_rate)
    prof.stop()
    rec = tprof.records()
    chunks = len(solver._stage[0]) + len(solver._stage[1])
    names = [s.name for s in rec["spans"]]
    assert names.count("als.epoch") == 1
    assert names.count("als.gram") == names.count("als.solve") == chunks
    assert {s.parent for s in rec["spans"] if s.name != "als.epoch"} == \
        {"als.epoch"}
    buckets = solver.u_buckets + solver.i_buckets
    assert rec["counts"] == {
        "als.rows": (nu - 1) + (ni - 1),
        "als.slots": sum(b.mask.size for b in buckets),
        "als.ratings": int(sum(b.mask.sum() for b in buckets))}
    assert rec["counts"]["als.ratings"] == 2 * bundle["train"][0].numel()


def test_the_als_config_makes_the_ratings_of_ml20m_mf_k64():
    """The cell's configuration is ALS's own entry, with a source of its
    own, over the very ratings of ``ml20m-mf-k64``: every number and the
    generator's assumptions are the same, so a seed makes the same data."""
    spec = json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())
    entries = {c["name"]: c for c in spec["configs"]}
    cell = {w["name"]: w for w in spec["workloads"]}[CELL]
    assert cell["config"] == CONFIG
    als, sgd = entries[CONFIG], entries["ml20m-mf-k64"]
    assert als["source"] != sgd["source"] and als["reduced"] == []
    assert als["file"] == f"benchmark/configs/{CONFIG}.json"
    read = lambda e: json.loads((_tiny.ROOT / e["file"]).read_text())
    a, b = read(als), read(sgd)
    numbers = lambda d: {k: v for k, v in d.items()
                         if isinstance(v, (int, float))}
    assert numbers(a) == numbers(b)
    assert (a["generator"], a["algo"]) == (b["generator"], b["algo"])
    for key in ("truth_rank", "truth_scale", "nonneg", "noise",
                "item_power_law", "test_share", "val_share"):
        assert a["assumed"][key] == b["assumed"][key], key
    cut = dict(n_users=300, n_items=120, n_ratings=6000)
    make = harness.load_file(harness.BENCH / "data" /
                             f"{a['generator']}.py").make
    x = make(dict(a, **cut), SEED, "cpu")
    y = make(dict(b, **cut), SEED, "cpu")
    for split in ("train", "val", "test"):
        for p, q in zip(x[split], y[split]):
            assert torch.equal(p, q), split


def test_auto_picks_als_at_the_cell_shape():
    """The cell names ``als``; ``auto`` resolves plain MF to it at the
    cell's shape, on one device and under a mesh."""
    cfg = json.loads((_tiny.ROOT / "benchmark" / "configs" /
                      f"{CONFIG}.json").read_text())
    vals = np.arange(1, 11, dtype=np.float32) * 0.5
    data = SimpleNamespace(
        n_users=cfg["n_users"], n_items=cfg["n_items"],
        train_mat=SimpleNamespace(values=np.tile(vals, 1000),
                                  nnz=17_000_000))
    assert _auto_method(cfg["algo"], data, Params(fac_dim=64)) == "als"
    assert _auto_method(cfg["algo"], data, Params(fac_dim=64),
                        mesh=object()) == "als"
    tr = json.loads((_tiny.ROOT / "benchmark" / "traffic" /
                     "train-als.json").read_text())
    assert tr["mf_method"] == "als"
