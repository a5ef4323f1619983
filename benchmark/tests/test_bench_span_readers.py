"""The readers of the program's own spans and counters
(``benchmark/program_spans.py``): each formula on a hand-made
``records()``, its aliases, nothing to read where the program kept
nothing or has no ``records``, and a traced run of every cell on the CPU
at a tiny size that reports them."""

import json

import pytest

from benchmark import harness, program_spans
from benchmark.tests import _tiny

US = 1_000    # ns


def reader(name):
    return harness.load_file(harness.BENCH / "metrics" / f"{name}.py")


def span(name, t0_us, t1_us, parent=None, req=None):
    return (name, parent, t0_us * US, t1_us * US, req)


# two profiled epochs of 10 ms: sgd's, with three scatters, a sync each
TRAIN = dict(spans=[
    span("scatter.ordered", 0, 1500, "sgd.epoch"),
    span("scatter.ordered", 2000, 2500, "sgd.epoch"),
    span("sgd.epoch", 0, 10_000),
    span("loop.sync", 10_000, 13_000),
    span("scatter.ordered", 13_000, 14_000, "sgd.epoch"),
    span("sgd.epoch", 13_000, 23_000),
    span("loop.sync", 23_000, 24_000),
    span("loop.check", 24_000, 30_000)], counts={})

# three BPR epochs, sampler draws of 2 ms and 0 ms in each, 1 ms more in
# the last
PAIRS = dict(spans=[s for e in range(3) for s in (
    span("bpr.sample", 10_000 * e, 10_000 * e + 2000, "bpr.epoch"),
    span("bpr.sample", 10_000 * e + 3000,
         10_000 * e + (4000 if e == 2 else 3000), "bpr.epoch"),
    span("bpr.epoch", 10_000 * e, 10_000 * e + 8000),
    span("loop.sync", 10_000 * e + 8000, 10_000 * e + 10_000))], counts={})

# two requests: waits of 100 + 50 + 200 us and 300 + 50 + 100 us
SERVE = dict(spans=[s for r, w in ((1000, (100, 50, 200)),
                                   (2000, (300, 50, 100))) for s in (
    span("serve.ids_in", r, r + w[0], "serve.request", r),
    span("topk.check_ids", r + 400, r + 400 + w[1], "serve.request", r),
    span("topk.launch", r + 500, r + 600, "serve.request", r),
    span("serve.answers_out", r + 600, r + 600 + w[2], "serve.request", r),
    span("serve.request", r, r + 900, None, r))],
    counts={"card_syncs": 8})

FORMULAS = [
    ("sync_ms.ratings", TRAIN, (3.0 + 1.0) / 2),
    ("scatter_host_ms.sgd", TRAIN, (1.5 + 0.5 + 1.0) / 2),
    ("sample_ms.pairs", PAIRS, (2 + 0 + 2 + 0 + 2 + 1) / 3),
    ("syncs.serve", SERVE, 4.0),
    ("card_wait_ms.serve", SERVE, (0.35 + 0.45) / 2),
]
ALIASES = {"sync_ms.sgd": "sync_ms.ratings", "sync_ms.pairs":
           "sync_ms.ratings", "scatter_host_ms.pairs": "scatter_host_ms.sgd",
           "syncs.batch": "syncs.serve",
           "card_wait_ms.batch": "card_wait_ms.serve"}
NEW = [f for f, _, _ in FORMULAS] + list(ALIASES)


@pytest.mark.parametrize("name,recs,want", FORMULAS,
                         ids=[f for f, _, _ in FORMULAS])
def test_each_formula_on_hand_made_records(name, recs, want, monkeypatch):
    assert reader(name).of(recs) == pytest.approx(want)
    from matfac_tpu_torch.train import profiler
    monkeypatch.setattr(profiler, "records", lambda: recs)
    assert reader(name).read({}) == pytest.approx(want)
    for alias, of in ALIASES.items():
        if of == name:
            assert reader(alias).read({}) == pytest.approx(want)


@pytest.mark.parametrize("name", [f for f, _, _ in FORMULAS])
def test_nothing_recorded_reads_none(name, monkeypatch):
    of = reader(name).of
    assert of(None) is None
    assert of(dict(spans=[], counts={})) is None
    # the spans of another cell: nothing of this formula's
    other = SERVE if name in ("sync_ms.ratings", "scatter_host_ms.sgd",
                              "sample_ms.pairs") else TRAIN
    assert of(other) is None
    from matfac_tpu_torch.train import profiler
    monkeypatch.setattr(profiler, "records",
                        lambda: dict(spans=[], counts={}))
    assert reader(name).read({}) is None
    # a program older than its spans has no records()
    monkeypatch.delattr(profiler, "records")
    assert program_spans.program_records() is None
    assert reader(name).read({}) is None


def test_entries_name_their_cells():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    mine = {m["name"]: m for m in spec["per_layer"] if m["name"] in NEW}
    assert sorted(mine) == sorted(NEW)
    ends = {m["name"]: set(m.get("workloads", ())) for m in
            spec["end_to_end"]}
    for m in mine.values():
        assert m["source"] == "host_clock"
        assert set(m["workloads"]) <= ends[m["moves"]]


CELL_METRICS = {
    "ml20m-mf-densesgd": ["sync_ms.ratings"],
    "ml20m-mf-sgd": ["sync_ms.sgd", "scatter_host_ms.sgd"],
    "ml10m-bpr-train": ["sync_ms.pairs", "scatter_host_ms.pairs",
                        "sample_ms.pairs"],
    "ml10m-bpr-serve-1user": ["syncs.serve", "card_wait_ms.serve"],
    "ml10m-bpr-serve-256users": ["syncs.batch", "card_wait_ms.batch"],
}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny.tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", list(CELL_METRICS))
def test_a_traced_run_reports_the_programs_spans(tiny, cell):
    rc, out, err = _tiny.run(tiny, ["--workload", cell, "--seed",
                                    "3000000029", "--seconds", "0.5",
                                    "--trace", "1"])
    assert rc == 0, err[-3000:]
    res = _tiny.result(out)
    assert res["correct"] is True, res
    got = {n: v["value"] for n, v in res["metrics"].items() if n in NEW}
    assert sorted(got) == sorted(CELL_METRICS[cell])
    assert all(v > 0 for v in got.values())
    for n in ("syncs.serve", "syncs.batch"):
        if n in got:
            assert got[n] == 4.0
