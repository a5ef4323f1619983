"""The harness runs each cell end to end on the CPU at a tiny size, finds
a cell that a copy adds as files alone, and refuses to run without a
card or without the program."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests import _tiny

CELLS = ["ml20m-mf-densesgd", "ml10m-bpr-serve-1user",
         "ml10m-bpr-serve-256users", "ml20m-mf-sgd", "ml10m-bpr-train"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny.tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny, cell, trace):
    rc, out, err = _tiny.run(tiny, ["--workload", cell, "--seed",
                                    "3000000019", "--seconds", "0.5",
                                    "--trace", str(trace)])
    assert rc == 0, err[-3000:]
    res = _tiny.result(out)
    assert res["correct"] is True, res
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    want = [m["name"] for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        # every end-to-end metric of the cell is read, also on the CPU
        assert sorted(res["metrics"]) == sorted(want)
    else:
        # device metrics are left out without a card; host ones stay
        assert "busy_s" in res["device"] and "breakdown" in res
    for name, c in res["checks"].items():
        assert f"check {name} " in err


def test_added_cell_found_as_files(tiny):
    """A cell added by new files and BENCHMARK.json entries alone."""
    b = tiny / "benchmark"
    cfg = json.loads((b / "configs" / "ml20m-mf-k64.json").read_text())
    cfg.update(name="tiny-mf", n_users=400, n_items=250, n_ratings=9000)
    (b / "configs" / "tiny-mf.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "train-sgd.json").read_text())
    tr.update(learn_rate=0.01, epochs_per_job=4, batch_size=512)
    (b / "traffic" / "tiny-sgd.json").write_text(json.dumps(tr))
    (b / "limits" / "tiny-added.json").write_text(
        (b / "limits" / "ml20m-mf-sgd.json").read_text())
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny-mf",
                                file="benchmark/configs/tiny-mf.json"))
    spec["workloads"].append(dict(name="tiny-added", config="tiny-mf",
                                  traffic="tiny-sgd", chips=1, why="test"))
    for m in spec["end_to_end"]:
        if m["name"] == "train_ratings_per_s":
            m["workloads"].append("tiny-added")
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, out, err = _tiny.run(tiny, ["--workload", "tiny-added", "--seed",
                                    "5", "--seconds", "0.5"])
    assert rc == 0, err[-3000:]
    res = _tiny.result(out)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"train_ratings_per_s", "setup_s"}


def test_no_card_no_result(tmp_path):
    """Without a card the run exits 2 and prints nothing on stdout."""
    tiny = _tiny.tiny_copy(tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=tiny, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(_tiny.ROOT)),
                       timeout=300)
    assert p.returncode == 2 and p.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone: no result."""
    tiny = _tiny.tiny_copy(tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=tiny, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=""), timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_unknown_cell(tiny):
    rc, out, err = _tiny.run(tiny, ["--workload", "nope", "--seed", "1",
                                    "--seconds", "1"])
    assert rc == 2 and out == "" and "nope" in err


def test_sweep_of_a_serving_cell(tiny):
    """The sweep that fixes an open-loop cell's rate: a closed-loop window,
    then one a load, each with its tail."""
    rc, out, err = _tiny.run(tiny, ["--workload", CELLS[1], "--seed", "9",
                                    "--seconds", "0.3", "--loads", "0.3",
                                    "0.6"], module="sweep")
    assert rc == 0, err[-3000:]
    rows = [json.loads(line) for line in out.strip().splitlines()]
    assert [r["load"] for r in rows] == [None, 0.3, 0.6]
    assert rows[1]["offered_per_s"] == pytest.approx(
        0.3 * rows[0]["answered_per_s"])
    assert all(r["p95_ms"] >= r["p50_ms"] > 0 for r in rows)
