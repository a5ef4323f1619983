"""The ordered scatter's readers: ``scatter_staged_share.*`` (the
program's ``scatter.staged`` counter over its ``scatter.ordered`` spans)
and ``scatter_kernel_ms.*`` (the kernel's device time, by its name), on
hand-made records, nothing to read where the program kept nothing, and a
traced run of the two training cells on the CPU at a tiny size that
reports the shares (sgd stages every call, stream BPR its user side)."""

import json

import pytest

from benchmark import harness
from benchmark.tests import _tiny

SHARES = ("scatter_staged_share.sgd", "scatter_staged_share.pairs")
KERNEL_MS = ("scatter_kernel_ms.sgd", "scatter_kernel_ms.pairs")


def reader(name):
    return harness.load_file(harness.BENCH / "metrics" / f"{name}.py")


def span(name):
    return (name, "sgd.epoch", 0, 1000, None)


def recs(staged, calls):
    return dict(spans=[span("scatter.ordered")] * calls
                + [span("sgd.epoch")], counts={"scatter.staged": staged})


@pytest.mark.parametrize("name", SHARES)
def test_share_of_staged_calls(name, monkeypatch):
    from matfac_tpu_torch.train import profiler
    for staged, calls, want in ((6, 6, 1.0), (3, 6, 0.5)):
        monkeypatch.setattr(profiler, "records",
                            lambda: recs(staged, calls))
        assert reader(name).read({}) == pytest.approx(want)
    # a program without the counter, or without records(): nothing
    monkeypatch.setattr(profiler, "records",
                        lambda: dict(spans=[span("scatter.ordered")],
                                     counts={}))
    assert reader(name).read({}) is None
    monkeypatch.delattr(profiler, "records")
    assert reader(name).read({}) is None


def op(name, us, on_device=True):
    return dict(name=name, count=1, on_device=on_device,
                device_total_us=us, self_device_us=us)


@pytest.mark.parametrize("name", KERNEL_MS)
def test_kernel_ms_an_epoch(name):
    prof = dict(epochs=2, ops=[
        op("void (anonymous namespace)::ordered_scatter_kernel<float, int, "
           "2>(float*, ...)", 3000.0),
        op("void (anonymous namespace)::ordered_scatter_kernel<float, long, "
           "2>(float*, ...)", 1000.0),
        op("aten::index_put_", 9000.0, on_device=False),
        op("void indexing_backward_kernel<float, 4>", 7000.0)])
    assert reader(name).read(dict(prof=prof)) == pytest.approx(2.0)
    # the parent: index_put_ alone, nothing of this kernel
    prof["ops"] = prof["ops"][2:]
    assert reader(name).read(dict(prof=prof)) is None
    assert reader(name).read({}) is None


def test_entries_name_their_cells():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    mine = {m["name"]: m for m in spec["per_layer"]
            if m["name"] in SHARES + KERNEL_MS}
    assert sorted(mine) == sorted(SHARES + KERNEL_MS)
    for name, m in mine.items():
        cell = "ml20m-mf-sgd" if name.endswith(".sgd") else "ml10m-bpr-train"
        assert m["workloads"] == [cell]
        assert m["layer"] == "ordered scatter"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny.tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,name,want", [
    ("ml20m-mf-sgd", "scatter_staged_share.sgd", 1.0),
    ("ml10m-bpr-train", "scatter_staged_share.pairs", 0.5)])
def test_a_traced_run_reports_the_staged_share(tiny, cell, name, want):
    rc, out, err = _tiny.run(tiny, ["--workload", cell, "--seed",
                                    "3000000019", "--seconds", "0.5",
                                    "--trace", "1"])
    assert rc == 0, err[-3000:]
    res = _tiny.result(out)
    assert res["correct"] is True, res
    assert res["metrics"][name]["value"] == want
    # no card on the CPU: the kernel's reader finds nothing
    assert not any(k.startswith("scatter_kernel_ms") for k in res["metrics"])
