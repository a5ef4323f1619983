"""The stream-BPR engine's fused batch's readers: ``bpr_step_share.pairs``
(the program's ``bpr.step`` counter over its ``bpr.batches`` counter) and
``bpr_step_kernel_ms.pairs`` (the gradient kernel's device time, by its
name), on hand-made records, nothing to read where the program kept
nothing (the parent: no such counter), and traced runs of the BPR cell on
the CPU at a tiny size: the plain batch counts no kernel call (0.0), and
with the kernel route's counting planted the share reads 1.0."""

import json

import pytest

from benchmark import harness
from benchmark.tests import _tiny

SHARE, KERNEL_MS = "bpr_step_share.pairs", "bpr_step_kernel_ms.pairs"


def reader(name):
    return harness.load_file(harness.BENCH / "metrics" / f"{name}.py")


def span(name, parent="bpr.epoch"):
    return (name, parent, 0, 1000, None)


def test_share_of_kernel_steps(monkeypatch):
    from matfac_tpu_torch.train import profiler
    for counts, want in (({"bpr.step": 4, "bpr.batches": 4}, 1.0),
                         ({"bpr.step": 1, "bpr.batches": 4}, 0.25),
                         ({"bpr.batches": 4}, 0.0)):
        monkeypatch.setattr(profiler, "records", lambda: dict(
            spans=[span("bpr.step")] * 4 + [span("bpr.epoch", None)],
            counts=counts))
        assert reader(SHARE).read({}) == pytest.approx(want)
    # the parent: the sampler's spans and the scatter's counter, no batches
    monkeypatch.setattr(profiler, "records", lambda: dict(
        spans=[span("bpr.sample"), span("scatter.ordered")],
        counts={"scatter.staged": 2}))
    assert reader(SHARE).read({}) is None
    monkeypatch.delattr(profiler, "records")
    assert reader(SHARE).read({}) is None


def op(name, us, on_device=True):
    return dict(name=name, count=1, on_device=on_device,
                device_total_us=us, self_device_us=us)


def test_kernel_ms_an_epoch():
    prof = dict(epochs=3, ops=[
        op("void (anonymous namespace)::bpr_grad_kernel<float, 4, 1>"
           "(BprArgs, (anonymous namespace)::Batch)", 6000.0),
        op("void (anonymous namespace)::bpr_grad_kernel<__nv_bfloat16, 8, "
           "1>(BprArgs, (anonymous namespace)::Batch)", 3000.0),
        op("void (anonymous namespace)::bpr_sample_kernel(BprArgs, long "
           "long, long long)", 500.0),
        op("void (anonymous namespace)::ordered_scatter_kernel<float, int, "
           "4>(float*, ...)", 2000.0),
        op("aten::exp", 5000.0, on_device=False)])
    assert reader(KERNEL_MS).read(dict(prof=prof)) == pytest.approx(3.0)
    # the parent: the eager chain and the scatter, no gradient kernel
    prof["ops"] = prof["ops"][2:]
    assert reader(KERNEL_MS).read(dict(prof=prof)) is None
    assert reader(KERNEL_MS).read({}) is None


def test_entries_name_their_cell():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    mine = {m["name"]: m for m in spec["per_layer"]
            if m["name"] in (SHARE, KERNEL_MS)}
    assert sorted(mine) == sorted((SHARE, KERNEL_MS))
    for m in mine.values():
        assert m["workloads"] == ["ml10m-bpr-train"]
        assert m["layer"] == "solvers"
        assert m["moves"] == "train_pairs_per_s"


# the kernel route's count, planted on the CPU's plain steps
COUNTED = """
from matfac_tpu_torch.ops import bpr_step
from matfac_tpu_torch.train.profiler import count
real = bpr_step.BPRStep.epoch
def epoch(self, *a):
    sample, step = real(self, *a)
    def counted(*b):
        count("bpr.step")
        return step(*b)
    return sample, counted
bpr_step.BPRStep.epoch = epoch
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny.tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("patch,want", [("", 0.0), (COUNTED, 1.0)])
def test_a_traced_run_reports_the_share(tiny, patch, want):
    rc, out, err = _tiny.run(tiny, ["--workload", "ml10m-bpr-train",
                                    "--seed", "3000000019", "--seconds",
                                    "0.5", "--trace", "1"], patch)
    assert rc == 0, err[-3000:]
    res = _tiny.result(out)
    assert res["correct"] is True, res
    assert res["metrics"].get(SHARE, {}).get("value") == want
    # no card on the CPU: the kernel's reader finds nothing
    assert KERNEL_MS not in res["metrics"]
