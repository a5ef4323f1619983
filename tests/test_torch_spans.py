"""The port's spans and counters (matfac_tpu_torch.train.profiler):
free when no profiler records, kept on the host clock and in the
profiler's event list when one does, at the layer boundaries of the
training loops, the solvers' epochs, the ordered scatter, the BPR sampler
and a serving request. CPU only: a CPU ``torch.profiler`` drives them."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.synthetic import leave_one_out_data, \
    synthetic_data
from matfac_tpu_torch.models.base import EvalView
from matfac_tpu_torch.serving import Recommender
from matfac_tpu_torch.train import profiler as tprof
from matfac_tpu_torch.train.loop import train_model

EPOCHS = 3
SOLVER_EPOCH = {"sgd": "sgd.epoch", "densesgd": "stripes.epoch",
                "bpr": "bpr.epoch"}


@pytest.fixture(autouse=True)
def _clean():
    tprof.reset()
    yield
    tprof.reset()


def quiet(_):
    pass


def _recorder():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    return prof


def _train(method: str, max_iter: int = EPOCHS):
    """(report, solver) of a tiny run of ``method`` on the CPU; "bpr" is
    the stream BPR engine, the others plain MF."""
    if method == "bpr":
        data = leave_one_out_data(n_users=40, n_items=30, per_user=8,
                                  seed=5, structured=True)
        p = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.1,
                   max_iter=max_iter, seed=2, batch_size=64, obj_iter=2,
                   disp_iter=1000, save_iter=1000)
        rep, *_ = train_model(data, p, algo="bpr", device="cpu",
                              log_fn=quiet)
    else:
        data, _, _ = synthetic_data(n_users=48, n_items=36, k=3,
                                    density=0.3, seed=4)
        p = Params(fac_dim=4, u_reg=0.01, i_reg=0.01, learn_rate=0.01,
                   max_iter=max_iter, seed=2, batch_size=64, obj_iter=2,
                   disp_iter=1000, save_iter=1000)
        rep, *_ = train_model(data, p, algo="mf", mf_method=method,
                              device="cpu", log_fn=quiet)
    return rep, rep.solver


def _recommender():
    data = leave_one_out_data(n_users=30, n_items=25, per_user=6, seed=7)
    g = torch.Generator().manual_seed(0)
    view = EvalView(torch.randn(30, 4, generator=g),
                    torch.randn(25, 4, generator=g), torch.zeros(30),
                    torch.zeros(25), torch.zeros(()))
    return Recommender(view, data.train_mat, 30, 25)


def _names(spans):
    return [s.name for s in spans]


def test_no_recording_enters_no_annotation_and_reads_no_clock(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("traced with no profiler recording")
    monkeypatch.setattr(tprof, "record_function", refuse)
    monkeypatch.setattr(tprof, "_clock", refuse)
    _train("sgd", max_iter=2)
    _recommender().recommend([0, 3, 7], n=5)
    tprof.count("card_syncs", 2)
    assert tprof.records() == dict(spans=[], counts={})
    assert tprof.span("a") is tprof.span("b") is tprof.request("c")


def test_spans_nest_and_a_request_shares_its_number():
    rec = _recommender()
    prof = _recorder()
    for users in ([1, 2], [5]):
        rec.recommend(users, n=4)
    prof.stop()
    spans = tprof.records()["spans"]
    roots = [s for s in spans if s.name == "serve.request"]
    assert len(roots) == 2 and all(s.parent is None for s in roots)
    assert roots[0].req != roots[1].req
    for root in roots:
        kids = [s for s in spans if s.req == root.req and s is not root]
        assert sorted(_names(kids)) == ["serve.answers_out",
                                        "serve.ids_in", "topk.check_ids"]
        for s in kids:
            assert s.parent == "serve.request"
            assert root.t0_ns <= s.t0_ns <= s.t1_ns <= root.t1_ns
    shown = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    assert {"serve.request", "serve.ids_in", "topk.check_ids",
            "serve.answers_out"} <= shown


@pytest.mark.parametrize("straddles", ["start", "stop"])
def test_a_span_that_straddles_start_or_stop_is_dropped(straddles):
    prof = None if straddles == "start" else _recorder()
    with tprof.span("straddler"):
        if prof is None:
            prof = _recorder()
        else:
            prof.stop()
        with tprof.span("inside"):
            pass
    if straddles == "start":
        with tprof.span("after"):
            pass
        prof.stop()
    names = _names(tprof.records()["spans"])
    assert "straddler" not in names
    assert names == (["inside", "after"] if straddles == "start" else [])


def test_a_span_whose_body_raises_is_closed():
    prof = _recorder()
    with pytest.raises(ValueError):
        with tprof.span("outer"):
            with tprof.span("inner"):
                raise ValueError("body")
    with tprof.span("next"):
        pass
    prof.stop()
    spans = tprof.records()["spans"]
    assert [(s.name, s.parent) for s in spans] == [
        ("inner", "outer"), ("outer", None), ("next", None)]
    assert {"outer", "inner", "next"} <= {e.name for e in prof.events()}


@pytest.mark.parametrize("method", ["sgd", "densesgd", "bpr"])
def test_a_training_loop_records_each_epoch(method, monkeypatch):
    """Under the profiler: one solver-epoch span and one ``loop.sync`` an
    epoch; sgd's ``sgd.step`` a batch inside its epoch and, on the CPU,
    its two ordered scatters inside the step, its batches counted; BPR's sampler and three
    scatters a batch, the stripes' schedule and launch."""
    prof = _recorder()
    rep, solver = _train(method)
    prof.stop()
    spans = tprof.records()["spans"]
    names = _names(spans)
    epoch = SOLVER_EPOCH[method]
    assert names.count(epoch) == names.count("loop.sync") == EPOCHS
    assert names.count("loop.check") >= 2
    assert all(s.parent is None for s in spans
               if s.name in (epoch, "loop.sync", "loop.check"))
    n_scatter = names.count("scatter.ordered")
    if method == "sgd":
        assert n_scatter == 2 * solver.n_batches * EPOCHS
        assert names.count("sgd.step") == solver.n_batches * EPOCHS
        # the epochs' batches counted; the CPU's plain steps call no kernel
        counts = tprof.records()["counts"]
        assert counts.get("sgd.batches") == solver.n_batches * EPOCHS
        assert "sgd.step" not in counts
    elif method == "bpr":
        assert names.count("bpr.sample") == solver.n_batches * EPOCHS
        assert n_scatter == 2 * solver.n_batches * EPOCHS
    else:
        assert n_scatter == 0
        assert names.count("stripes.launch") == EPOCHS
        assert names.count("stripes.schedule") == EPOCHS
        assert "stripes.ranks" not in names      # plain MF draws no ranks
    for s in spans:
        if s.name in ("sgd.step", "bpr.sample", "stripes.launch",
                      "stripes.schedule"):
            assert s.parent == epoch
        if s.name == "scatter.ordered":
            assert s.parent == ("sgd.step" if method == "sgd" else epoch)


def test_a_request_counts_four_card_syncs():
    """Two reads of the ids' min and max, two copies of the answers."""
    rec = _recommender()
    rec.recommend([4], n=3)            # before the profiler: not counted
    prof = _recorder()
    rec.recommend([0, 9], n=3)
    prof.stop()
    assert tprof.records()["counts"] == {"card_syncs": 4}
    prof = _recorder()
    for u in range(3):
        rec.recommend([u], n=3)
    prof.stop()
    assert tprof.records()["counts"] == {"card_syncs": 16}
    tprof.reset()
    assert tprof.records() == dict(spans=[], counts={})
