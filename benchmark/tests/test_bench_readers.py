"""Each metric reader on a canned record: a profiled sub-window's
``key_averages()`` table as the harness reduces it, and the host-clock
figures of a window."""

import json

import pytest

from benchmark import harness


def read(name, rec):
    return harness.load_file(harness.BENCH / "metrics" / f"{name}.py"
                             ).read(rec)


def op(name, device_total_us=0.0, self_device_us=0.0, on_device=False,
       count=1):
    return dict(name=name, count=count, on_device=on_device,
                device_total_us=device_total_us,
                self_device_us=self_device_us)


PROF_TRAIN = dict(
    epochs=2, wall_s=0.5, busy_s=0.4,
    ops=[op("aten::index_put_", device_total_us=60_000.0),
         op("aten::_index_put_impl_", device_total_us=60_000.0),
         op("void (anonymous namespace)::panel_kernel<signed char>(...)",
            self_device_us=20_000.0, on_device=True),
         op("void step_kernel(Tabs, int2 const*, float)",
            self_device_us=10_000.0, on_device=True),
         op("u_bf16_kernel", self_device_us=2_000.0, on_device=True),
         op("Memcpy HtoD (Pageable -> Device)", self_device_us=500.0,
            on_device=True)])


def train_record(unit):
    return dict(setup_s=12.5, unit=unit, units_per_epoch=1_000_000,
                epochs=40, window_s=2.0, enqueue_s=[0.01, 0.03],
                check_s=[("objective", 0.004), ("rmse", 0.002),
                         ("objective", 0.006), ("rmse", 0.002)],
                least_epoch_s=1e-4, prof=PROF_TRAIN)


def serve_record():
    return dict(setup_s=7.0, window_s=4.0, latencies_s=[0.001] * 19 +
                [0.011], service_s=[0.001] * 18 + [0.0015, 0.0025],
                requests=20, users=2000, least_s=2e-5, request_wall_s=0.022,
                prof=dict(wall_s=0.1, busy_s=0.02, requests=10, users=900,
                          least_s=1e-5,
                          ops=[op("topk_fused_kernel", self_device_us=500.0,
                                  on_device=True),
                               op("topk_merge_kernel", self_device_us=100.0,
                                  on_device=True)]))


def test_training_readers():
    r = train_record("ratings")
    assert read("setup_s", r) == 12.5
    assert read("train_ratings_per_s", r) == pytest.approx(2e7)
    assert read("eval_ms.rmse", r) == pytest.approx(7.0)
    assert read("enqueue_ms.ratings", r) == pytest.approx(20.0)
    # only the outer index_put_ counts, per profiled epoch
    assert read("scatter_ms.sgd", r) == pytest.approx(30.0)
    # the scatter engine's cell reads the same under names of its own
    for a, b in (("sgd_ratings_per_s", "train_ratings_per_s"),
                 ("eval_ms.sgd", "eval_ms.rmse"),
                 ("enqueue_ms.sgd", "enqueue_ms.ratings"),
                 ("mfu.sgd", "mfu.ratings"),
                 ("idle_share.sgd", "idle_share.ratings")):
        assert read(a, r) == read(b, r)
    assert read("mfu.ratings", r) == pytest.approx(100 * 1e-4 * 40 / 2.0)
    assert read("idle_share.ratings", r) == pytest.approx(20.0)
    # 2 epochs of least time over the stripe kernels' 32 ms
    assert read("stripe_codes_roofline", r) == pytest.approx(
        100 * 2e-4 / 0.032)


def test_pairs_readers():
    r = train_record("pairs")
    r["check_s"] = [("hr10", 0.008), ("hr10", 0.012)]
    # the BPR cell reads the same formulas under names of its own
    for a, b in (("train_pairs_per_s", "train_ratings_per_s"),
                 ("eval_ms.hr10", "eval_ms.rmse"),
                 ("enqueue_ms.pairs", "enqueue_ms.ratings"),
                 ("scatter_ms.pairs", "scatter_ms.sgd"),
                 ("mfu.pairs", "mfu.ratings"),
                 ("idle_share.pairs", "idle_share.ratings")):
        assert read(a, r) == read(b, r)
    assert read("train_pairs_per_s", r) == pytest.approx(2e7)
    assert read("eval_ms.hr10", r) == pytest.approx(10.0)
    assert read("scatter_ms.pairs", r) == pytest.approx(30.0)
    assert read("idle_share.pairs", r) == pytest.approx(20.0)


def test_serving_readers():
    r = serve_record()
    assert read("topn_p95_ms", r) == pytest.approx(1.5)
    assert read("topn_users_per_s", r) == pytest.approx(500.0)
    # service 1.1 ms a request, device 2 ms a profiled request
    assert read("host_ms.serve", r) == pytest.approx(1.1 - 2.0)
    # waits: (20 * 1.5 - 22) ms over 20 requests
    assert read("queue_ms.serve", r) == pytest.approx(0.4)
    assert read("mfu.serve", r) == pytest.approx(100 * 2e-5 / 0.022)
    assert read("idle_share.serve", r) == pytest.approx(80.0)
    assert read("topk_fused_roofline", r) == pytest.approx(
        100 * 1e-5 / 6e-4)
    for a, b in (("host_ms.batch", "host_ms.serve"),
                 ("idle_share.batch", "idle_share.serve")):
        assert read(a, r) == read(b, r)


def test_nothing_to_read_gives_none():
    """No profile (a CPU run) or no kernel of the name: left out, never 0."""
    r = train_record("ratings")
    del r["prof"]
    for name in ("scatter_ms.sgd", "idle_share.ratings",
                 "stripe_codes_roofline"):
        assert read(name, r) is None
    r = train_record("ratings")
    r["prof"] = dict(PROF_TRAIN, busy_s=0.0, ops=[op("aten::add_")])
    for name in ("scatter_ms.sgd", "idle_share.ratings",
                 "stripe_codes_roofline"):
        assert read(name, r) is None
    s = serve_record()
    s["prof"]["ops"] = []
    assert read("topk_fused_roofline", s) is None


def test_every_metric_has_a_reader():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_summarize_profile_on_the_cpu():
    """The reduction of a real profile: host ops only on the CPU."""
    import torch
    prof = harness.start_profile()
    with torch.profiler.record_function("bench.epoch"):
        torch.ones(100).add_(1)
    prof.stop()
    s = harness.summarize_profile(prof, 0.1)
    assert s["busy_s"] == 0.0 and s["wall_s"] == 0.1
    assert any(o["name"] == "aten::add_" for o in s["ops"])
    assert s["breakdown"] == dict(device_ops=[], idle_gaps=[])
