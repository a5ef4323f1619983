"""Run one cell of the benchmark of matfac_tpu_torch once, on the card.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json ``workloads``) names its configuration and its
traffic mix; the traffic's driver makes the inputs on the card from
``--seed``, builds the program's path, warms it up (set-up), measures for
``--seconds``, then compares what the window produced with the plain
reference. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which also end standard error. Exits 2
without a result where the card or the cell is missing, and 3 where JAX
or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()   # the process's start, before torch is loaded

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT      # import the benchmark as a package
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None) -> int:
    """One run. ``device`` None claims the card; the tests pass "cpu" to
    drive the rest of a run without one."""
    args = parse(argv)
    from benchmark import harness
    try:
        cell = harness.load_cell(args.workload)
    except (KeyError, OSError) as e:
        harness.log(f"benchmark: {e}")
        return 2
    if device is None:
        device = harness.claim_device(cell.chips)
        harness.sync(device)
        harness.log(f"set-up: card ready at {time.perf_counter() - T0:.3f} s")
    driver = cell.module("drivers", cell.traffic["driver"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     device, T0)
    banned = harness.banned_loaded()
    if banned:
        harness.log(f"benchmark: loaded {', '.join(banned)}: the program "
                    "under test may not load JAX or the JAX package")
        return 3
    correct, checks = harness.judge(out["checks"], cell.limits)
    line = dict(correct=correct, attempted=out["attempted"],
                failed=out["failed"],
                metrics=harness.read_metrics(cell, out["record"],
                                             bool(args.trace)),
                device=out["device"])
    if args.trace:
        prof = out["record"]["prof"]
        line["device"].update(busy_s=prof["busy_s"], window_s=prof["wall_s"])
        line["breakdown"] = prof["breakdown"]
    line["checks"] = {n: dict(value=harness.finite_or_none(c["value"]),
                              limit=c["limit"]) for n, c in checks.items()}
    harness.log(f"card: {harness.power_limit()}; peaks "
                "989e12 FLOP/s bf16, 3.35e12 B/s (H100 SXM, 700 W)")
    for name, c in checks.items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
