"""The highest rate a serving cell sustains, and its tails below it, on
the card: the sweep that fixes an open-loop cell's ``rate_per_s``.

    python benchmark/sweep.py --workload <serving cell> --seed <n> \\
        [--seconds 10] [--loads 0.5 0.7 0.8 0.9 1.0] [--arrivals paced]

After the cell's set-up, one closed-loop window gives the capacity (the
requests over the window); then a window at each load (a share of that
capacity), with ``--arrivals``, else the cell's open-loop law (paced
for a closed-loop cell). The rate the system sustains is the highest
load whose p95 stays within 5 mean services in every seed swept (above
it, the host's stalls queue hundreds of requests and the tail swings
from run to run); an open-loop cell offers about four fifths of it. Prints one JSON line a window: the offered and
the answered rate and the latency's percentiles in ms.
"""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--loads", type=float, nargs="+",
                    default=[0.5, 0.7, 0.8, 0.9, 1.0])
    ap.add_argument("--arrivals", choices=("paced", "poisson"))
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if device is None:
        device = harness.claim_device(cell.chips)
    driver = cell.module("drivers", cell.traffic["driver"])
    s = driver.setup(cell, args.seed, device, T0)

    def emit(arrivals, load, w):
        lat = 1e3 * np.asarray(w["latencies_s"])
        row = dict(workload=args.workload, seed=args.seed, arrivals=arrivals,
                   load=load, offered_per_s=rate * load if load else None,
                   answered_per_s=w["requests"] / w["window_s"],
                   **{f"p{q}_ms": float(np.percentile(lat, q))
                      for q in (50, 95, 99)},
                   service_ms=1e3 * w["request_wall_s"] / w["requests"])
        print(json.dumps(row), flush=True)

    w = driver.window(s, args.seconds, None, keep=False)
    rate = w["requests"] / w["window_s"]
    emit("closed", None, w)
    arrivals = args.arrivals or {"closed": "paced"}.get(
        cell.traffic["arrivals"], cell.traffic["arrivals"])
    for load in args.loads:
        tr = dict(cell.traffic, arrivals=arrivals, rate_per_s=rate * load)
        gaps = driver.arrival_gaps(tr, args.seed + 3, len(s["pool"]))
        emit(arrivals, load, driver.window(s, args.seconds, gaps,
                                           keep=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
