"""The readings that a cell's limits are set from (PERF.md section 2), on
the card at the cell's own size:

* ``program``: the program's numbers against the reference, a run of the
  cell on each seed (a window of ``--seconds``; a training window closes
  once job 0 has run its checked epochs);
* ``control``, on the first ``--controls`` seeds: the same numbers of the
  nearest lower precision: the program's own bf16 factor tables where
  its engine trains them (the scatter engines), else the reference
  computed in bf16 (the stripe engine, which keeps f32 tables whatever
  it is handed); for serving, whose f32 scores are a product with TF32
  off, the reference on TF32 (and ``control_bf16``, in bf16);
* the faults, on the same seeds: ``half_batch`` (the reference with half
  of each batch or stripe left out, the mean over the rest) and
  ``unchanged`` (job 0's tables returned as they were) for a training
  cell; ``altered`` (one served id replaced by the next item) for a
  serving cell.

    python benchmark/calibrate.py --workload <name> --seeds <n> ... \\
        [--controls 3] [--seconds 20] [--out chiprun_out/calib]

Prints one JSON line a reading, and writes them to
``<out>/<workload>.jsonl``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def training_readings(cell, driver, out, seed, device):
    ref = cell.module("reference", cell.traffic["reference"])
    hp, inp = driver.hyper(cell), out["inputs"]
    epochs = cell.traffic["checked_epochs"]
    hr = cell.traffic["driver"] == "train_bpr"
    check = lambda port: harness.training_checks(port, out["ref"],
                                                 inp["u0"], inp["i0"], hr)
    if cell.traffic["mf_method"] == "densesgd":
        yield "control", check(ref.follow(inp, hp, epochs,
                                          dtype=torch.bfloat16))
    else:
        yield "control", driver.run(cell, seed, 0.0, False, device,
                                    time.perf_counter(),
                                    dtype=torch.bfloat16)["checks"]
    yield "half_batch", check(ref.follow(inp, hp, epochs,
                                         fault="half_batch"))
    # every epoch returns the first tables: the checks repeat the first
    same = dict(states=[(inp["u0"], inp["i0"])] * epochs,
                checks={k: [v[0]] * len(v) for k, v in
                        out["ref"]["checks"].items()},
                losses=[out["ref"]["losses"][0]] * epochs
                if "losses" in out["ref"] else [])
    yield "unchanged", check(same)


def serving_readings(cell, driver, out, seed, device):
    ref = cell.module("reference", cell.traffic["reference"])
    n, inp, kept = cell.traffic["n"], out["inputs"], out["kept"]
    users = np.concatenate([r for r, _, _ in kept])
    for kind, kw in (("control", dict(tf32=True)),
                     ("control_bf16", dict(dtype=torch.bfloat16))):
        sc, ids = ref.serve(inp, torch.from_numpy(users).to(device), n, **kw)
        yield kind, driver.serve_checks(
            ref, inp, [(users, ids.cpu().numpy(), sc.cpu().numpy())], n,
            device)
    req, ids, sc = kept[0]
    ids = ids.copy()
    ids[0, 0] = (ids[0, 0] + 1) % inp["n_items"]
    yield "altered", driver.serve_checks(ref, inp, [(req, ids, sc)] +
                                         kept[1:], n, device)


def main(argv=None, device=None) -> int:
    """``device`` None claims the card; the tests pass "cpu"."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "calib"))
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if device is None:
        device = harness.claim_device(cell.chips)
    driver = cell.module("drivers", cell.traffic["driver"])
    readings = (serving_readings if cell.traffic["driver"] == "serve_topn"
                else training_readings)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.jsonl"), "a") as f:
        def emit(seed, kind, checks):
            row = dict(workload=args.workload, seed=seed, kind=kind,
                       **{k: harness.finite_or_none(v)
                          for k, v in checks.items()})
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
        for i, seed in enumerate(args.seeds):
            out = driver.run(cell, seed, args.seconds, False, device,
                             time.perf_counter())
            emit(seed, "program", out["checks"])
            if i < args.controls:
                for kind, checks in readings(cell, driver, out, seed,
                                             device):
                    emit(seed, kind, checks)
            del out
            harness.free_device(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
