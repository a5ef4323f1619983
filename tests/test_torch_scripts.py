"""The port's multi-device scripts and its two examples run with ``--cpu``
at a small size, each in a fresh interpreter, and print their result
lines (the card's runs are in chip_smoke.py's phase (y) and PERF.md)."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--n-users", "1200", "--n-items", "300", "--density", "0.05"]


@pytest.mark.parametrize("script,args,want", [
    ("scripts/torch_scaling_curve.py",
     ["--phase-split", "--shards", "1", "2", "--n-users", "1024",
      "--n-items", "512", "--nnz", "20000", "--k", "8", "--epochs", "1"],
     ["| densedsgd | 2 |", "comm frac"]),
    ("scripts/torch_block_dsgd.py", SMALL, ["blockDSGD N=1 sub384 bs512"]),
    ("scripts/torch_dense_bdsgd.py", SMALL, ["dense block-DSGD N=1:"]),
    ("scripts/torch_longtail_dsgd.py", SMALL,
     ["blocksgd TMF:", "DSGD N=1:"]),
    ("examples/torch_multichip_dsgd.py", ["--shards", "4"],
     ["epoch 11: train RMSE"]),
    ("examples/torch_train_eval_serve.py", [], ["user 2: top-5 items"]),
])
def test_runs_on_the_cpu(script, args, want):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(ROOT / script), "--cpu",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in want:
        assert line in proc.stdout, proc.stdout[-3000:]
