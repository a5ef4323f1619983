"""The control of each cell comes out not correct: the nearest lower
precision (benchmark/calibrate.py), judged by the cell's limits, and so
do the planted faults, while the program's own run is correct.

On the card (``cuda``) at the cell's own size, one seed a cell: the
controls as the limits were set from (TF32 scoring for serving). On the
CPU at the tiny size: the bf16 controls (TF32 means nothing there)."""

import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests import _tiny

CELLS = ["ml20m-mf-densesgd", "ml10m-bpr-serve-1user",
         "ml10m-bpr-serve-256users", "ml20m-mf-sgd", "ml10m-bpr-train"]


HELPERS = """
def readings(workload, seed, device, seconds):
    cell = harness.load_cell(workload)
    driver = cell.module("drivers", cell.traffic["driver"])
    out = driver.run(cell, seed, seconds, False, device,
                     __import__("time").perf_counter())
    gen = (calibrate.serving_readings if cell.traffic["driver"] ==
           "serve_topn" else calibrate.training_readings)
    return cell, out, dict(gen(cell, driver, out, seed, device))


def judge_all(cell, out, got, controls):
    assert harness.judge(out["checks"], cell.limits)[0], out["checks"]
    for kind, checks in got.items():
        if kind in controls or not kind.startswith("control"):
            assert not harness.judge(checks, cell.limits)[0], (kind, checks)
"""
exec(HELPERS)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the controls are read at the "
                    "cell's own size on the card")
    device = harness.claim_device(1)
    cell, out, got = readings(workload, 3000999001, device, 5.0)
    judge_all(cell, out, got, ("control",))


CPU_SCRIPT = HELPERS + """
cell, out, got = readings(sys.argv[1], 3000999001, "cpu", 0.3)
if cell.traffic["driver"] == "serve_topn":
    judge_all(cell, out, got, ("control_bf16",))
else:
    judge_all(cell, out, got, ("control",))
"""


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_tiny_size(tmp_path, workload):
    tiny = _tiny.tiny_copy(tmp_path)
    code = (f"import sys\nsys.path[:0] = [{str(tiny)!r}, "
            f"{str(_tiny.ROOT)!r}]\nsys.argv = ['x', {workload!r}]\n"
            "from benchmark import calibrate, harness\n" + CPU_SCRIPT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tiny)
    assert p.returncode == 0, p.stderr[-3000:]
