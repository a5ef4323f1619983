"""The port's quality harness (scripts/torch_*.py) against the JAX
package's scripts: each runs at ``--maxiter 2 --cpu`` and prints the JAX
script's rows, the same lines in the same order with the numbers left
out (the numbers are the models', which differ between the packages'
random streams; PERF.md records the card's values beside BASELINE.md's)."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?")


def _rows(script: str, args) -> list:
    # two threads a script: the suite's other workers share the CPU
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_cpu_multi_thread_eigen=false"
                          " intra_op_parallelism_threads=2").strip(),
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / script), "--cpu",
         "--maxiter", "2", *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = []
    for line in out.stdout.splitlines():
        # the tuned hyperparameters of a row are the model's choice
        line = re.sub(r"(best|cfg)=\{[^}]*\}", r"\1={}", line.strip())
        if line:
            rows.append(NUMBER.sub("#", line))
    return rows


@pytest.mark.parametrize("script,args", [
    ("quality_report.py", []), ("sgd_parity.py", []),
    ("bpr_sampler_quality.py", []), ("longtail_quality.py", []),
    ("longtail_quality.py", ["--lowrank-tail", "--tail-boost", "2.5"])])
def test_port_script_prints_the_jax_rows(script, args):
    got = _rows(f"torch_{script}", args)
    want = _rows(script, args)
    assert got == want
    assert len(got) >= 4
