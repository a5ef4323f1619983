"""A copy of the benchmark at a size the CPU runs in seconds, and a run of
it in a fresh interpreter (the copy is imported first, the program from
the repository).

``tiny_copy(dest)`` copies BENCHMARK.json and benchmark/ to ``dest`` and
cuts every configuration and traffic mix to a tiny size; ``run(dest,
argv, patch)`` runs ``run.main(argv, device="cpu")`` there after
executing ``patch`` (a planted fault) and returns (exit code, stdout,
stderr)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "ml20m-mf-k64": dict(n_users=600, n_items=300, n_ratings=20000,
                         fac_dim=16),
    "ml10m-bpr-k64": dict(n_users=500, n_items=200, positives_per_user=20,
                          fac_dim=16, batch_size=256),
}
TINY_TRAFFIC = {
    "serve-top10-1user": dict(pool_requests=256, warmup_requests=4,
                              profile_requests=8, sample_every=4),
    # every request sampled: a loaded CPU may answer only a few in a run
    "serve-top10-256users": dict(pool_requests=64, users_per_request=64,
                                 warmup_requests=4, profile_requests=8,
                                 sample_every=1),
    "train-sgd": dict(batch_size=1024),
}


def _edit(path: Path, changes: dict) -> None:
    d = json.loads(path.read_text())
    d.update(changes)
    path.write_text(json.dumps(d, indent=1))


def tiny_copy(dest: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, ch in TINY_CONFIGS.items():
        _edit(dest / "benchmark" / "configs" / f"{name}.json", ch)
    for name, ch in TINY_TRAFFIC.items():
        _edit(dest / "benchmark" / "traffic" / f"{name}.json", ch)
    return dest


def run(dest: Path, argv, patch: str = "", module: str = "run",
        timeout: float = 600):
    code = (f"import sys\nsys.path[:0] = [{str(dest)!r}, {str(ROOT)!r}]\n"
            f"{patch}\nfrom benchmark import {module}\n"
            f"sys.exit({module}.main({list(argv)!r}, device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, cwd=dest, env=env)
    return p.returncode, p.stdout, p.stderr


def result(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
