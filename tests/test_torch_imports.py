"""The port imports torch, never jax and nothing of matfac_tpu: importing
every module of matfac_tpu_torch, chip_smoke.py and the port's scripts in
a fresh interpreter leaves jax and matfac_tpu unloaded, and no source file
of the port imports either."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "matfac_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "")
    for p in PKG.rglob("*.py"))
SCRIPTS = sorted((ROOT / "scripts").glob("torch_*.py"))
PORT_FILES = (list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + SCRIPTS)


def _import_all_then(check: str) -> subprocess.CompletedProcess:
    """Import every port module, chip_smoke and the port's scripts in a
    fresh interpreter, then run ``check``."""
    code = ("import importlib.util, sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "import chip_smoke\n"
            + "".join(
                f"spec = importlib.util.spec_from_file_location("
                f"'{p.stem}', {str(p)!r})\n"
                f"spec.loader.exec_module("
                f"importlib.util.module_from_spec(spec))\n"
                for p in SCRIPTS)
            + check)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_every_module_is_importable_without_jax():
    assert {"matfac_tpu_torch.ops.dense_row_kernel",
            "matfac_tpu_torch.ops.topk_kernel",
            "matfac_tpu_torch.eval.ranking", "matfac_tpu_torch.serving",
            "matfac_tpu_torch.models.bpr",
            "matfac_tpu_torch.solvers.bpr",
            "matfac_tpu_torch.ops.block_sgd_kernel",
            "matfac_tpu_torch.ops.sgd_kernel",
            "matfac_tpu_torch.models.longtail",
            "matfac_tpu_torch.ops.bisect_probes"} <= set(MODULES)
    assert ROOT / "scripts" / "torch_cuda_bisect.py" in SCRIPTS
    proc = _import_all_then(
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib'))\n"
        "assert not bad, bad\n")
    assert proc.returncode == 0, proc.stderr


def test_nothing_of_matfac_tpu_is_loaded():
    """The port owns its copies of the JAX package's numpy-only modules
    (config, data, utils.freq): none of matfac_tpu is loaded."""
    assert {"matfac_tpu_torch.config", "matfac_tpu_torch.data.io",
            "matfac_tpu_torch.utils.freq"} <= set(MODULES)
    proc = _import_all_then(
        "bad = sorted(m for m in sys.modules if m == 'matfac_tpu' "
        "or m.startswith('matfac_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'matfac_tpu_torch' in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b)", re.M)
    offenders = [str(f) for f in PORT_FILES if pat.search(f.read_text())]
    assert not offenders, offenders


def test_no_source_file_imports_matfac_tpu():
    pat = re.compile(r"^\s*(import|from)\s+matfac_tpu(\.|\s|$)", re.M)
    assert pat.search("from matfac_tpu.config import Params")
    assert not pat.search("from matfac_tpu_torch.config import Params")
    offenders = [str(f) for f in PORT_FILES if pat.search(f.read_text())]
    assert not offenders, offenders
