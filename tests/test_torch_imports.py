"""The port imports torch and never jax: importing every module of
matfac_tpu_torch (and chip_smoke.py) in a fresh interpreter leaves jax
unloaded, and no source file under the package imports it."""

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


def test_every_module_is_importable_without_jax():
    assert {"matfac_tpu_torch.ops.dense_row_kernel",
            "matfac_tpu_torch.ops.topk_kernel",
            "matfac_tpu_torch.eval.ranking", "matfac_tpu_torch.serving",
            "matfac_tpu_torch.models.bpr",
            "matfac_tpu_torch.solvers.bpr",
            "matfac_tpu_torch.ops.block_sgd_kernel",
            "matfac_tpu_torch.ops.sgd_kernel",
            "matfac_tpu_torch.models.longtail"} <= set(MODULES)
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "import chip_smoke\n"
            + "bad = sorted(m for m in sys.modules if m == 'jax' "
              "or m.startswith('jax.') or m.startswith('jaxlib'))\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b)", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
