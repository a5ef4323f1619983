"""The port imports torch, never jax and nothing of matfac_tpu: importing
every module of matfac_tpu_torch, chip_smoke.py and the port's scripts and
examples in a fresh interpreter leaves jax and matfac_tpu unloaded, and no
source file of the port imports either."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "matfac_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "")
    for p in PKG.rglob("*.py"))
SCRIPTS = sorted(list((ROOT / "scripts").glob("torch_*.py"))
                 + list((ROOT / "examples").glob("torch_*.py")))
PORT_FILES = (list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + SCRIPTS + [ROOT / "tests" / "torch_mesh_worker.py"])


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
            "matfac_tpu_torch.ops.bisect_probes",
            "matfac_tpu_torch.solvers.als",
            "matfac_tpu_torch.solvers.ccd",
            "matfac_tpu_torch.solvers.bpr_dense",
            "matfac_tpu_torch.ops.svd_init", "matfac_tpu_torch.cli",
            "matfac_tpu_torch.models.increment",
            "matfac_tpu_torch.eval.quartile",
            "matfac_tpu_torch.analysis",
            "matfac_tpu_torch.analysis.batch",
            "matfac_tpu_torch.analysis.compare",
            "matfac_tpu_torch.analysis.conf_compat",
            "matfac_tpu_torch.analysis.confidence",
            "matfac_tpu_torch.analysis.drivers",
            "matfac_tpu_torch.analysis.top_bucket",
            "matfac_tpu_torch.analysis.topn",
            "matfac_tpu_torch.ops.ppr", "matfac_tpu_torch.tools",
            "matfac_tpu_torch.train.profiler",
            "matfac_tpu_torch.data.movielens",
            "matfac_tpu_torch.parallel", "matfac_tpu_torch.parallel.mesh",
            "matfac_tpu_torch.parallel.distributed",
            "matfac_tpu_torch.parallel.dsgd",
            "matfac_tpu_torch.parallel.block_dsgd",
            "matfac_tpu_torch.utils.native"} <= set(MODULES)
    assert ROOT / "scripts" / "torch_cuda_bisect.py" in SCRIPTS
    assert {ROOT / "scripts" / f"torch_{s}.py" for s in (
        "ml20m_flagship", "ml_parity_rows", "ccdpp_scale_parity",
        "microbench")} <= set(SCRIPTS)
    assert {ROOT / "scripts" / f"torch_{s}.py" for s in (
        "scaling_curve", "block_dsgd", "dense_bdsgd", "longtail_dsgd")} | {
        ROOT / "examples" / f"torch_{s}.py" for s in (
            "multichip_dsgd", "train_eval_serve")} <= set(SCRIPTS)
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


@pytest.mark.parametrize("pkg", ["", ".solvers", ".parallel", ".train",
                                 ".models", ".data", ".eval", ".analysis"])
def test_all_holds_the_jax_names(pkg):
    """Each package's ``__all__`` holds the JAX package's, and every name
    in it resolves (JAX's is read in this process, the port's too)."""
    import importlib
    jax_mod = importlib.import_module("matfac_tpu" + pkg)
    port = importlib.import_module("matfac_tpu_torch" + pkg)
    assert set(jax_mod.__all__) <= set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)
