"""The port's counterparts of four JAX scripts (scripts/torch_ml20m_flagship
.py, torch_ml_parity_rows.py, torch_ccdpp_scale_parity.py,
torch_microbench.py): each runs with ``--cpu`` at a small size in a fresh
interpreter and prints the JAX script's lines (numbers masked; the device
line is the port's own); the parity rows' functions and the flagship's at
a small shape against the JAX scripts' functions and JAX's train_model,
in process, from one initial state and with JAX's random draws injected.
The card's runs at JAX's full shapes are in PERF.md."""

import contextlib
import glob
import importlib.util
import io
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.models.base import EvalView as JEvalView
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.ops.block_sgd_kernel import device_diag_schedule
from matfac_tpu.train.loop import train_model as j_train_model
from matfac_tpu_torch.models.base import state_from_numpy
from matfac_tpu_torch.solvers import bpr as tbpr
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
from matfac_tpu_torch.solvers.ccd import CCDPPSolver

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, str(ROOT / "scripts" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------------
# the printed lines, in a fresh interpreter
# ----------------------------------------------------------------------

# the JAX scripts' own lines (numbers as #), from their format strings:
# scripts/ml20m_flagship.py:44, :57-63, :67, :81-82;
# scripts/ml_parity_rows.py:40-41, :48-50, :55, :68, :88-90, :107-109;
# scripts/ccdpp_scale_parity.py:32, :52-54, :55;
# scripts/microbench.py:64-65, :76, :89-90, :113-114, :124-125, :135-136
FLAGSHIP = [
    "data: Data(n_users=#, n_items=#, train_nnz=#, test=yes, val=yes) "
    "gen+split #s",
    "k=#: #+ epochs in #s wall (incl. staging+compile+evals), best val #, "
    "test #, stop=max_iter",
    "k=#: # checkpoint files",
    "k=#: full-catalog HR@# eval (#k x #k) = #s",
    "k=#: #+ epochs in #s wall (incl. staging+compile+evals), best val #, "
    "test #, stop=max_iter",
    "k=#: # checkpoint files"]
_POINTWISE = ["--- {n}: RatingMatrix(nrows=#, ncols=#, nnz=#) k=# "
              "method={m} mean-baseline val RMSE=#",
              "{n}: best_val=# test=# best_iter=# stop=max_iter wall=#s"]
_BPR = ["--- ML-#M-shape BPR (temp=#): RatingMatrix(nrows=#, ncols=#, "
        "nnz=#)",
        "ML-#M-shape BPR: best_val_HR=# test_HR@#=# test_ARHR=# "
        "test_NDCG@#=# wall=#s",
        "ML-#M-shape BPR sampled-negatives (# pop-sampled): model HR@#=# "
        "ARHR=# | popularity scorer HR@#=# ARHR=# | margin #"]
_QUART = ["ML-#M-shape TMFDropout quartiles:",
          "Test RMSE by quartile (q# = least frequent):",
          "Items Part: # #  # #  # #  # #", "Users Part: # #  # #  # #  # #",
          "Val RMSE by quartile (q# = least frequent):",
          "Items Part: # #  # #  # #  # #", "Users Part: # #  # #  # #  # #"]
PARITY = ([s.format(n="ML-#M-shape ALS", m="als") for s in _POINTWISE]
          + [s.format(n="ML-#M-shape CCD++", m="ccd++") for s in _POINTWISE]
          + [s.format(n="ML-#M-shape TMFDropout", m="auto")
             for s in _POINTWISE] + _QUART + _BPR + _BPR
          + ["PARITY_ROWS_DONE"])
CCDPP = (["config: Data(n_users=#, n_items=#, train_nnz=#, test=yes, "
          "val=yes)"]
         + [f"{n} epoch #: val=# (#s)" for n in ("als",) for _ in range(2)]
         + ["als BEST val=#"]
         + ["ccd++ epoch #: val=# (#s)"] * 2 + ["ccd++ BEST val=#"]
         + ["ccd++g# epoch #: val=# (#s)"] * 2 + ["ccd++g# BEST val=#"])
MICRO = ["gather chain (# rows, k=#): # ms -> #M rows/s",
         "scatter chain: # ms -> #M rows/s",
         "element-level stream gather: # ms (vs ~# for contiguous slices)",
         "batched cholesky+solve [#,#,#]: # ms (# us/system)",
         "batched CG-# solve: # ms (# us/system)",
         "bf# matmul #x#x#: # ms -> # TFLOP/s"]


def _masked_lines(script: str, args, env_extra=None) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="2", **(env_extra or {}))
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / script),
                          "--cpu", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return [_mask(line) for line in out.stdout.splitlines() if line.strip()]


def _mask(line: str) -> str:
    # a sign is part of a number ("ML-10M" -> "ML#M"), so "-#" is "#"
    return NUMBER.sub("#", line.strip()).replace("-#", "#")


def _in_order(want, got):
    """Every line of ``want`` in ``got``, in order (the port prints lines
    of its own between them: the device, each phase's wall)."""
    it = iter(got)
    missing = [w for w in want if not any(g == w for g in it)]
    assert not missing, (missing, got)


@pytest.mark.parametrize("script,args,want,env", [
    ("torch_ml20m_flagship.py",
     ["--n-users", "1500", "--n-items", "400", "--nnz", "40000",
      "--max-iter", "6", "--save-iter", "5", "--out", "{tmp}"],
     FLAGSHIP, None),
    ("torch_ml_parity_rows.py", ["--scale", "0.03", "--maxiter", "2"],
     PARITY, {"PARITY_ROWS": "als,ccdpp,tmf,bpr,bprhard"}),
    ("torch_ccdpp_scale_parity.py",
     ["--n-users", "2000", "--n-items", "500", "--density", "0.02",
      "--epochs", "2"], CCDPP, None),
    ("torch_microbench.py",
     ["--quick", "--nnz", "131072", "--n-sys", "256", "--mm", "128", "256",
      "64"], MICRO, None),
])
def test_port_script_prints_the_jax_lines(script, args, want, env,
                                          tmp_path):
    got = _masked_lines(script, [a.format(tmp=tmp_path) for a in args], env)
    assert got[0].startswith("device:")
    _in_order([_mask(w) for w in want], got)


# ----------------------------------------------------------------------
# the row functions against the JAX scripts' own, in process
# ----------------------------------------------------------------------

def _jax_init_injected(monkeypatch, mod):
    """The port script's ``train_model`` starting from JAX's initial state
    (JAX's train_model draws it from PRNGKey(params.seed))."""
    real = mod.train_model

    def train(data, params, **kw):
        js = j_init_state(params, data.n_users, data.n_items)
        kw["init_state_override"] = state_from_numpy(
            *(np.asarray(a) for a in js), device=kw.get("device", "cpu"))
        return real(data, params, **kw)

    monkeypatch.setattr(mod, "train_model", train)


def _jax_chain_draw(self):
    """CCD++'s dimension order from the JAX loop's key chain
    (PRNGKey(seed), one split an epoch)."""
    if not hasattr(self, "_jax_key"):
        self._jax_key = jax.random.PRNGKey(self.params.seed)
    self._jax_key, ek = jax.random.split(self._jax_key)
    return np.asarray(jax.random.permutation(ek, self.model.k))


def _jax_bpr_draw(self):
    """BPRSolver.draw from TrainLoopHR's key chain (PRNGKey(seed), one split
    an epoch) into the JAX stream epoch's (border, bits)."""
    if not hasattr(self, "_jkey"):
        self._jkey = jax.random.PRNGKey(self.params.seed)
    self._jkey, ek = jax.random.split(self._jkey)
    k_ord, k_bits, _ = jax.random.split(ek, 3)
    i64 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    return (i64(jax.random.permutation(k_ord, self.n_batches)),
            i64(jax.random.bits(k_bits, (self.n_batches, 2, self.n_tries,
                                         self.batch_size), jnp.uint32)))


def _printed(out: str, key: str) -> float:
    return float(re.search(re.escape(key) + r"=([-\d.]+)", out).group(1))


@pytest.mark.parametrize("row", ["als", "ccd++"])
def test_pointwise_row_matches_jax(row, monkeypatch):
    """``pointwise_row`` for ALS and CCD++ at 300 x 200, k 8, 3 epochs
    against JAX's: best val and test RMSE at rtol 2e-3, the class of the
    port's train_model parity tests for the coordinate family
    (tests/test_torch_train.py, test_train_model_coordinate_matches_jax);
    the same best epoch and stop reason."""
    port, ref = _load("torch_ml_parity_rows"), _load("ml_parity_rows")
    _jax_init_injected(monkeypatch, port)
    monkeypatch.setattr(CCDPPSolver, "draw", _jax_chain_draw)
    args = (f"row {row}", "mf", row, 300, 200, 0.08, 8, 3)
    kw = dict(u_reg=10.0, i_reg=10.0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep_j = ref.pointwise_row(*args, **kw)
        got = port.pointwise_row(*args, device="cpu", **kw)
    out = buf.getvalue().split(f"row {row}: best_val=")
    test_j = _printed("best_val=" + out[1], "test")
    assert got["best_val"] == pytest.approx(rep_j.best_metric, rel=2e-3)
    assert got["test"] == pytest.approx(test_j, rel=2e-3, abs=1e-4)
    assert got["best_iter"] == rep_j.best_iter
    assert got["stop"] == rep_j.stop_reason


def test_bpr_row_matches_jax(monkeypatch):
    """``bpr_row`` at 300 users x 120 items, 10 positives a user, k 8,
    3 epochs, the JAX key chain's draws injected: val and test HR@10, ARHR
    and the sampled protocol's HR@10 equal JAX's printed values to their
    4 decimals (the port's BPR front door gives JAX's HR@10 exactly,
    tests/test_torch_bpr.py, test_train_model_bpr_matches_jax)."""
    port, ref = _load("torch_ml_parity_rows"), _load("ml_parity_rows")
    _jax_init_injected(monkeypatch, port)
    monkeypatch.setattr(tbpr.BPRSolver, "draw", _jax_bpr_draw)
    kw = dict(n_users=300, n_items=120, per_user=10, k=8, max_iter=3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.bpr_row(**kw)
    out = buf.getvalue()
    got = port.bpr_row(**kw, device="cpu")
    for key, mine in (("best_val_HR", got["best_val_hr"]),
                      ("test_HR@10", got["hr"]),
                      ("test_ARHR", got["arhr"])):
        assert f"{mine:.4f}" == f"{_printed(out, key):.4f}", key
    sampled = out.split("sampled-negatives")[1]
    assert f"{got['sampled_hr']:.4f}" == f"{_printed(sampled, 'HR@10'):.4f}"


def _jax_orders(self):
    """BlockSGDSolver._stripe_order: the order the JAX dense solver draws
    each epoch (default_rng(seed + 41) keys, device_diag_schedule)."""
    if not hasattr(self, "_jax_rng"):
        self._jax_rng = np.random.default_rng(self.params.seed + 41)
    ek = jax.random.PRNGKey(int(self._jax_rng.integers(2**31)))
    order = device_diag_schedule(ek, self.NU, 1, 1)[0][:, 0]
    return torch.from_numpy(np.asarray(order, np.int64))


def test_flagship_run_matches_jax(tmp_path, monkeypatch):
    """The flagship's ``run_k`` at 1,500 x 400 (half-star codes), k 8,
    6 epochs, save_iter 5, against JAX's train_model with the same Params,
    initial state and stripe orders: best val RMSE and each logged epoch's
    at rtol 1e-3 (the densesgd class, tests/test_torch_train.py,
    test_train_model_matches_jax), the same best epoch and stop reason,
    as many checkpoint files as JAX writes at that prefix, and the HR@10
    of the JAX script's leave-one-out matrix equal to JAX's scorer on the
    same view."""
    from matfac_tpu.data.csr import RatingMatrix as JMat
    from matfac_tpu.eval.ranking import CatalogScorer as JScorer
    from matfac_tpu.utils import freq as jfreq
    flag = _load("torch_ml20m_flagship")
    _jax_init_injected(monkeypatch, flag)
    monkeypatch.setattr(BlockSGDSolver, "_stripe_order", _jax_orders)
    data = flag.make_data(1500, 400, 40_000)
    p = flag.flagship_params(8, max_iter=6, save_iter=5)
    jp = str(tmp_path / "jax" / "ml20m_k8")
    os.makedirs(os.path.dirname(jp))
    rep_j, jmodel, *_ = j_train_model(
        data, p, algo="mf", mf_method="densesgd", prefix=jp,
        init_state_override=j_init_state(p, data.n_users, data.n_items),
        log_fn=lambda s: None)
    got = flag.run_k(data, p, str(tmp_path / "port" / "ml20m_k8"), "cpu",
                     hr=True, log=lambda s: None)
    assert got["best_val"] == pytest.approx(rep_j.best_metric, rel=1e-3)
    np.testing.assert_allclose([h.val_rmse for h in got["rep"].history],
                               [h.val_rmse for h in rep_j.history],
                               rtol=1e-3)
    assert got["best_iter"] == rep_j.best_iter
    assert got["stop"] == rep_j.stop_reason
    assert got["n_ckpt"] == len(glob.glob(f"{jp}*")) > 0
    assert len(got["walls"]) >= 7 and got["walls"]["n_evals"] > 0
    view = got["model"].eval_view(got["rep"].best_state)
    iu, ii = jfreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    tr = data.train_mat
    jscorer = JScorer(JMat(tr.indptr, tr.indices, tr.values, tr.ncols),
                      iu, ii, data.n_users, data.n_items)
    loo = flag.hr10_users(data.n_users, data.n_items)
    want = jscorer.hit_rate(
        JEvalView(*(jnp.asarray(t.numpy()) for t in view)),
        JMat(loo.indptr, loo.indices, loo.values, loo.ncols), 10)
    assert got["hr10"] == pytest.approx(float(want), abs=1e-12)
