"""The public names the JAX package exports and the port now has too:
``data.csr.mats_equal`` (the reference's compMat) on JAX's cases, and
``eval.metrics.weighted_sse`` against JAX's on the same seeded inputs;
and ``ops.scatter.index_add_ordered_`` on the CPU, which is
``index_add_`` bit for bit there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import matfac_tpu.eval.metrics as JM
from matfac_tpu.config import Params as JParams
from matfac_tpu.data.csr import RatingMatrix as JMat
from matfac_tpu.data.csr import mats_equal as j_mats_equal
from matfac_tpu.data.synthetic import low_rank_ratings as j_low_rank
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.utils import freq as jfreq
import matfac_tpu_torch.eval.metrics as TM
from matfac_tpu_torch.data.csr import RatingMatrix, mats_equal
from matfac_tpu_torch.models.base import EvalView
from matfac_tpu_torch.ops.scatter import index_add_ordered_


def _small(cls):
    """tests/test_data.py's small_mat: 4 x 5, one empty row."""
    dense = np.array([[1, 0, 2, 0, 0], [0, 0, 0, 0, 0],
                      [3, 4, 0, 0, 5], [0, 0, 0, 6, 0]], np.float32)
    return cls.from_dense(dense)


@pytest.mark.parametrize("case", ["copy", "values", "structure_only",
                                  "shape", "indices", "tol"])
def test_mats_equal_matches_jax(case):
    """JAX's cases (tests/test_data.py:198-206) and a shape change, a moved
    entry and a tolerance, through both packages' ``mats_equal``."""
    def pair(cls):
        a = _small(cls)
        if case == "copy":
            return (a, a.copy()), {}
        if case in ("values", "structure_only", "tol"):
            b = cls(a.indptr, a.indices, a.values + 0.25, a.ncols)
            kw = ({"check_values": False} if case == "structure_only"
                  else {"tol": 0.5} if case == "tol" else {})
            return (a, b), kw
        if case == "shape":
            return (a, cls(a.indptr, a.indices, a.values, a.ncols + 1)), {}
        idx = a.indices.copy()
        idx[0] = 1
        return (a, cls(a.indptr, idx, a.values, a.ncols)), {}
    (ta, tb), kw = pair(RatingMatrix)
    (ja, jb), _ = pair(JMat)
    assert mats_equal(ta, tb, **kw) is j_mats_equal(ja, jb, **kw)
    want = {"copy": True, "values": False, "structure_only": True,
            "shape": False, "indices": False, "tol": True}[case]
    assert mats_equal(ta, tb, **kw) is want


@pytest.mark.parametrize("chunk", [None, 4096])
def test_weighted_sse_matches_jax(chunk, monkeypatch):
    """The IFWMF data term on the same view, entries and weights as JAX's
    ``weighted_sse`` (rtol 1e-6: the port sums in float64, JAX in f32
    chunks of the same size)."""
    if chunk:
        monkeypatch.setattr(JM, "_EVAL_CHUNK", chunk)
        monkeypatch.setattr(TM, "_EVAL_CHUNK", chunk)
    mat, _, _ = j_low_rank(2000, 500, k=4, density=0.02, seed=0, noise=0.1)
    iu, ii = jfreq.invalid_users_items(mat, 2000, 500)
    params = JParams(fac_dim=4, seed=0)
    jview = JModelMF(params, 2000, 500).eval_view(
        j_init_state(params, 2000, 500))
    jcoo = JM.stage_coo(mat, iu, ii, 2000, 500)
    w = np.random.default_rng(0).random(jcoo.rows.shape[0]).astype(
        np.float32)
    want = float(JM.weighted_sse(jview, jcoo, jnp.asarray(w)))
    tmat = RatingMatrix(mat.indptr, mat.indices, mat.values, mat.ncols)
    tcoo = TM.stage_coo(tmat, iu, ii, 2000, 500, device="cpu")
    n = tcoo.rows.shape[0]
    view = EvalView(*(torch.from_numpy(np.array(a)) for a in jview))
    got = TM.weighted_sse(view, tcoo, torch.from_numpy(w[:n]))
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-6)
    assert got == TM.sse(view, tcoo, torch.from_numpy(w[:n]))[0]


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_index_add_ordered_is_index_add_on_the_cpu(dtype, dim):
    """On a CPU tensor the ordered scatter is ``index_add_`` itself: the
    same bits on a batch whose first row is hit thousands of times."""
    rng = np.random.default_rng(1)
    n_rows, k, n = 300, 16, 8192
    idx = np.where(rng.random(n) < 0.4, 0, rng.integers(0, n_rows, n))
    index = torch.from_numpy(idx.astype(np.int64))
    table = torch.from_numpy(rng.normal(0, 1, (n_rows, k)).astype(
        np.float32)).to(dtype)
    src = torch.from_numpy(rng.normal(0, 1e-2, (n, k)).astype(
        np.float32)).to(dtype)
    if dim == 1:
        table, src = table.t().contiguous(), src.t().contiguous()
    want = table.clone().index_add_(dim, index, src)
    t = table.clone()
    got = index_add_ordered_(t, dim, index, src)
    assert got is t
    assert torch.equal(got, want)
