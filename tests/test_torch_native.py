"""The port's native host library (matfac_tpu_torch/utils/native.py, built
from csrc/native_host.cpp into build/) against the JAX package's
(matfac_tpu/utils/native.py, native/libmatfac_native.so): the same parses
and the same cosine graphs, bit for bit, since both are one C++ source
compiled with the same flags. ``read_csr`` of both packages reads the same
files to the same arrays, and the port's line parser, its fallback, names
the faults of the files the native parser refuses."""

import os
import shutil
import sys

import numpy as np
import pytest

from matfac_tpu.data import io as jio
from matfac_tpu.data.csr import RatingMatrix as JRM
from matfac_tpu.data.synthetic import low_rank_ratings
from matfac_tpu.utils import native as jnative
from matfac_tpu_torch.data import io as tio
from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.utils import native as tnative

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_native_ref import NATIVE_DIR, load_native_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _native_ref():
    """JAX's library loads before any test here reads it."""
    load_native_ref()


def _write(tmp_path, name, text):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        f.write(text)
    return p


def _ratings(seed, stars=False):
    mat, _, _ = low_rank_ratings(60, 45, 3, density=0.3, seed=seed)
    if stars:
        mat = JRM(mat.indptr, mat.indices,
                  (np.clip(np.round(mat.values * 2), 1, 10) * 0.5)
                  .astype(np.float32), mat.ncols)
    return mat


def _same(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _same_mat(t, j):
    assert (t.nrows, t.ncols, t.nnz) == (j.nrows, j.ncols, j.nnz)
    for a, b in ((t.indptr, j.indptr), (t.indices, j.indices),
                 (t.values, j.values)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_the_library_builds_into_build_not_native():
    assert tnative.available()
    so = _build.library_path("native_host")
    assert so.exists() and so.parent == _build.BUILD_DIR
    assert os.path.commonpath([str(so), NATIVE_DIR]) != NATIVE_DIR


@pytest.mark.parametrize("seed,stars,with_values", [
    (0, False, True), (1, True, True), (2, False, False)])
def test_parse_write_csr_output(tmp_path, seed, stars, with_values):
    mat = _ratings(seed, stars)
    p = str(tmp_path / "m.csr")
    jio.write_csr(mat, p, with_values=with_values)
    got = tnative.parse_csr_text(p, with_values)
    _same(got, jnative.parse_csr_text(p, with_values))
    np.testing.assert_array_equal(got[0], mat.indptr)
    np.testing.assert_array_equal(got[1], mat.indices)


@pytest.mark.parametrize("text,with_values", [
    ("0 5 2 3\n\n1 1.5", True),         # empty middle row, no final \n
    ("\n\n0 1\n\n", True),              # leading and trailing empty rows
    ("0 2 5\n1\n", False),              # index only
    ("3 1e-3 0 -2.5e+1\n7 .25\n", True),  # exponents, signs, no int part
    ("", True),                         # empty file
])
def test_parse_edge_cases(tmp_path, text, with_values):
    p = _write(tmp_path, "e.csr", text)
    got = tnative.parse_csr_text(p, with_values)
    assert got is not None
    _same(got, jnative.parse_csr_text(p, with_values))


@pytest.mark.parametrize("text,with_values", [
    ("0 2.0 x 3.0\n1 1.0\n", True),     # a non-numeric token
    ("0 1 2\n", True),                  # odd token count
    ("0 1\n2\n", True),                 # odd count over the file
    ("a\n", False),
])
def test_parse_refuses_what_jax_refuses(tmp_path, text, with_values):
    p = _write(tmp_path, "bad.csr", text)
    assert tnative.parse_csr_text(p, with_values) is None
    assert jnative.parse_csr_text(p, with_values) is None


def test_parse_missing_file(tmp_path):
    p = str(tmp_path / "none.csr")
    assert tnative.parse_csr_text(p, True) is None
    assert jnative.parse_csr_text(p, True) is None


@pytest.mark.parametrize("seed,stars,with_values,ncols", [
    (0, False, True, None), (1, True, True, 50), (2, False, False, None)])
def test_read_csr_of_both_packages(tmp_path, seed, stars, with_values,
                                   ncols):
    mat = _ratings(seed, stars)
    p = str(tmp_path / "m.csr")
    tio.write_csr(tio.RatingMatrix(mat.indptr, mat.indices, mat.values,
                                   mat.ncols), p, with_values=with_values)
    got = tio.read_csr(p, with_values=with_values, ncols=ncols)
    _same_mat(got, jio.read_csr(p, with_values=with_values, ncols=ncols))
    # the line parser, the fallback, reads the same arrays
    indptr, cols, vals = tio._parse_lines(p, with_values)
    np.testing.assert_array_equal(indptr, got.indptr)
    np.testing.assert_array_equal(cols, got.indices)
    np.testing.assert_array_equal(vals.astype(np.float32), got.values)


def test_read_csr_takes_the_native_parser(tmp_path, monkeypatch):
    p = str(tmp_path / "m.csr")
    jio.write_csr(_ratings(3), p)

    def refuse(path, with_values):
        raise AssertionError("the line parser ran")
    monkeypatch.setattr(tio, "_parse_lines", refuse)
    tio.read_csr(p)


@pytest.mark.parametrize("text,fault", [
    ("0 1 2\n", "odd token count"),
    ("0 2.0 x 3.0\n1 1.0\n", "invalid literal"),
])
def test_read_csr_names_the_fault_as_jax_does(tmp_path, text, fault):
    p = _write(tmp_path, "bad.csr", text)
    with pytest.raises(ValueError, match=fault):
        tio.read_csr(p)
    with pytest.raises(ValueError, match=fault):
        jio.read_csr(p)


def test_without_a_compiler_the_line_parser_runs(tmp_path, monkeypatch):
    mat = _ratings(4)
    p = str(tmp_path / "m.csr")
    jio.write_csr(mat, p)
    monkeypatch.setattr(_build, "host_compiler", lambda: None)
    assert not tnative.available()
    assert tnative.parse_csr_text(p, True) is None
    assert tnative.item_cosine_topk(*mat.csc(), mat.indptr, mat.indices,
                                    mat.values, mat.ncols, mat.nrows,
                                    3) is None
    _same_mat(tio.read_csr(p), jio.read_csr(p))


def test_a_compiler_without_openmp_is_passed_over(tmp_path, monkeypatch):
    """$CXX names a compiler that refuses -fopenmp: g++ on PATH builds."""
    bad = tmp_path / "cxx-without-openmp"
    bad.write_text("#!/bin/sh\necho 'cannot read spec file libgomp.spec' "
                   ">&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.setattr(_build, "_host_cxx", {})
    assert _build.host_compiler() == shutil.which("g++")
    monkeypatch.setattr(_build, "_host_cxx", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    assert _build.host_compiler() == str(bad)   # the only one: it fails


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "HOST_FLAGS",
                        _build.HOST_FLAGS + ("-fno-such-flag-here",))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_host_cxx", {})
    with pytest.raises(RuntimeError, match="no-such-flag-here"):
        tnative.available()
    assert not any((tmp_path / "build").glob("*.so"))


def _binary(seed, n_users=80, n_items=60, density=0.15):
    """tests/test_torch_analysis.py's tie-heavy binary ratings."""
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((n_users, n_items)) < density)
    v = np.ones(len(r), np.float32)
    return JRM.from_coo(r, c, v, n_users, n_items)


def _low_rank(kind):
    mat, _, _ = low_rank_ratings(300, 200, 4, density=0.1, seed=1,
                                 nonneg=kind != "signed")
    if kind == "integer":
        mat = JRM(mat.indptr, mat.indices,
                  np.maximum(np.round(mat.values), 1).astype(np.float32),
                  mat.ncols)
    return mat


@pytest.mark.parametrize("case,top_k", [
    (("binary", 0), 3), (("binary", 1), 3), (("binary", 2), 7),
    (("continuous", None), 10), (("integer", None), 10),
    (("signed", None), 10), (("binary", 3), 20)])
def test_item_cosine_topk_of_both_packages(case, top_k):
    kind, seed = case
    mat = (_binary(seed, n_items=12, density=0.3) if seed == 3
           else _binary(seed) if kind == "binary" else _low_rank(kind))
    args = (*mat.csc(), mat.indptr, mat.indices, mat.values, mat.ncols,
            mat.nrows, top_k)
    got, want = tnative.item_cosine_topk(*args), jnative.item_cosine_topk(
        *args)
    _same(got, want)
