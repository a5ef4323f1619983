"""The port's own copies of the JAX package's numpy-only modules
(matfac_tpu_torch.config, .data and .utils.freq) against the originals on
the same seeds and files: the same fields and defaults, the same arrays,
the same bytes on disk."""

import dataclasses

import numpy as np
import pytest

from matfac_tpu import config as jconfig
from matfac_tpu.data import csr as jcsr
from matfac_tpu.data import dataset as jdataset
from matfac_tpu.data import io as jio
from matfac_tpu.data import synthetic as jsyn
from matfac_tpu.utils import freq as jfreq
from matfac_tpu_torch import config as tconfig
from matfac_tpu_torch.data import csr as tcsr
from matfac_tpu_torch.data import dataset as tdataset
from matfac_tpu_torch.data import io as tio
from matfac_tpu_torch.data import synthetic as tsyn
from matfac_tpu_torch.utils import freq as tfreq


def _fields(cls):
    return [(f.name, f.type, f.default, f.default_factory)
            for f in dataclasses.fields(cls)]


def test_params_fields_and_defaults_match():
    assert _fields(tconfig.Params) == _fields(jconfig.Params)
    assert tconfig.Params().display() == jconfig.Params().display()


def test_params_replace_and_keywords_match():
    kw = dict(fac_dim=64, learn_rate=0.05, u_reg=0.002, mesh_shape=(2, 4))
    t = tconfig.Params(**kw).replace(seed=7, max_iter=3)
    j = jconfig.Params(**kw).replace(seed=7, max_iter=3)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _same_mat(t, j):
    assert (t.nrows, t.ncols, t.nnz) == (j.nrows, j.ncols, j.nnz)
    for a, b in ((t.indptr, j.indptr), (t.indices, j.indices),
                 (t.values, j.values)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(), dict(noise=0.1), dict(power_law=0.8, nonneg=True),
    dict(stars=True, noise=0.35, power_law=0.6)])
def test_low_rank_ratings_match(kw):
    args = (300, 120, 4, 0.1, 5)
    mt, ut, it = tsyn.low_rank_ratings(*args, **kw)
    mj, uj, ij = jsyn.low_rank_ratings(*args, **kw)
    _same_mat(mt, mj)
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(it, ij)


def test_gen_latent_factors_match():
    np.testing.assert_array_equal(tsyn.gen_latent_factors(50, 6, 2.0, 3),
                                  jsyn.gen_latent_factors(50, 6, 2.0, 3))


@pytest.mark.parametrize("pcs", [(0.1, 0.1), (0.2, 0.05), (0.0, 0.0)])
def test_split_train_test_val_matches(pcs):
    mat, _, _ = jsyn.low_rank_ratings(200, 90, 3, 0.2, 1, noise=0.1)
    parts_t = tio.split_train_test_val(tcsr.RatingMatrix(
        mat.indptr, mat.indices, mat.values, mat.ncols), *pcs, seed=4)
    parts_j = jio.split_train_test_val(mat, *pcs, seed=4)
    for t, j in zip(parts_t, parts_j):
        _same_mat(t, j)


def _coo(seed=0, n=40, m=25, nnz=300):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, m, nnz)
    key = np.unique(r * m + c)
    return key // m, key % m, rng.normal(3.0, 1.0, len(key)), n, m


def test_rating_matrix_round_trips_match():
    r, c, v, n, m = _coo()
    perm = np.random.default_rng(1).permutation(len(r))
    t = tcsr.RatingMatrix.from_coo(r[perm], c[perm], v[perm], n, m)
    j = jcsr.RatingMatrix.from_coo(r[perm], c[perm], v[perm], n, m)
    _same_mat(t, j)
    for a, b in zip(t.to_coo(), j.to_coo()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    _same_mat(tcsr.RatingMatrix.from_dense(t.to_dense()), t)
    _same_mat(t.transpose().transpose(), t)
    _same_mat(t.sort_rows(), t)
    _same_mat(t.copy(), t)
    for a, b in zip(t.csc(), j.csc()):
        np.testing.assert_array_equal(a, b)


def test_rating_matrix_layouts_and_stats_match():
    r, c, v, n, m = _coo(seed=2)
    t = tcsr.RatingMatrix.from_coo(r, c, v, n, m)
    j = jcsr.RatingMatrix.from_coo(r, c, v, n, m)
    for cap in (None, 3):
        for a, b in zip(t.pad_rows(cap), j.pad_rows(cap)):
            np.testing.assert_array_equal(a, b)
    assert t.stats() == j.stats()
    assert t.is_sorted() == j.is_sorted() is True
    np.testing.assert_array_equal(t.row_degrees(), j.row_degrees())
    np.testing.assert_array_equal(t.col_degrees(), j.col_degrees())
    assert repr(t) == repr(j) and t.mean_rating() == j.mean_rating()
    with pytest.raises(ValueError):
        tcsr.RatingMatrix(np.array([1, 2]), np.array([0]), np.array([1.0]), 3)


def test_factor_files_are_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    f = rng.normal(size=(17, 5)).astype(np.float32)
    tio.write_factor_mat(f, str(tmp_path / "t.txt"))
    jio.write_factor_mat(f, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(
        tio.read_factor_mat(str(tmp_path / "j.txt"), 17, 5),
        jio.read_factor_mat(str(tmp_path / "j.txt"), 17, 5))


@pytest.mark.parametrize("with_values", [True, False])
def test_read_csr_reads_what_jax_writes(tmp_path, with_values):
    r, c, v, n, m = _coo(seed=4)
    v = np.round(v * 2) / 2   # half stars print exactly
    mat = jcsr.RatingMatrix.from_coo(r, c, v, n, m)
    path = str(tmp_path / "m.csr")
    jio.write_csr(mat, path, with_values)
    _same_mat(tio.read_csr(path, with_values),
              jio.read_csr(path, with_values))
    _same_mat(tio.read_csr(path, with_values, ncols=m + 3),
              jio.read_csr(path, with_values, ncols=m + 3))


def test_read_csr_rejects_odd_tokens(tmp_path):
    path = tmp_path / "bad.csr"
    path.write_text("0 1.5 2\n")
    with pytest.raises(ValueError, match="odd token count"):
        tio.read_csr(str(path))


def test_data_bundle_matches_from_matrices_and_from_files(tmp_path):
    mat, uf, _ = jsyn.low_rank_ratings(120, 60, 3, 0.2, 2, noise=0.1)
    mat.values[:] = np.round(mat.values * 2) / 2
    tr, te, va = jio.split_train_test_val(mat, 0.1, 0.1, 3)
    t = tdataset.Data(train_mat=tr, test_mat=te, val_mat=va)
    j = jdataset.Data(train_mat=tr, test_mat=te, val_mat=va)
    assert (t.n_users, t.n_items, t.train_nnz, t.fac_dim, repr(t)) == \
        (j.n_users, j.n_items, j.train_nnz, j.fac_dim, repr(j))
    paths = {}
    for name, m in (("train", tr), ("test", te), ("val", va)):
        paths[name] = str(tmp_path / f"{name}.csr")
        jio.write_csr(m, paths[name])
    ufile = str(tmp_path / "u.txt")
    jio.write_factor_mat(uf, ufile)
    kw = dict(train_mat_file=paths["train"], test_mat_file=paths["test"],
              val_mat_file=paths["val"], fac_dim=3, orig_u_fac_file=ufile,
              prefix="p")
    t = tdataset.Data(tconfig.Params(**kw))
    j = jdataset.Data(jconfig.Params(**kw))
    assert (t.n_users, t.n_items, t.prefix, t.fac_dim) == \
        (j.n_users, j.n_items, j.prefix, j.fac_dim)
    for a, b in ((t.train_mat, j.train_mat), (t.test_mat, j.test_mat),
                 (t.val_mat, j.val_mat)):
        _same_mat(a, b)
    np.testing.assert_array_equal(t.orig_u_fac, j.orig_u_fac)
    with pytest.raises(ValueError, match="train matrix"):
        tdataset.Data()


@pytest.mark.parametrize("dims", [None, (50, 30), (30, 20)])
def test_freq_helpers_match(dims):
    r, c, v, n, m = _coo(seed=5, n=40, m=25)
    mat = jcsr.RatingMatrix.from_coo(r, c, v, n, m)
    for a, b in zip(tfreq.row_col_freq(mat), jfreq.row_col_freq(mat)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    nu, ni = dims or (n, m)
    for a, b in zip(tfreq.invalid_users_items(mat, nu, ni),
                    jfreq.invalid_users_items(mat, nu, ni)):
        np.testing.assert_array_equal(a, b)
