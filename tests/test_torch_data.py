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


@pytest.mark.parametrize("with_values", [True, False])
@pytest.mark.parametrize("kind", ["continuous", "half_stars", "empty_rows",
                                  "no_rows"])
def test_write_csr_writes_jax_bytes(tmp_path, kind, with_values):
    """The port's writer (each value formatted once, rows joined from one
    list) writes the JAX writer's bytes, and both readers read them back
    as the same matrix."""
    r, c, v, n, m = _coo(seed=6)
    if kind == "half_stars":
        v = np.round(v * 2) / 2
    if kind == "empty_rows":
        keep = r % 3 != 0
        r, c, v, n = r[keep], c[keep], v[keep], n + 4
    if kind == "no_rows":
        r, c, v, n = r[:0], c[:0], v[:0], 0
    mat = jcsr.RatingMatrix.from_coo(r, c, v.astype(np.float32), n, m)
    tpath, jpath = str(tmp_path / "t.csr"), str(tmp_path / "j.csr")
    tio.write_csr(mat, tpath, with_values)
    jio.write_csr(mat, jpath, with_values)
    with open(tpath, "rb") as ft, open(jpath, "rb") as fj:
        assert ft.read() == fj.read()
    if n:
        _same_mat(tio.read_csr(tpath, with_values),
                  jio.read_csr(jpath, with_values))


@pytest.mark.parametrize("text", [
    "0 1.5 3 4\n\n2 5\n",                 # a blank row
    "0 1.5 3 4\n2 5",                     # no final newline
    "0 1.5 3 4\n2 5\n ",                  # a last line of blanks
    "  0\t1.5   3 4  \n\t2 5\n",         # tabs, runs of spaces
    "0 1e-05 3 -4.25\n1 2.5E+1\n",        # exponents and signs
    "0 1.5 3 4\r\n2 5\r\n",               # CRLF
    "\n\n\n",                             # rows without entries
    ""])
def test_read_csr_parses_text_as_jax_does(tmp_path, text):
    """The port's reader reads what the JAX reader reads, row for row."""
    path = tmp_path / "m.csr"
    path.write_bytes(text.encode())
    if not text.strip():
        for mod in (tio, jio):
            assert mod.read_csr(str(path)).nnz == 0
        return
    _same_mat(tio.read_csr(str(path)), jio.read_csr(str(path)))
    _same_mat(tio.read_csr(str(path), ncols=9),
              jio.read_csr(str(path), ncols=9))


@pytest.mark.parametrize("text,line", [("0 1\n2\n", 2), ("0 1 2 3\n\n4\n", 3),
                                       ("0 1\r\n2\r\n", 2)])
def test_read_csr_names_the_line_of_odd_tokens(tmp_path, text, line):
    path = tmp_path / "bad.csr"
    path.write_bytes(text.encode())
    for mod in (tio, jio):
        with pytest.raises(ValueError, match=f":{line}: odd token count"):
            mod.read_csr(str(path))


@pytest.mark.parametrize("seed", [0, 1])
def test_head_and_quartile_helpers_match(seed):
    """head_items, head_items_from_freq and quartile_assignments: the
    copies give the originals' masks and buckets (ties in id order)."""
    r, c, v, n, m = _coo(seed=seed, n=50, m=30)
    mat = jcsr.RatingMatrix.from_coo(r, c, v, n, m)
    for pc in (0.0, 0.5, 0.8, 1.0):
        np.testing.assert_array_equal(tfreq.head_items(mat, pc),
                                      jfreq.head_items(mat, pc))
    uf, if_ = jfreq.row_col_freq(mat)
    for f in (uf, if_, np.pad(if_, (0, 7)), np.zeros(6),
              np.array([2.0, 2.0, 1.0, 2.0])):
        for pc in (0.0, 0.3, 0.5, 0.8, 1.0):
            np.testing.assert_array_equal(
                tfreq.head_items_from_freq(f, pc),
                jfreq.head_items_from_freq(f, pc))
        valid = np.arange(len(f)) % 5 != 0
        for nq in (1, 4, 9):
            got = tfreq.quartile_assignments(f, valid, nq)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(
                got, jfreq.quartile_assignments(f, valid, nq))


@pytest.mark.parametrize("seed", [0, 1])
def test_rank_scale_corr_and_gen_stats_match(seed):
    """percentile_rank_map, freq_scale_stats, pearson_corr, gen_stats and
    format_gen_stats: the copies give the originals' values and lines."""
    r, c, v, n, m = _coo(seed=seed, n=50, m=30)
    mat = jcsr.RatingMatrix.from_coo(r, c, v, n, m)
    uf, if_ = jfreq.row_col_freq(mat)
    for f in (uf, if_, np.zeros(4)):
        for valid in (f > 0, np.arange(len(f)) % 3 != 0,
                      np.zeros(len(f), bool)):
            np.testing.assert_array_equal(
                tfreq.percentile_rank_map(f, valid),
                jfreq.percentile_rank_map(f, valid))
    assert tfreq.freq_scale_stats(uf, if_) == jfreq.freq_scale_stats(uf,
                                                                     if_)
    rng = np.random.default_rng(seed)
    for a, b in ((uf[:30], if_), (np.ones(5), rng.random(5)),
                 (np.ones(1), np.ones(1)), (rng.random(9), rng.random(9))):
        assert tfreq.pearson_corr(a, b) == jfreq.pearson_corr(a, b)
    tm = tcsr.RatingMatrix(mat.indptr, mat.indices, mat.values, mat.ncols)
    for ignore in (None, (r[::3], c[::3]), (np.array([n + 5]),
                                            np.array([0]))):
        got = tfreq.gen_stats(tm, ignore)
        assert got == jfreq.gen_stats(mat, ignore)
        for sfx in ("", "run1"):
            assert tfreq.format_gen_stats(got, sfx) == \
                jfreq.format_gen_stats(got, sfx)


def _same_data(t, j):
    for name in ("train_mat", "test_mat", "val_mat"):
        _same_mat(getattr(t, name), getattr(j, name))
    for name in ("orig_u_fac", "orig_i_fac"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (t.n_users, t.n_items, t.fac_dim) == (j.n_users, j.n_items,
                                                 j.fac_dim)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_users=90, n_items=70, k=4, seed=3, power_law=0.6,
                 nonneg=True, fac_dim=6),
    dict(n_users=120, n_items=50, stars=True, noise=0.35, test_pc=0.2,
         val_pc=0.05)])
def test_synthetic_data_matches_bit_for_bit(kw):
    dt, ut, it = tsyn.synthetic_data(**kw)
    dj, uj, ij = jsyn.synthetic_data(**kw)
    _same_data(dt, dj)
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("kw", [
    dict(n_users=200, n_items=150, density=0.08),
    dict(n_users=160, n_items=120, k=8, tail_rank=2, head_pc=0.3,
         power_law=1.3, seed=11, tail_boost=2.5, spectrum_pow=0.7)])
def test_tail_lowrank_data_matches_bit_for_bit(kw):
    dt, tail_t = tsyn.tail_lowrank_data(**kw)
    dj, tail_j = jsyn.tail_lowrank_data(**kw)
    _same_data(dt, dj)
    np.testing.assert_array_equal(tail_t, tail_j)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_users=60, n_items=40, per_user=10, seed=5,
                 structured=True, temp=0.5)])
def test_leave_one_out_data_matches_bit_for_bit(kw):
    _same_data(tsyn.leave_one_out_data(**kw), jsyn.leave_one_out_data(**kw))
