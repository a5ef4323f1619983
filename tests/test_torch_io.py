"""The read half of the port's io and checkpoint modules against the JAX
package's: the same arrays from the same inputs and seeds, byte-identical
files both ways (JAX writes and the port reads, and the reverse), and the
text / binary checkpoints of tests/test_train.py's cases."""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matfac_tpu.config import Params as JParams
from matfac_tpu.data import io as jio
from matfac_tpu.data.csr import RatingMatrix as JMat
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.train import checkpoint as jckpt
from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data import io as tio
from matfac_tpu_torch.data.csr import RatingMatrix as TMat
from matfac_tpu_torch.models.base import MFState, state_from_numpy
from matfac_tpu_torch.train import checkpoint as tckpt


def _coo(seed, n_rows=40, n_cols=30, nnz=300, stars=False):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_rows * n_cols, nnz))
    r, c = key // n_cols, key % n_cols
    v = (rng.integers(1, 11, len(key)) * 0.5 if stars
         else rng.normal(3.0, 1.2, len(key))).astype(np.float32)
    return r, c, v, n_rows, n_cols


def _pair(seed, **kw):
    r, c, v, n, m = _coo(seed, **kw)
    return (TMat.from_coo(r, c, v, n, m), JMat.from_coo(r, c, v, n, m))


def _same_mat(t, j):
    assert (t.nrows, t.ncols, t.nnz) == (j.nrows, j.ncols, j.nnz)
    for a, b in ((t.indptr, j.indptr), (t.indices, j.indices),
                 (t.values, j.values)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", [0, 1])
def test_factor_binaries_are_byte_identical_both_ways(tmp_path, seed):
    mat = np.random.default_rng(seed).normal(size=(7, 5)).astype(np.float32)
    tio.write_factor_mat_bin(mat, tmp_path / "t.binmat")
    jio.write_factor_mat_bin(mat, tmp_path / "j.binmat")
    assert _bytes(tmp_path / "t.binmat") == _bytes(tmp_path / "j.binmat")
    for path in ("t.binmat", "j.binmat"):
        for shape in ((7, 5), (None, None), (3, 5)):
            got = tio.read_factor_mat_bin(str(tmp_path / path), *shape)
            want = jio.read_factor_mat_bin(str(tmp_path / path), *shape)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="values <"):
        tio.read_factor_mat_bin(str(tmp_path / "t.binmat"), 8, 5)


@pytest.mark.parametrize("vec", [
    np.asarray([1.5, -2.0, 0.0, 3.25]), np.asarray([2.5]),
    np.random.default_rng(3).normal(size=17).astype(np.float32)])
def test_vectors_are_byte_identical_both_ways(tmp_path, vec):
    tio.write_vector(vec, tmp_path / "t.vec")
    jio.write_vector(vec, tmp_path / "j.vec")
    assert _bytes(tmp_path / "t.vec") == _bytes(tmp_path / "j.vec")
    got = tio.read_vector(str(tmp_path / "j.vec"))
    want = jio.read_vector(str(tmp_path / "t.vec"))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresh", [2.0, 3.5, 10.0])
def test_binarize_matches(thresh):
    t, j = _pair(0, stars=True)
    _same_mat(tio.binarize(t, thresh), jio.binarize(j, thresh))


@pytest.mark.parametrize("keep_pc,seed", [(0.5, 0), (0.9, 7), (0.0, 1)])
def test_subsample_draws_as_jax_does(keep_pc, seed):
    t, j = _pair(2)
    _same_mat(tio.subsample(t, keep_pc, seed),
              jio.subsample(j, keep_pc, seed))


@pytest.mark.parametrize("stars", [False, True])
def test_triplets_are_byte_identical_both_ways(tmp_path, stars):
    t, j = _pair(4, stars=stars)
    tio.write_triplets(t, str(tmp_path / "t.txt"))
    jio.write_triplets(j, str(tmp_path / "j.txt"))
    assert _bytes(tmp_path / "t.txt") == _bytes(tmp_path / "j.txt")
    for shape in ((None, None), (45, 33)):
        _same_mat(tio.read_triplets(str(tmp_path / "j.txt"), *shape),
                  jio.read_triplets(str(tmp_path / "t.txt"), *shape))


@pytest.mark.parametrize("with_values", [True, False])
def test_model_value_csr_is_byte_identical(tmp_path, with_values):
    t, j = _pair(5)
    rng = np.random.default_rng(6)
    u = rng.normal(size=(t.nrows, 4)).astype(np.float32)
    i = rng.normal(size=(t.ncols, 4)).astype(np.float32)
    tio.write_csr_with_model_values(t, u, i, str(tmp_path / "t.csr"),
                                    with_values)
    jio.write_csr_with_model_values(j, u, i, str(tmp_path / "j.csr"),
                                    with_values)
    assert _bytes(tmp_path / "t.csr") == _bytes(tmp_path / "j.csr")


@pytest.mark.parametrize("max_ratings", [5000, 40])
def test_tail_test_mat_matches(max_ratings):
    t, j = _pair(8)
    head = np.random.default_rng(9).random(t.ncols) < 0.3
    _same_mat(tio.tail_test_mat(t, head, max_ratings),
              jio.tail_test_mat(j, head, max_ratings))


@pytest.mark.parametrize("seed", [0, 13])
def test_split_in_half_draws_as_jax_does(seed):
    t, j = _pair(10)
    for a, b in zip(tio.split_in_half(t, seed), jio.split_in_half(j, seed)):
        _same_mat(a, b)


# ----------------------------------------------------------------------
# checkpoints (tests/test_train.py:390, :486)
# ----------------------------------------------------------------------

def _states(p, n_users, n_items, seed, biases=True):
    """The same state in both packages: JAX's init, biases and mu set."""
    js = j_init_state(p, n_users, n_items, seed=seed)
    if biases:
        js = js._replace(u_bias=jnp.arange(n_users, dtype=jnp.float32) / 7,
                         i_bias=-jnp.arange(n_items, dtype=jnp.float32) / 3,
                         mu=jnp.asarray(2.5, jnp.float32))
    ts = state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    return ts, js


def _blank(p, n_users, n_items):
    return state_from_numpy(*(np.zeros_like(np.asarray(a)) for a in
                              j_init_state(p, n_users, n_items, seed=1)),
                            device="cpu")


def _same_state(t: MFState, j) -> None:
    for a, b in zip(t, j):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_full_reads_both_packages_save_full(tmp_path, writer):
    p = JParams(fac_dim=3, u_reg=0.01, i_reg=0.01, learn_rate=0.005)
    ts, js = _states(p, 4, 5, seed=9)
    sig = tckpt.model_signature(Params(fac_dim=3, u_reg=0.01, i_reg=0.01,
                                       learn_rate=0.005), 4, 5)
    assert sig == jckpt.model_signature(p, 4, 5)
    (tckpt if writer == "port" else jckpt).save_full(
        ts if writer == "port" else js, str(tmp_path / "m"), sig)
    got = tckpt.load_full(_blank(p, 4, 5), str(tmp_path / "m"), sig)
    want = jckpt.load_full(j_init_state(p, 4, 5, seed=1),
                           str(tmp_path / "m"), sig)
    _same_state(got, want)
    # the values written, as the text format keeps them (%.7g)
    np.testing.assert_allclose(got.u_bias.numpy(), np.asarray(js.u_bias),
                               atol=1e-6)
    assert float(got.mu) == 2.5


def test_save_full_files_are_byte_identical(tmp_path):
    p = JParams(fac_dim=3)
    ts, js = _states(p, 4, 5, seed=2)
    sig = jckpt.model_signature(p, 4, 5)
    tckpt.save_full(ts, str(tmp_path / "t"), sig)
    jckpt.save_full(js, str(tmp_path / "j"), sig)
    names = [f"{{}}_uFac_{sig}.mat", f"{{}}_iFac_{sig}.mat",
             f"{{}}_uBias_{sig}.vec", f"{{}}_iBias_{sig}.vec",
             f"{{}}_{sig}_gBias"]
    for name in names:
        assert _bytes(tmp_path / name.format("t")) == \
            _bytes(tmp_path / name.format("j"))


def test_load_full_reference_fixture_and_missing_set(tmp_path):
    """A hand-written reference-layout fixture loads; a missing bias file
    gives None (existence-checked as a set), as in JAX."""
    p = JParams(fac_dim=3, u_reg=0.01, i_reg=0.01, learn_rate=0.005)
    ts, js = _states(p, 4, 5, seed=9)
    sig = jckpt.model_signature(p, 4, 5)
    (tmp_path / f"r_uBias_{sig}.vec").write_text("1.5\n-2\n0\n3.25\n")
    (tmp_path / f"r_iBias_{sig}.vec").write_text("0\n0\n1\n0\n-1\n")
    (tmp_path / f"r_{sig}_gBias").write_text("3.75\n")
    tckpt.save_facs(ts, str(tmp_path / "r"), sig)
    got = tckpt.load_full(_blank(p, 4, 5), str(tmp_path / "r"), sig)
    want = jckpt.load_full(j_init_state(p, 4, 5, seed=1),
                           str(tmp_path / "r"), sig)
    _same_state(got, want)
    np.testing.assert_array_equal(got.u_bias.numpy(), [1.5, -2, 0, 3.25])
    assert float(got.mu) == 3.75
    for missing in (f"r_{sig}_gBias", f"r_uFac_{sig}.mat"):
        (tmp_path / missing).unlink()
        assert tckpt.load_full(_blank(p, 4, 5), str(tmp_path / "r"),
                               sig) is None
        assert jckpt.load_full(j_init_state(p, 4, 5), str(tmp_path / "r"),
                               sig) is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bin_facs_round_trip_both_ways(tmp_path, writer):
    p = JParams(fac_dim=3)
    ts, js = _states(p, 6, 4, seed=5, biases=False)
    sig = jckpt.model_signature(p, 6, 4)
    paths = (tckpt.save_bin_facs(ts, str(tmp_path / "b"), sig)
             if writer == "port"
             else jckpt.save_bin_facs(js, str(tmp_path / "b"), sig))
    assert paths == tckpt.bin_fac_paths(str(tmp_path / "b"), sig)
    got = tckpt.load_bin_facs(_blank(p, 6, 4), str(tmp_path / "b"), sig)
    want = jckpt.load_bin_facs(j_init_state(p, 6, 4, seed=1),
                               str(tmp_path / "b"), sig)
    _same_state(got[:2], want[:2])
    np.testing.assert_array_equal(got.u_fac.numpy(), np.asarray(js.u_fac))
    assert tckpt.load_bin_facs(_blank(p, 6, 4), str(tmp_path / "x"),
                               sig) is None


def test_bin_facs_reference_layout(tmp_path):
    """tests/test_train.py:390: the writes read back with plain struct
    unpacking, byte-equal to JAX's, and a file written the reference way
    (one little-endian double at a time) loads exactly."""
    p = JParams(fac_dim=3, u_reg=0.01, i_reg=0.01, learn_rate=0.005)
    ts, js = _states(p, 4, 5, seed=9, biases=False)
    sig = jckpt.model_signature(p, 4, 5)
    up, _ = tckpt.save_bin_facs(ts, str(tmp_path / "b"), sig)
    jup, _ = jckpt.save_bin_facs(js, str(tmp_path / "j"), sig)
    raw = _bytes(up)
    assert raw == _bytes(jup)
    vals = struct.unpack("<%dd" % (4 * 3), raw)
    np.testing.assert_array_equal(np.array(vals).reshape(4, 3),
                                  ts.u_fac.numpy().astype(np.float64))
    ref = np.arange(20, dtype=np.float64).reshape(4, 5) / 7.0
    with open(tmp_path / f"c_uFac_{sig}.binmat", "wb") as f:
        for row in ref:
            for v in row:
                f.write(struct.pack("<d", v))
    with open(tmp_path / f"c_iFac_{sig}.binmat", "wb") as f:
        f.write(struct.pack("<%dd" % 25, *np.zeros(25)))
    p5 = JParams(fac_dim=5)
    got = tckpt.load_bin_facs(_blank(p5, 4, 5), str(tmp_path / "c"), sig)
    np.testing.assert_array_equal(got.u_fac.numpy(), ref.astype(np.float32))
