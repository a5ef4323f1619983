"""The port's offline tooling (matfac_tpu_torch.tools), profiler
(train.profiler) and MovieLens parsers (data.movielens) against the JAX
package's, on tests/test_tools.py's cases (the sharded checkpoint waits for
the port's multi-device slice) and on small rating files written here.

Tolerances: the numpy tools are held exactly (files byte for byte);
compute_conf_bucket_rmse, float32 products on the device in both packages,
at rtol 1e-5, and against a transcription of the reference script's loops
at rtol 1e-5 as JAX's test holds JAX's.
"""

import numpy as np
import pytest
import torch

from matfac_tpu import tools as jtools
from matfac_tpu.data import movielens as jml
from matfac_tpu.data.csr import RatingMatrix as JRM
from matfac_tpu.data.synthetic import low_rank_ratings
from matfac_tpu_torch import tools as ttools
from matfac_tpu_torch.data import movielens as tml
from matfac_tpu_torch.data.csr import RatingMatrix as TRM
from matfac_tpu_torch.train import profiler as tprof


def tmat(m: JRM) -> TRM:
    return TRM(m.indptr, m.indices, m.values, m.ncols)


def same_mat(a, b):
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.shape == b.shape


def test_convert_scipy_npz(tmp_path):
    import scipy.sparse as sp
    mat, _, _ = low_rank_ratings(20, 15, 3, density=0.3, seed=0)
    npz = str(tmp_path / "m.npz")
    sp.save_npz(npz, sp.csr_matrix(mat.to_dense()))
    got = ttools.convert_scipy_npz(npz, str(tmp_path / "t.csr"))
    same_mat(got, jtools.convert_scipy_npz(npz, str(tmp_path / "j.csr")))
    assert (tmp_path / "t.csr").read_bytes() == \
        (tmp_path / "j.csr").read_bytes()


@pytest.mark.parametrize("directed", [False, True])
def test_snap_graph(tmp_path, directed):
    mat, _, _ = low_rank_ratings(10, 10, 2, density=0.3, seed=1)
    ttools.to_snap_graph(tmat(mat), str(tmp_path / "t"), directed)
    jtools.to_snap_graph(mat, str(tmp_path / "j"), directed)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_log_parsing_averaging_and_sweeps(tmp_path):
    log1 = ("epoch 0: obj 1.0e+03 val_rmse 2.5 lr 0.1 3ms\n"
            "epoch 1: obj 5.0e+02 val_rmse 1.5 lr 0.1 3ms\n"
            "epoch 3: HR 0.45 best 0.5\n")
    log2 = "epoch 0: obj 9.0e+02 val_rmse 2.1 lr 0.1 3ms\n"
    p1, p2 = tmp_path / "a.log", tmp_path / "b.log"
    p1.write_text(log1)
    p2.write_text(log2)
    assert ttools.parse_training_logs(log1) == \
        jtools.parse_training_logs(log1)
    for key in ("val_rmse", "objective", "hr"):
        paths = [str(p1), str(p2)]
        assert ttools.average_log_values(paths, key) == pytest.approx(
            jtools.average_log_values(paths, key), nan_ok=True)
    grid = {"facdim": [5, 10], "learnrate": [0.001, 0.01, 0.1]}
    base = "python -m matfac_tpu_torch.cli --trainmat t.csr"
    got = ttools.gen_sweep_jobs(base, grid, str(tmp_path / "t"), "j")
    assert got == jtools.gen_sweep_jobs(base, grid, str(tmp_path / "w"),
                                        "j")
    for i in range(6):
        assert (tmp_path / "t" / f"j_{i}.sh").read_bytes() == \
            (tmp_path / "w" / f"j_{i}.sh").read_bytes()


def test_trace_writes_a_chrome_trace(tmp_path):
    import json
    with tprof.trace(str(tmp_path / "tr"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_compute_conf_bucket_rmse():
    """Port against JAX, and against a literal transcription of the
    reference script's loops (computeConf.py:66-102)."""
    rng = np.random.default_rng(3)
    U, I, K, M, NB = 12, 20, 3, 4, 4
    u_facs = [rng.normal(size=(U, K)) for _ in range(M)]
    i_facs = [rng.normal(size=(I, K)) for _ in range(M)]
    u_fac, i_fac = rng.normal(size=(U, K)), rng.normal(size=(I, K))
    orig_u, orig_i = rng.normal(size=(U, K)), rng.normal(size=(I, K))
    args = (u_facs, i_facs, u_fac, i_fac, orig_u, orig_i, NB)
    got = ttools.compute_conf_bucket_rmse(*args, device="cpu")
    np.testing.assert_allclose(got, jtools.compute_conf_bucket_rmse(*args),
                               rtol=1e-5)
    per = I // NB
    sq, ct = np.zeros(NB), np.zeros(NB)
    for u in range(U):
        scores = []
        for it in range(I):
            std = np.std([np.dot(uf[u], vf[it])
                          for uf, vf in zip(u_facs, i_facs)])
            scores.append((1.0 / std if std != 0 else -1.0, it))
        scores.sort(reverse=True)
        for b in range(NB):
            s, e = b * per, (b + 1) * per
            if b == NB - 1 or e > I:
                e = I
            for i in range(s, e):
                it = scores[i][1]
                d = np.dot(u_fac[u], i_fac[it]) - np.dot(orig_u[u],
                                                         orig_i[it])
                sq[b] += d * d
                ct[b] += 1
    np.testing.assert_allclose(got, np.sqrt(sq / ct), rtol=1e-5)


def test_quartile_rmse_from_predictions():
    rows = [(0, 0, 1.0), (0, 1, 2.0), (1, 0, 3.0), (9, 9, 0.0)]
    u_part, i_part = {0: 0, 1: 1}, {0: 0, 1: 0}
    val = {(0, 0): 1.5, (0, 1): 2.0, (1, 0): 2.0}
    args = (rows, u_part, i_part, lambda u, i: val[(u, i)])
    assert ttools.quartile_rmse_from_predictions(*args) == \
        jtools.quartile_rmse_from_predictions(*args)


def test_overlap_rep_factor_and_pairwise():
    s1, s2 = {1, 2, 3, 4}, {3, 4, 5, 6}
    assert ttools.overlap_rep_factor(s1, s2, 100) == \
        jtools.overlap_rep_factor(s1, s2, 100)
    sets = [s1, s2, {1, 3, 5}]
    assert ttools.pairwise_overlap_stats(sets, 100) == \
        jtools.pairwise_overlap_stats(sets, 100)


def test_write_filtered_min_rating(tmp_path):
    mat = JRM(np.array([0, 2, 4]), np.array([0, 1, 1, 2]),
              np.array([5.0, 3.0, 4.0, 5.0], np.float32), 3)
    kw = dict(min_rating=4.0, head_items={2})
    assert ttools.write_filtered_min_rating(
        tmat(mat), str(tmp_path / "t"), **kw) == \
        jtools.write_filtered_min_rating(mat, str(tmp_path / "j"), **kw) == 2
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_log_munger_family(tmp_path):
    assert ttools.mean_of_stream([1.0, 2.0, 3.0]) == \
        jtools.mean_of_stream([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(ttools.average_columns(["1 2", "", "3 4"]),
                                  jtools.average_columns(["1 2", "", "3 4"]))
    np.testing.assert_array_equal(ttools.cumulative_sum([1, 2, 3]),
                                  jtools.cumulative_sum([1, 2, 3]))
    assert ttools.column_diff(["5 2 1"], 0, 2) == \
        jtools.column_diff(["5 2 1"], 0, 2)
    p1, p2 = tmp_path / "a.txt", tmp_path / "b.txt"
    p1.write_text("hr: 0.5,0.6,nan\nk1: 1.0 k2: 3.0\n")
    p2.write_text("hr: 0.7,0.8,0.9\nk1: 2.0 k2: 5.0\n")
    p3 = tmp_path / "f.txt"
    p3.write_text("FiltPc 10 2 0.5 4 0.25\nFiltPc 20 6 0.1 2 0.7\n")
    p4 = tmp_path / "v.txt"
    p4.write_text("FreqVar 0.5 x 100 1 0.2 3 0.4 0.9\n")
    for name, args in (("average_metric_files", ([str(p1), str(p2)],)),
                       ("average_tagged_freq_lines", ([str(p3)], "FiltPc")),
                       ("average_freq_var_lines", ([str(p4)],))):
        got, want = getattr(ttools, name)(*args), getattr(jtools, name)(*args)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_prediction_abs_diff(tmp_path):
    pc = tmp_path / "pred.csv"
    pc.write_text("0,1,3.5\n2,4,1.0\n")
    tt = tmp_path / "test.txt"
    tt.write_text("0 1 4.0\n2 4 0.5\n")
    assert ttools.prediction_abs_diff(str(pc), str(tt), str(tmp_path / "t")
                                      ) == \
        jtools.prediction_abs_diff(str(pc), str(tt), str(tmp_path / "j"))
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.mark.parametrize("filter_users", [False, True])
def test_extract_dense_items_and_bpr_triplets(tmp_path, filter_users):
    m = JRM.from_coo(np.array([0, 0, 1, 2, 2, 2]),
                     np.array([0, 1, 0, 0, 2, 2]),
                     np.array([1.0, 2.0, 1.0, 3.0, 1.0, 1.0]), 3, 3)
    same_mat(ttools.extract_dense_items(tmat(m), 1, filter_users),
             jtools.extract_dense_items(m, 1, filter_users))
    assert ttools.write_bpr_triplets(tmat(m), str(tmp_path / "t")) == \
        jtools.write_bpr_triplets(m, str(tmp_path / "j")) == 4
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_ppr_item_buckets_rmse():
    rng = np.random.default_rng(0)
    ou, oi = rng.normal(size=(50, 4)), rng.normal(size=(30, 4))
    args = (rng.permutation(30), ou + 0.1, oi.copy(), ou, oi, 3)
    (gr, gb), (wr, wb) = (ttools.ppr_item_buckets_rmse(*args),
                          jtools.ppr_item_buckets_rmse(*args))
    np.testing.assert_array_equal(gr, wr)
    assert gb == wb


def test_analyze_output_files(tmp_path):
    p1, p2 = tmp_path / "r1.txt", tmp_path / "r2.txt"
    p1.write_text("junk\nRE Train RMSE: 0.5\nRE Val RMSE: 0.7\n")
    p2.write_text("RE Train RMSE: 0.7\nRE Val RMSE: 0.9\n")
    paths = [str(p1), str(p2)]
    assert ttools.analyze_output_files(paths) == \
        jtools.analyze_output_files(paths)


def test_plot_prob_rmse_pdf(tmp_path):
    pytest.importorskip("matplotlib")
    (tmp_path / "stats.txt").write_text("1 30 120 4.5 7\n0 10 80 2.5 3\n")
    (tmp_path / "rmse.txt").write_text("1 0.9 0.8 0.7\n0 1.1 1.0 0.9\n")
    (tmp_path / "probs.txt").write_text(
        "1 0.1 0.01 0.001\n0 0.2 0.02 0.002\n")
    stats = ttools.read_user_stats(str(tmp_path / "stats.txt"))
    assert stats == jtools.read_user_stats(str(tmp_path / "stats.txt"))
    curves = []
    for mod in (ttools, jtools):
        rmse = mod.read_user_curves(str(tmp_path / "rmse.txt"))
        probs = mod.read_user_curves(str(tmp_path / "probs.txt"),
                                     log10=True)
        curves.append((rmse, probs))
    for a, b in zip(curves[0], curves[1]):
        assert list(a) == list(b)
        for u in a:
            np.testing.assert_array_equal(a[u], b[u])
    out = str(tmp_path / "out.pdf")
    assert ttools.plot_prob_rmse_pdf(*curves[0], stats, out) == 2
    raw = open(out, "rb").read()
    assert raw[:5] == b"%PDF-" and len(raw) > 1000


# ----------------------------------------------------------------------
# MovieLens parsers, on small files in each format
# ----------------------------------------------------------------------

def _ratings(seed=0, n=60):
    rng = np.random.default_rng(seed)
    users = rng.choice([3, 9, 17, 40, 41, 77, 100], n)
    items = rng.choice([1, 2, 5, 8, 13, 21, 34, 55, 89], n)
    key = np.unique(users * 1000 + items, return_index=True)[1]
    return (users[key], items[key],
            rng.integers(1, 11, len(key)) * 0.5, rng.integers(0, 1e9,
                                                              len(key)))


@pytest.mark.parametrize("fmt", ["u.data", "ratings.dat", "ratings.csv"])
def test_movielens_parsers_match_jax(tmp_path, fmt):
    u, i, r, ts = _ratings()
    rows = zip(u, i, r, ts)
    if fmt == "u.data":
        text = "".join(f"{a}\t{b}\t{c:g}\t{d}\n" for a, b, c, d in rows)
    elif fmt == "ratings.dat":
        text = "".join(f"{a}::{b}::{c:g}::{d}\n" for a, b, c, d in rows)
    else:
        text = "userId,movieId,rating,timestamp\n" + "".join(
            f"{a},{b},{c:g},{d}\n" for a, b, c, d in rows)
    path = tmp_path / fmt
    path.write_text(text)
    for a, b in zip(tml.load_ratings_file(str(path)),
                    jml.load_ratings_file(str(path))):
        np.testing.assert_array_equal(a, b)
    got = tml.load_movielens(str(path), seed=2)
    want = jml.load_movielens(str(path), seed=2)
    for name in ("train_mat", "test_mat", "val_mat"):
        same_mat(getattr(got, name), getattr(want, name))
    assert (got.n_users, got.n_items, got.prefix) == \
        (want.n_users, want.n_items, want.prefix)
