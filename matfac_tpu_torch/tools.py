"""Offline tooling — parity with the reference's ``python/`` scripts
(27 files; SURVEY.md §2 "python/ tooling"); port of matfac_tpu/tools.py.
Only compute_conf_bucket_rmse computes on a device (torch, an explicit
``device``); the rest is numpy, copied.

Covered here:
  * convert_scipy_npz   — convert_scipy_sparse_to_text_csr.py
  * to_snap_graph       — toSNAPGraph.py (edge-list export)
  * average_log_values  — avgLines.py / avgModelsOp.py (average metric
                          lines across seed-replicated run logs)
  * parse_training_logs — analyzOpFiles.py (scrape epoch metric lines)
  * gen_sweep_jobs      — genSpJobs.py / genMultMethJobs.py (job-script
                          generation for hyperparameter sweeps; emits
                          plain shell lines instead of PBS)
  * compute_conf_bucket_rmse       — computeConf.py (vectorized)
  * quartile_rmse_from_predictions — computeTestQuartileRMSE.py
  * overlap_rep_factor /
    pairwise_overlap_stats         — compOverlapFreq.py
  * write_filtered_min_rating      — writeTestFiltMaxRat.py

  * mean_of_stream / average_columns / cumulative_sum / column_diff
                        — avg.py, averageCol.py, avgLines.py, cumSum.py,
                          compcoldiff.py
  * average_metric_files           — avgTop.py
  * average_tagged_freq_lines      — avgFiltPc.py / avgMaxFreq.py
  * average_freq_var_lines         — avgVarLog.py
  * prediction_abs_diff            — compllormadiff.py
  * extract_dense_items            — extractDenseMat.py
  * write_bpr_triplets             — toQMFTriplet.py
  * ppr_item_buckets_rmse          — pprItemBucketsRMSE.py (vectorized)
  * analyze_output_files           — analyzOpFiles.py

  * read_user_stats / read_user_curves / plot_prob_rmse_pdf
                        — plotProbRMSE.py (per-user bucket-RMSE +
                          log10-probability PDF pages)

Not ported: incompJobs.py (PBS job-queue glue, subsumed by
gen_sweep_jobs), compTestCSRItemDist.py (an empty stub in the
reference — it opens the file and does nothing, :1-8), and
compareGPRPPR.py -> analysis.drivers.compare_ppr_gpr.

Dataset converters (MovieLens: data.movielens; the JAX package's
triplet writer io.write_triplets is ROADMAP queue 1, item 17) and
synthetic factors (genLatFacs: data.synthetic) live in their subject
modules.
"""

from __future__ import annotations

import itertools
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.data.io import write_csr


def convert_scipy_npz(npz_path: str, out_path: str) -> RatingMatrix:
    """scipy.sparse .npz -> GKlib text CSR."""
    import scipy.sparse as sp
    m = sp.load_npz(npz_path).tocsr()
    mat = RatingMatrix(m.indptr.astype(np.int64),
                       m.indices.astype(np.int32),
                       m.data.astype(np.float32), m.shape[1])
    write_csr(mat, out_path)
    return mat


def to_snap_graph(mat: RatingMatrix, path: str,
                  directed: bool = False) -> None:
    """Adjacency -> SNAP edge list (``src dst`` per line)."""
    r, c, _ = mat.to_coo()
    with open(path, "w") as f:
        f.write(f"# Nodes: {max(mat.nrows, mat.ncols)} "
                f"Edges: {mat.nnz}\n")
        for a, b in zip(r, c):
            f.write(f"{a} {b}\n")
            if not directed:
                f.write(f"{b} {a}\n")


_METRIC_RE = re.compile(
    r"epoch (\d+): (?:obj ([\d.eE+-]+) val_rmse ([\d.eE+-]+)"
    r"|HR ([\d.eE+-]+))")


def parse_training_logs(text: str) -> List[Dict[str, float]]:
    """Scrape this framework's epoch log lines into records."""
    out = []
    for m in _METRIC_RE.finditer(text):
        rec: Dict[str, float] = {"epoch": float(m.group(1))}
        if m.group(2) is not None:
            rec["objective"] = float(m.group(2))
            rec["val_rmse"] = float(m.group(3))
        else:
            rec["hr"] = float(m.group(4))
        out.append(rec)
    return out


def average_log_values(paths: Sequence[str], key: str = "val_rmse"
                       ) -> float:
    """avgLines.py analog: mean of each run's FINAL value of ``key``."""
    finals = []
    for p in paths:
        with open(p) as f:
            recs = [r for r in parse_training_logs(f.read()) if key in r]
        if recs:
            finals.append(recs[-1][key])
    return float(np.mean(finals)) if finals else float("nan")


def gen_sweep_jobs(base_cmd: str, grid: Dict[str, Iterable],
                   out_dir: Optional[str] = None,
                   prefix: str = "job") -> List[str]:
    """genSpJobs/genMultMethJobs analog: cartesian hyperparameter sweep
    -> one shell command per combo (optionally written to
    ``out_dir/{prefix}_N.sh``)."""
    keys = list(grid)
    cmds = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        flags = " ".join(f"--{k} {v}" for k, v in zip(keys, combo))
        cmds.append(f"{base_cmd} {flags}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for i, cmd in enumerate(cmds):
            with open(os.path.join(out_dir, f"{prefix}_{i}.sh"),
                      "w") as f:
                f.write("#!/bin/sh\n" + cmd + "\n")
    return cmds


# ----------------------------------------------------------------------
# round-2 ports of the non-trivial remaining python/ scripts
# ----------------------------------------------------------------------

def compute_conf_bucket_rmse(u_facs: Sequence[np.ndarray],
                             i_facs: Sequence[np.ndarray],
                             u_fac: np.ndarray, i_fac: np.ndarray,
                             orig_u: np.ndarray, orig_i: np.ndarray,
                             n_buckets: int = 10,
                             device="cuda") -> np.ndarray:
    """computeConf.py::computeConfBuckRMSEFrmModels analog
    (python/computeConf.py:66-102), vectorized on ``device`` in float32.

    Ensemble confidence per (u, i) = 1/std of the predictions across the
    model pairs in ``u_facs``/``i_facs`` (-1 where std == 0, matching
    computeConf :4-15); items are bucketed per user by decreasing
    confidence and each bucket's pred-vs-ground-truth RMSE is returned
    ([n_buckets]). The [M, U, I] prediction stack is the reference
    script's."""
    dev = torch.device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    n_items = i_fac.shape[0]
    preds = torch.stack([as_t(uf) @ as_t(vf).t()
                         for uf, vf in zip(u_facs, i_facs)])  # [M,U,I]
    std = preds.std(dim=0, correction=0)
    conf = torch.where(std != 0,
                       1.0 / torch.where(std != 0, std, 1.0), -1.0)
    order = torch.argsort(-conf, dim=1, stable=True)         # [U,I]
    est = as_t(u_fac) @ as_t(i_fac).t()
    tru = as_t(orig_u) @ as_t(orig_i).t()
    se = torch.take_along_dim((est - tru) ** 2, order, dim=1).cpu().numpy()
    per = n_items // n_buckets
    out = np.zeros(n_buckets)
    for b in range(n_buckets):
        s = b * per
        e = n_items if b == n_buckets - 1 else min((b + 1) * per,
                                                   n_items)
        out[b] = np.sqrt(se[:, s:e].mean()) if e > s else np.nan
    return out


def quartile_rmse_from_predictions(pred_rows: Sequence,
                                   u_part: Dict[int, int],
                                   i_part: Dict[int, int],
                                   val_lookup) -> Dict[str, object]:
    """computeTestQuartileRMSE.py analog
    (python/computeTestQuartileRMSE.py:28-78): given
    (user, item, predRating) rows, per-partition RMSEs against the
    values from ``val_lookup(u, i)``. Rows whose user or item has no
    partition are counted as missing."""
    from collections import defaultdict
    u_sq = defaultdict(float); u_ct = defaultdict(float)
    i_sq = defaultdict(float); i_ct = defaultdict(float)
    all_sq = 0.0; all_ct = 0.0; missing = 0
    for user, item, pred in pred_rows:
        user, item = int(user), int(item)
        if user in u_part and item in i_part:
            d = float(val_lookup(user, item)) - float(pred)
            u_sq[u_part[user]] += d * d; u_ct[u_part[user]] += 1
            i_sq[i_part[item]] += d * d; i_ct[i_part[item]] += 1
            all_sq += d * d; all_ct += 1
        else:
            missing += 1
    return {
        "all_rmse": float(np.sqrt(all_sq / all_ct)) if all_ct else
        float("nan"),
        "missing": missing,
        "user_part_rmse": {p: float(np.sqrt(u_sq[p] / c))
                           for p, c in u_ct.items()},
        "item_part_rmse": {p: float(np.sqrt(i_sq[p] / c))
                           for p, c in i_ct.items()},
    }


def overlap_rep_factor(set1: set, set2: set, pop_size: int
                       ) -> Dict[str, float]:
    """compOverlapFreq.py::getRepFacNProb analog
    (python/compOverlapFreq.py:6-21): representation
    factor (observed/expected overlap of two sets drawn from a
    population) and the hypergeometric tail probability of seeing that
    much or more overlap by chance."""
    from scipy import stats
    ov = len(set1 & set2)
    expected = len(set1) * len(set2) / pop_size
    rep = ov / expected if expected > 0 else float("nan")
    prob = float(stats.hypergeom.sf(ov + 1, pop_size, len(set1),
                                    len(set2)))
    return {"overlap": ov, "expected": expected, "rep_factor": rep,
            "prob": prob}


def pairwise_overlap_stats(item_sets: Sequence[set], pop_size: int
                           ) -> Dict[str, float]:
    """compOverlapFreq.py::compOverlapPc/compOverlapStats analogs
    (:84-131): mean pairwise overlap fraction + mean representation
    factor across all set pairs."""
    n = len(item_sets)
    pw, pw_ct = 0.0, 0
    reps, probs = [], []
    inter = set(item_sets[0]) if item_sets else set()
    for i in range(n):
        inter &= item_sets[i]
        for j in range(i + 1, n):
            s1, s2 = item_sets[i], item_sets[j]
            if s1 and s2:
                ov = len(s1 & s2)
                pw += ov / len(s1) + ov / len(s2)
                pw_ct += 2
                r = overlap_rep_factor(s1, s2, pop_size)
                reps.append(r["rep_factor"]); probs.append(r["prob"])
    return {
        "mean_pairwise_pc": pw / pw_ct if pw_ct else float("nan"),
        "all_intersection": len(inter),
        "mean_rep_factor": float(np.mean(reps)) if reps else float("nan"),
        "mean_prob": float(np.mean(probs)) if probs else float("nan"),
    }


def write_filtered_min_rating(mat: RatingMatrix, out_path: str,
                              min_rating: float = 5.0,
                              head_items: Optional[set] = None
                              ) -> int:
    """writeTestFiltMaxRat.py analog
    (python/writeTestFiltMaxRat.py:3-17): keep only
    entries with rating >= min_rating whose item is not a head item;
    writes GKlib text CSR (same row count), returns ratings kept."""
    head_items = head_items or set()
    kept = 0
    with open(out_path, "w") as g:
        for u in range(mat.nrows):
            cols, vals = mat.row(u)
            parts = []
            for i, v in zip(cols, vals):
                if int(i) in head_items or v < min_rating:
                    continue
                parts.append(f"{int(i)} {v:g}")
                kept += 1
            g.write(" ".join(parts) + "\n")
    return kept


# ---------------------------------------------------------------------------
# Log/column mungers — the remaining python/ script family, vectorized.
# ---------------------------------------------------------------------------

def mean_of_stream(values: Sequence[float]) -> float:
    """avg.py (:1-10): mean of a float stream."""
    v = np.asarray(list(values), np.float64)
    return float(v.mean())


def average_columns(lines: Iterable[str]) -> np.ndarray:
    """averageCol.py / avgLines.py (:1-29): per-column mean over
    whitespace-separated numeric rows (empty rows skipped)."""
    rows = [list(map(float, ln.split())) for ln in lines if ln.split()]
    return np.asarray(rows, np.float64).mean(axis=0)


def cumulative_sum(values: Sequence[float]) -> np.ndarray:
    """cumSum.py (:1-15): running sum of a float stream (the reference
    prints 100x selected entries as a LaTeX row; we return the sums)."""
    return np.cumsum(np.asarray(list(values), np.float64))


def column_diff(lines: Iterable[str], col1: int, col2: int) -> List[float]:
    """compcoldiff.py (:1-12): per-line cols[col1] - cols[col2]."""
    out = []
    for ln in lines:
        cols = ln.split()
        if cols:
            out.append(float(cols[col1]) - float(cols[col2]))
    return out


def average_metric_files(paths: Sequence[str]) -> Dict[str, np.ndarray]:
    """avgTop.py (:5-56): average ``key: v1,v2,...`` metric lines (NaN
    entries zeroed, reference :17-20) and ``k1: v1 k2: v2`` scalar pairs
    across run-output files; returns key -> averaged value(s)."""
    sums: Dict[str, list] = {}
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if ":" not in line:
                    continue
                if line.count(":") == 1:
                    key, rest = line.split(":", 1)
                    cols = rest.strip().strip(",").split(",")
                    try:
                        vals = np.array(
                            [0.0 if "nan" in c.lower() else float(c)
                             for c in cols])
                    except ValueError:
                        continue
                    if key not in sums:
                        sums[key] = [np.zeros(len(vals)), 0]
                    if len(vals) == len(sums[key][0]):
                        sums[key][0] += vals
                        sums[key][1] += 1
                else:
                    kvs = line.split()
                    if len(kvs) % 2:
                        continue
                    try:
                        for i in range(0, len(kvs), 2):
                            k = kvs[i].rstrip(":")
                            v = float(kvs[i + 1])
                            if k not in sums:
                                sums[k] = [np.zeros(1), 0]
                            sums[k][0] += v
                            sums[k][1] += 1
                    except ValueError:
                        continue
    return {k: v[0] / max(v[1], 1) for k, v in sums.items()}


def average_tagged_freq_lines(paths: Sequence[str], tag: str = "FiltPc"
                              ) -> Dict[int, np.ndarray]:
    """avgFiltPc.py / avgMaxFreq.py (:1-49, tag "FiltPc"/"MaxFreq"):
    average the (count, rmse, in-count, in-rmse) columns of tagged
    report lines across files, keyed by the frequency column."""
    sums: Dict[int, np.ndarray] = {}
    n = max(len(paths), 1)
    for p in paths:
        with open(p) as f:
            for line in f:
                if not line.startswith(tag):
                    continue
                cols = line.split()
                freq = int(cols[1])
                vals = np.array(list(map(float, cols[2:6])))
                sums.setdefault(freq, np.zeros(4))
                sums[freq] += vals
    return {k: v / n for k, v in sorted(sums.items())}


def average_freq_var_lines(paths: Sequence[str]
                           ) -> Dict[str, np.ndarray]:
    """avgVarLog.py (:1-54): average FreqVar report lines keyed by
    (variance, max-freq); value = (count, rmse, in-count, in-rmse, var)."""
    sums: Dict[str, np.ndarray] = {}
    n = max(len(paths), 1)
    for p in paths:
        with open(p) as f:
            for line in f:
                if not line.startswith("FreqVar"):
                    continue
                cols = line.split()
                key = cols[1] + "_" + cols[3]
                vals = np.array(list(map(float, cols[4:9])))
                sums.setdefault(key, np.zeros(5))
                sums[key] += vals
    return {k: v / n for k, v in sums.items()}


def prediction_abs_diff(pred_csv: str, test_triplets: str,
                        out_path: Optional[str] = None
                        ) -> List[tuple]:
    """compllormadiff.py (:1-31): |test - predicted| per (user, item)
    pair; predictions come as ``u,i,rating`` CSV, test as space
    triplets."""
    pred: Dict[tuple, float] = {}
    with open(pred_csv) as f:
        for line in f:
            cols = line.strip().split(",")
            if len(cols) >= 3:
                pred[(cols[0], cols[1])] = float(cols[2])
    out = []
    for line in open(test_triplets):
        cols = line.split()
        if len(cols) >= 3:
            u, i, r = cols[0], cols[1], float(cols[2])
            out.append((u, i, abs(r - pred[(u, i)])))
    if out_path:
        with open(out_path, "w") as g:
            for u, i, d in out:
                g.write(f"{u} {i} {d}\n")
    return out


def extract_dense_items(mat: RatingMatrix, min_ratings: int,
                        filter_users: bool = False) -> RatingMatrix:
    """extractDenseMat.py (:24-45): drop entries whose item (and, with
    filter_users, whose user) has <= min_ratings ratings; row count is
    preserved (the reference writes empty lines for dropped users)."""
    r, c, v = mat.to_coo()
    i_cnt = np.bincount(c, minlength=mat.ncols)
    keep = i_cnt[c] > min_ratings
    if filter_users:
        u_cnt = np.bincount(r, minlength=mat.nrows)
        keep &= u_cnt[r] > min_ratings
    return RatingMatrix.from_coo(r[keep], c[keep], v[keep],
                                 mat.nrows, mat.ncols)


def write_bpr_triplets(mat: RatingMatrix, out_path: str,
                       pos_value: float = 1.0) -> int:
    """toQMFTriplet.py (:6-16): emit ``u i 1`` triplets for entries
    whose value equals pos_value; returns the positive count."""
    r, c, v = mat.to_coo()
    keep = v == pos_value
    with open(out_path, "w") as g:
        for u, i in zip(r[keep], c[keep]):
            g.write(f"{u} {i} 1\n")
    return int(keep.sum())


def ppr_item_buckets_rmse(item_order: np.ndarray, u_fac: np.ndarray,
                          i_fac: np.ndarray, orig_u: np.ndarray,
                          orig_i: np.ndarray, n_buckets: int):
    """pprItemBucketsRMSE.py computeBucketsRMSE4mGlobal (:84-125):
    full-matrix per-item RMSE of est vs original factors, bucketed by a
    global item ordering (e.g. descending PPR). Vectorized: the per-item
    SE over all users is ||origU @ origI_i - U @ I_i||^2 computed as
    blocked matmuls. Returns (per-item RMSE in order, bucket RMSEs)."""
    n_users = u_fac.shape[0]
    item_order = np.asarray(item_order, np.int64)
    ses = np.empty(len(item_order), np.float64)
    B = 2048
    for s in range(0, len(item_order), B):
        idx = item_order[s:s + B]
        d = orig_u @ orig_i[idx].T - u_fac @ i_fac[idx].T
        ses[s:s + B] = np.sum(d * d, axis=0)
    rmses = np.sqrt(ses / n_users)
    per_bucket = max(len(item_order) // n_buckets, 1)
    buckets = []
    for s in range(0, len(item_order), per_bucket):
        chunk = ses[s:s + per_bucket]
        buckets.append(float(np.sqrt(chunk.sum()
                                     / (n_users * len(chunk)))))
    return rmses, buckets


def analyze_output_files(paths: Sequence[str]) -> Dict[str, float]:
    """analyzOpFiles.py getRMSEs (:39-141): average the final ``RE
    Train/Test/Val RMSE`` lines across run-output files (our CLI's
    protocol, eval/quartile.py)."""
    sums: Dict[str, list] = {}
    pat = re.compile(r"^RE (Train|Test|Val) RMSE:\s+([0-9.eE+-]+)")
    for p in paths:
        with open(p) as f:
            for line in f:
                m = pat.match(line.strip())
                if m:
                    k = m.group(1).lower() + "_rmse"
                    sums.setdefault(k, [0.0, 0])
                    sums[k][0] += float(m.group(2))
                    sums[k][1] += 1
    return {k: v[0] / v[1] for k, v in sums.items() if v[1]}


def read_user_stats(path: str) -> Dict[int, tuple]:
    """plotProbRMSE.getUserStats parity: whitespace rows of
    (user, nRatings, 2HopUsers, meanItemFreq, top500Count)."""
    out = {}
    with open(path) as f:
        for line in f:
            c = line.split()
            if not c:
                continue
            out[int(c[0])] = (int(c[1]), int(c[2]), float(c[3]),
                              int(c[4]))
    return out


def read_user_curves(path: str, log10: bool = False
                     ) -> Dict[int, np.ndarray]:
    """plotProbRMSE.getURMSEProbs parity: per-user curve rows
    ``user v0 v1 ...`` (log10-transform for the probability files)."""
    out = {}
    with open(path) as f:
        for line in f:
            c = line.split()
            if not c:
                continue
            v = np.asarray([float(x) for x in c[1:]], np.float64)
            out[int(c[0])] = np.log10(v) if log10 else v
    return out


def plot_prob_rmse_pdf(u_rmse: Dict[int, np.ndarray],
                       u_probs: Dict[int, np.ndarray],
                       u_stats: Dict[int, tuple],
                       pdf_path: str) -> int:
    """plotProbRMSE.savePlotsToPDF parity: one PDF page per user
    (ascending rating count) with the per-bucket RMSE curve and the
    log10 steady-state-probability curve side by side, shared y-limits
    across users. Returns the number of pages written."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    users = sorted(u_rmse, key=lambda u: (u_stats[u][0], u))
    max_rmse = max((float(np.max(v)) for v in u_rmse.values()),
                   default=1.0)
    all_p = [v for v in u_probs.values() if len(v)]
    lo = min((float(np.min(v)) for v in all_p), default=-1.0)
    hi = max((float(np.max(v)) for v in all_p), default=0.0)
    n = 0
    with PdfPages(pdf_path) as pp:
        for u in users:
            st = u_stats[u]
            fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 3.2))
            r = u_rmse[u]
            ax1.plot(range(len(r)), r)
            ax1.set_ylim(0, max_rmse)
            ax1.set_xlabel("buckets")
            ax1.set_ylabel("RMSE")
            ax1.grid(True)
            p = u_probs.get(u, np.zeros(0))
            ax2.plot(range(len(p)), p)
            ax2.set_ylim(lo, hi)
            ax2.set_xlabel("buckets")
            ax2.set_ylabel("avg steady-state prob (log10)")
            fig.suptitle(f"user: {u} ratings: {st[0]} 2Hop users: "
                         f"{st[1]} meanIFreq: {st[2]} topItems: {st[3]}")
            fig.tight_layout()
            pp.savefig(fig)
            plt.close(fig)
            n += 1
    return n
