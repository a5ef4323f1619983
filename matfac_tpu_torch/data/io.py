"""Matrix, vector and factor IO: matfac_tpu/data/io.py's numpy code,
copied with its semantics (tests/test_torch_io.py and
tests/test_torch_data.py hold it to the originals: the same arrays, the
same draws, byte-identical files).

The item-item similarity graphs (cosine and Jaccard top-k) are computed
on the device.

GKlib text CSR format (as read by ``gk_csr_Read(..., GK_CSR_FMT_CSR,
GK_CSR_IS_VAL, 0)``, datastruct.cpp:16): line ``i`` holds row ``i`` as
whitespace-separated ``col val`` pairs with 0-indexed columns. As in the
JAX package, ``read_csr`` parses it with the native host library
(``utils/native.py``, the port's own build of the same C++), and with the
numpy line parser where that library is absent or refuses the file.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.utils import native


def read_csr(path: str, with_values: bool = True,
             ncols: Optional[int] = None) -> RatingMatrix:
    """Read a GKlib-text CSR file (gk_csr_Read analog).

    ``with_values=False`` reads an index-only file (one token per entry);
    the values are set to 1.0. The native parser reads the file first; a
    file it refuses goes through the line parser, which names the fault.
    """
    parsed = native.parse_csr_text(path, with_values)
    if parsed is not None:
        indptr, cols, vals = parsed
    else:
        indptr, cols, vals = _parse_lines(path, with_values)
    if ncols is None:
        ncols = int(cols.max()) + 1 if len(cols) else 0
    return RatingMatrix(indptr, cols.astype(np.int32),
                        vals.astype(np.float32), ncols)


def _parse_lines(path: str, with_values: bool):
    """(indptr, cols, vals) of a GKlib-text CSR file, line by line in
    numpy: the fallback of the native parser."""
    indptr_l = [0]
    cols_l, vals_l = [], []
    with open(path, "r") as f:
        for lineno, line in enumerate(f):
            parts = line.split()
            if with_values:
                if len(parts) % 2:
                    raise ValueError(
                        f"{path}:{lineno + 1}: odd token count "
                        f"({len(parts)}) — expected 'col val' pairs")
                cols_l.append(np.asarray(parts[0::2], dtype=np.int64))
                vals_l.append(np.asarray(parts[1::2], dtype=np.float32))
            else:
                cols_l.append(np.asarray(parts, dtype=np.int64))
            indptr_l.append(indptr_l[-1] + len(cols_l[-1]))
    indptr = np.asarray(indptr_l, dtype=np.int64)
    cols = (np.concatenate(cols_l) if cols_l else
            np.zeros(0, dtype=np.int64))
    if with_values:
        vals = (np.concatenate(vals_l) if vals_l else
                np.zeros(0, dtype=np.float32))
    else:
        vals = np.ones(len(cols), dtype=np.float32)
    return indptr, cols, vals


def write_csr(mat: RatingMatrix, path: str, with_values: bool = True) -> None:
    """Write GKlib-text CSR (gk_csr_Write analog): the bytes of the JAX
    package's writer, with each value formatted once (``_fmt``) and each row
    joined from slices of one list."""
    cols = mat.indices.tolist()
    if with_values:
        toks = [f"{c} {_fmt(v)}" for c, v in zip(cols, mat.values.tolist())]
    else:
        toks = [str(c) for c in cols]
    ptr = mat.indptr.tolist()
    with open(path, "w") as f:
        f.write("".join(" ".join(toks[a:b]) + "\n"
                        for a, b in zip(ptr[:-1], ptr[1:])))


def _fmt(v: float) -> str:
    fv = float(v)
    return str(int(fv)) if fv == int(fv) else f"{fv:g}"


# ----------------------------------------------------------------------
# factor matrices (text parity with reference readMat/writeMat,
# io.cpp:48-156: whitespace-separated floats, one row per line)
# ----------------------------------------------------------------------

def read_factor_mat(path: str, nrows: int, ncols: int) -> np.ndarray:
    data = np.loadtxt(path, dtype=np.float64)
    data = np.atleast_2d(data)
    if data.shape != (nrows, ncols):
        data = data.reshape(nrows, ncols)
    return data.astype(np.float32)


def write_factor_mat(mat: np.ndarray, path: str) -> None:
    np.savetxt(path, np.asarray(mat), fmt="%.7g")


def read_factor_mat_bin(path: str, nrows: Optional[int] = None,
                        ncols: Optional[int] = None) -> np.ndarray:
    """readMatBin analog (io.cpp:273-303): a headerless row-major stream
    of little-endian float64, nrows*ncols values — bit-compatible with
    files written by the reference binary. With nrows/ncols omitted the
    flat vector is returned (caller reshapes)."""
    raw = np.fromfile(path, dtype="<f8")
    if nrows is None or ncols is None:
        return raw.astype(np.float32)
    if raw.size < nrows * ncols:
        raise ValueError(f"{path}: {raw.size} values < {nrows}x{ncols}")
    return raw[: nrows * ncols].reshape(nrows, ncols).astype(np.float32)


def write_factor_mat_bin(mat: np.ndarray, path: str) -> None:
    """writeMatBin analog (io.cpp:157-184): raw little-endian float64
    row-major stream, no header — readable by the reference."""
    np.asarray(mat, dtype="<f8").tofile(path)


def read_vector(path: str) -> np.ndarray:
    """readVector analog (io.h): one float per line."""
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def write_vector(vec: np.ndarray, path: str) -> None:
    """writeVector analog (io.cpp:369-388): one value per line."""
    np.savetxt(path, np.asarray(vec).reshape(-1), fmt="%.7g")


# ----------------------------------------------------------------------
# splits / transforms
# ----------------------------------------------------------------------

def split_train_test_val(mat: RatingMatrix, test_pc: float, val_pc: float,
                         seed: int) -> Tuple[RatingMatrix, RatingMatrix,
                                             RatingMatrix]:
    """writeTrainTestValMat analog (io.cpp:410-459): color ``test_pc*nnz``
    random entries (with replacement → approximate count) as test, then
    ``val_pc*nnz`` distinct remaining entries as val; split keeps the full
    (nrows, ncols) shape for all three parts (gk_csr_Split semantics)."""
    nnz = mat.nnz
    rng = np.random.default_rng(seed)
    color = np.zeros(nnz, dtype=np.int8)
    n_test = int(test_pc * nnz)
    n_val = int(val_pc * nnz)
    # test: sample with replacement like the reference (duplicates collapse)
    color[rng.integers(0, nnz, size=n_test)] = 1
    i = 0
    while i < n_val:
        k = int(rng.integers(0, nnz))
        if color[k] == 0:
            color[k] = 2
            i += 1
    r, c, v = mat.to_coo()
    out = []
    for tag in (0, 1, 2):
        m = color == tag
        out.append(RatingMatrix.from_coo(r[m], c[m], v[m],
                                         mat.nrows, mat.ncols))
    return out[0], out[1], out[2]


def binarize(mat: RatingMatrix, thresh: float) -> RatingMatrix:
    """writeBinarizedTrainValTest analog (io.cpp:187): keep entries with
    value >= thresh at value 1, drop the rest."""
    r, c, v = mat.to_coo()
    m = v >= thresh
    return RatingMatrix.from_coo(r[m], c[m], np.ones(m.sum(), np.float32),
                                 mat.nrows, mat.ncols)


def subsample(mat: RatingMatrix, keep_pc: float, seed: int) -> RatingMatrix:
    """Random nnz subsample (writeSubSampledMat analog)."""
    rng = np.random.default_rng(seed)
    r, c, v = mat.to_coo()
    m = rng.random(mat.nnz) < keep_pc
    return RatingMatrix.from_coo(r[m], c[m], v[m], mat.nrows, mat.ncols)


def write_triplets(mat: RatingMatrix, path: str) -> None:
    """writeTriplets analog (io.cpp:1183-1191): ``u i r`` per line."""
    r, c, v = mat.to_coo()
    with open(path, "w") as f:
        f.write("".join(f"{u} {i} {_fmt(val)}\n"
                        for u, i, val in zip(r.tolist(), c.tolist(),
                                             v.tolist())))


def read_triplets(path: str, nrows: Optional[int] = None,
                  ncols: Optional[int] = None) -> RatingMatrix:
    data = np.loadtxt(path, dtype=np.float64)
    data = np.atleast_2d(data)
    r = data[:, 0].astype(np.int64)
    c = data[:, 1].astype(np.int64)
    v = data[:, 2].astype(np.float32)
    if nrows is None:
        nrows = int(r.max()) + 1 if len(r) else 0
    if ncols is None:
        ncols = int(c.max()) + 1 if len(c) else 0
    return RatingMatrix.from_coo(r, c, v, nrows, ncols)


def write_csr_with_model_values(mat: RatingMatrix, u_fac: np.ndarray,
                                i_fac: np.ndarray, path: str,
                                with_values: bool = True) -> None:
    """writeCSRWSparsityStructure analog (io.cpp:690-714): same sparsity
    pattern, values replaced by a factor model's predictions (float32
    numpy arrays; a caller holding tensors passes ``.cpu().numpy()``)."""
    r, c, _ = mat.to_coo()
    vals = np.einsum("ek,ek->e", u_fac[r], i_fac[c]).astype(np.float32)
    out = RatingMatrix.from_coo(r, c, vals, mat.nrows, mat.ncols)
    write_csr(out, path, with_values)


def tail_test_mat(mat: RatingMatrix, head_mask: np.ndarray,
                  max_ratings: int = 5000) -> RatingMatrix:
    """writeTailTestMat analog (io.cpp:~500): keep only tail-item test
    entries, capped at ``max_ratings`` total."""
    r, c, v = mat.to_coo()
    keep = ~head_mask[c]
    r, c, v = r[keep], c[keep], v[keep]
    if len(r) > max_ratings:
        r, c, v = r[:max_ratings], c[:max_ratings], v[:max_ratings]
    return RatingMatrix.from_coo(r, c, v, mat.nrows, mat.ncols)


def split_in_half(mat: RatingMatrix, seed: int
                  ) -> Tuple[RatingMatrix, RatingMatrix]:
    """splitValMat analog (main.cpp:1203-1231): random exact-half nnz
    split, both halves keeping the full shape."""
    rng = np.random.default_rng(seed)
    nnz = mat.nnz
    color = np.zeros(nnz, np.int8)
    color[rng.permutation(nnz)[: nnz // 2]] = 1
    r, c, v = mat.to_coo()
    a = RatingMatrix.from_coo(r[color == 0], c[color == 0], v[color == 0],
                              mat.nrows, mat.ncols)
    b = RatingMatrix.from_coo(r[color == 1], c[color == 1], v[color == 1],
                              mat.nrows, mat.ncols)
    return a, b


# ----------------------------------------------------------------------
# item-item similarity graphs (io.cpp:943-1060 writeItemSimMat /
# writeItemJaccSimMat / *Par): cosine or Jaccard over item columns, as a
# CSR adjacency with values, top-k sparsified. The item x item products
# run on the device in blocks of item rows, each a sparse x sparse
# product: the block's [B, n_users] item rows times the [n_users, n_items]
# user rows, whose work is the two-hop walk's (a product per item a block
# item's users rated), then densified to [B, n_items] for the top-k.
# ----------------------------------------------------------------------

# A row whose k-th and (k+1)-th device similarities are closer than this
# (relative) is settled on the host with the native rule; further apart,
# float64 summation order cannot swap them, nor can their float32 roundings
# meet.
_TIE_RTOL = 1e-6


def _segments(ptr: np.ndarray, ids: np.ndarray):
    """(positions, lengths) of the entries of segments ``ids`` of a pointer
    array, concatenated in the order of ``ids``."""
    lens = (ptr[ids + 1] - ptr[ids]).astype(np.int64)
    pos = (np.repeat(ptr[ids] - np.cumsum(lens) + lens, lens)
           + np.arange(lens.sum()))
    return pos, lens


def _sparse_csr(ptr, idx, vals, shape, dev) -> torch.Tensor:
    """A float64 CSR tensor made on ``dev`` (its invariants checked)."""
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(
        a.astype(dt))).to(dev)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor "
                                "support is in beta state")
        return torch.sparse_csr_tensor(
            as_t(ptr, np.int64), as_t(idx, np.int64),
            as_t(vals, np.float64), shape, check_invariants=True)


class _Products:
    """Float64 dot products of item columns on ``dev``: ``rows(ids)`` is the
    dense [len(ids), n_items] block of items ``ids`` against every item.
    ``ones`` takes every rating as 1 (support-set intersections)."""

    def __init__(self, mat: RatingMatrix, dev, ones: bool = False):
        self.mat, self.dev = mat, dev
        self.colptr, self.rowind, colval = mat.csc()
        self.colval = np.ones_like(colval) if ones else colval
        # the sparse product wants each row's columns sorted
        srt = mat if mat.is_sorted() else mat.sort_rows()
        self.user_rows = _sparse_csr(
            srt.indptr, srt.indices,
            np.ones_like(srt.values) if ones else srt.values,
            (mat.nrows, mat.ncols), dev)

    def rows(self, ids: np.ndarray) -> torch.Tensor:
        pos, lens = _segments(self.colptr, ids)
        block = _sparse_csr(np.concatenate([[0], np.cumsum(lens)]),
                            self.rowind[pos], self.colval[pos],
                            (len(ids), self.mat.nrows), self.dev)
        return (block @ self.user_rows).to_dense()


def _native_cosine_row(mat: RatingMatrix, norms: np.ndarray, i: int,
                       top_k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row i of the native library's cosine top-k (matfac_native.cpp:
    164-233), its arithmetic and tie rule reproduced: the two-hop walk
    (item i's users in CSC order, each user's items in row order) sums
    each neighbour's products in float64 in walk order; a neighbour enters
    the running list before the first slot whose float32 value its float64
    similarity exceeds. So the list is ordered by float32 value, and within
    a float32 value the neighbours whose float64 value exceeds it come
    first, the last touched first, then the rest in touch order. Returns
    (cols, float32 values) of the kept slots (value > 0)."""
    colptr, rowind, colval = mat.csc()
    users = rowind[colptr[i]:colptr[i + 1]]
    vi = colval[colptr[i]:colptr[i + 1]].astype(np.float64)
    pos, lens = _segments(mat.indptr, users.astype(np.int64))
    js = mat.indices[pos].astype(np.int64)
    prods = np.repeat(vi, lens) * mat.values[pos].astype(np.float64)
    keep = js != i
    js, prods = js[keep], prods[keep]
    if len(js) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    # bincount adds its weights in input order: the walk's float64 sums
    acc = np.bincount(js, weights=prods, minlength=mat.ncols)
    touched, first = np.unique(js, return_index=True)
    sim = acc[touched] / (norms[i] * norms[touched])
    f = sim.astype(np.float32)
    up = sim > f.astype(np.float64)
    order = np.lexsort((np.where(up, -first, first), ~up, -f))[:top_k]
    cols, vals = touched[order], f[order]
    return cols[vals > 0], vals[vals > 0]


def cosine_topk_rows(mat: RatingMatrix, items: np.ndarray, top_k: int = 50,
                     block: int = 1024, device="cuda"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The cosine top-k neighbours of ``items`` as COO (rows, cols, float32
    values), the edges of the native library's item_cosine_topk: float64
    products on ``device`` a block of rows at a time, each row's top k + 1
    by value, and the rows where the (k+1)-th value comes within _TIE_RTOL
    of the k-th (or, with negative ratings, a row with fewer than k + 1
    positive values, where a product sum near zero may keep its sign only
    in the native's order) recomputed on the host by the native rule
    (_native_cosine_row). Cosine of zero-norm items is taken with norm 1,
    no self edges, only values > 0 kept."""
    dev = torch.device(device)
    items = np.asarray(items, np.int64)
    colptr, _, colval = mat.csc()
    n_items = mat.ncols
    # bincount adds in CSC order, the native's order for the norms
    sq = np.bincount(np.repeat(np.arange(n_items), np.diff(colptr)),
                     weights=colval.astype(np.float64) ** 2,
                     minlength=n_items)
    norms = np.where(sq > 0, np.sqrt(sq), 1.0)
    products = _Products(mat, dev)
    norms_t = torch.from_numpy(norms).to(dev)
    mixed_sign = bool((colval < 0).any())
    kk = min(top_k + 1, n_items)
    rows_out, cols_out, vals_out, settle = [], [], [], []
    for s in range(0, len(items), block):
        ids = items[s:s + block]
        ids_t = torch.from_numpy(ids).to(dev)
        acc = products.rows(ids)                        # [B, n_items]
        sim = acc / (norms_t[ids_t][:, None] * norms_t[None, :])
        sim[torch.arange(len(ids), device=dev), ids_t] = 0.0
        v, c = torch.topk(sim, kk, dim=1)
        v, c = v.cpu().numpy(), c.cpu().numpy()
        if kk > top_k:
            vk, vk1 = v[:, top_k - 1], v[:, top_k]
            amb = (vk1 > 0) & (vk - vk1 <= _TIE_RTOL * np.abs(vk))
            if mixed_sign:
                amb |= vk1 <= 0
        else:
            amb = np.full(len(ids), mixed_sign)
        v, c = v[:, :top_k], c[:, :top_k]
        clear = ~amb[:, None] & (v.astype(np.float32) > 0)
        rows_out.append(np.broadcast_to(ids[:, None], v.shape)[clear])
        cols_out.append(c[clear])
        vals_out.append(v[clear].astype(np.float32))
        settle.extend(ids[amb].tolist())
    for i in settle:
        c, v = _native_cosine_row(mat, norms, i, top_k)
        rows_out.append(np.full(len(c), i, np.int64))
        cols_out.append(c)
        vals_out.append(v)
    cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if xs
                          else np.zeros(0, dt))
    return (cat(rows_out, np.int64), cat(cols_out, np.int64),
            cat(vals_out, np.float32))


def item_cosine_sim(mat: RatingMatrix, top_k: int = 50, block: int = 1024,
                    device="cuda") -> RatingMatrix:
    """writeItemSimMatPar analog: the n_items x n_items cosine top-k graph,
    the edges and float32 values of the JAX package's native path
    (cosine_topk_rows over every item)."""
    r, c, v = cosine_topk_rows(mat, np.arange(mat.ncols), top_k, block,
                               device)
    return RatingMatrix.from_coo(r, c, v, mat.ncols, mat.ncols)


def item_jaccard_sim(mat: RatingMatrix, top_k: int = 50, block: int = 1024,
                     device="cuda") -> RatingMatrix:
    """writeItemJaccSimMatPar analog (io.cpp:1027): |A∩B| / |A∪B| over the
    rating-support sets of item pairs, top-k per item row, no self edges,
    only values > 0 kept. The intersections are exact counts (float64
    products of 0/1 entries); the ratio is divided in float32, as the JAX
    package divides its float32 counts. Among equal values the kept
    neighbours are not defined (the JAX package's argpartition)."""
    dev = torch.device(device)
    n_items = mat.ncols
    k = min(top_k, n_items - 1)
    products = _Products(mat, dev, ones=True)
    sizes = torch.from_numpy(np.diff(mat.csc()[0]).astype(np.float32)).to(
        dev)
    rows_out, cols_out, vals_out = [], [], []
    for s in range(0, n_items, block):
        e = min(s + block, n_items)
        inter = products.rows(np.arange(s, e)).float()  # [B, n_items]
        union = sizes[s:e, None] + sizes[None, :] - inter
        union[union == 0] = 1.0
        sim = inter / union
        sim[torch.arange(e - s, device=dev),
            torch.arange(s, e, device=dev)] = 0.0
        v, c = torch.topk(sim, k, dim=1)
        v, c = v.cpu().numpy(), c.cpu().numpy()
        keep = v > 0
        rows_out.append(np.broadcast_to(np.arange(s, e)[:, None],
                                        v.shape)[keep])
        cols_out.append(c[keep])
        vals_out.append(v[keep])
    return RatingMatrix.from_coo(
        np.concatenate(rows_out), np.concatenate(cols_out),
        np.concatenate(vals_out), n_items, n_items)
