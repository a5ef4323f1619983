"""Matrix and factor IO: the parts of matfac_tpu/data/io.py that the port
calls, copied (tests/test_torch_data.py holds them to the originals).

GKlib text CSR format (as read by ``gk_csr_Read(..., GK_CSR_FMT_CSR,
GK_CSR_IS_VAL, 0)``, datastruct.cpp:16): line ``i`` holds row ``i`` as
whitespace-separated ``col val`` pairs with 0-indexed columns. The JAX
package parses it with an optional native helper and falls back to numpy;
the port keeps the numpy parser, which reads the same matrix.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from matfac_tpu_torch.data.csr import RatingMatrix


def read_csr(path: str, with_values: bool = True,
             ncols: Optional[int] = None) -> RatingMatrix:
    """Read a GKlib-text CSR file (gk_csr_Read analog).

    ``with_values=False`` reads an index-only file (one token per entry);
    the values are set to 1.0.
    """
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
    if ncols is None:
        ncols = int(cols.max()) + 1 if len(cols) else 0
    return RatingMatrix(indptr, cols.astype(np.int32),
                        vals.astype(np.float32), ncols)


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


def write_vector(vec: np.ndarray, path: str) -> None:
    """writeVector analog (io.cpp:369-388): one value per line."""
    np.savetxt(path, np.asarray(vec).reshape(-1), fmt="%.7g")


# ----------------------------------------------------------------------
# splits
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
