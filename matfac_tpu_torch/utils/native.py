"""ctypes bindings of the port's native host library (port of
matfac_tpu/utils/native.py).

``csrc/native_host.cpp`` is the port's copy of the JAX package's
``native/matfac_native.cpp``: an OpenMP GKlib-text CSR parser and the
two-hop item-item cosine top-k builder. ``ops/_build.py`` compiles it with
the host C++ compiler into ``build/matfac_tpu_torch/`` on first use (never
into ``native/``). Where no host compiler exists the functions return None
and the callers take their numpy routes, as the JAX package does without
its library; where a compiler exists and the build fails, the build's
RuntimeError (with the compiler's output) propagates.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from matfac_tpu_torch.ops import _build

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_LL = ctypes.c_longlong

_SIGNATURES = {
    "mfio_parse_csr_count": (_LL, (ctypes.c_char_p, ctypes.c_int,
                                   ctypes.POINTER(_LL))),
    "mfio_parse_csr_fill": (ctypes.c_int, (ctypes.c_char_p, ctypes.c_int,
                                           _LL, _LL, _I64, _I32, _F32)),
    "mfio_item_cosine_topk2": (ctypes.c_int, (
        _LL, _LL, _I64, _I32, _F32, _I64, _I32, _F32, ctypes.c_int, _I32,
        _F32)),
}


def _lib() -> Optional[ctypes.CDLL]:
    if _build.host_compiler() is None:
        return None
    return _build.load("native_host", _SIGNATURES)


def available() -> bool:
    """Whether the library builds and loads here (False without a host
    C++ compiler)."""
    return _lib() is not None


def parse_csr_text(path: str, with_values: bool
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(indptr int64, cols int32, vals float32) of a GKlib-text CSR file,
    or None (no library, no such file, an odd token count or a malformed
    token): the caller then falls back to its line parser."""
    lib = _lib()
    if lib is None or not os.path.exists(path):
        return None
    nrows = _LL(0)
    nnz = lib.mfio_parse_csr_count(path.encode(), int(with_values),
                                   ctypes.byref(nrows))
    if nnz < 0:
        return None
    indptr = np.zeros(nrows.value + 1, dtype=np.int64)
    cols = np.zeros(nnz, dtype=np.int32)
    vals = np.ones(nnz, dtype=np.float32)
    rc = lib.mfio_parse_csr_fill(path.encode(), int(with_values),
                                 nrows.value, nnz, indptr, cols, vals)
    if rc != 0:
        return None
    return indptr, cols, vals


def item_cosine_topk(colptr, rowind, colval, rowptr, colind, rowval,
                     n_items: int, n_users: int, top_k: int):
    """Two-hop item-item cosine top-k: (cols int32 [n_items, top_k], -1
    padded; vals float32), or None without the library."""
    lib = _lib()
    if lib is None:
        return None
    out_cols = np.full(n_items * top_k, -1, np.int32)
    out_vals = np.zeros(n_items * top_k, np.float32)
    rc = lib.mfio_item_cosine_topk2(
        n_items, n_users, np.ascontiguousarray(colptr, np.int64),
        np.ascontiguousarray(rowind, np.int32),
        np.ascontiguousarray(colval, np.float32),
        np.ascontiguousarray(rowptr, np.int64),
        np.ascontiguousarray(colind, np.int32),
        np.ascontiguousarray(rowval, np.float32),
        top_k, out_cols, out_vals)
    if rc != 0:
        return None
    return out_cols.reshape(n_items, top_k), out_vals.reshape(n_items,
                                                              top_k)
