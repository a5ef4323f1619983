"""Toolchain probes: the hand-written CUDA kernels' wrappers and their plain
PyTorch versions.

Port of the five ``pl.pallas_call`` sites of scripts/tpu_pallas_bisect.py
(Pallas constructs one at a time: elementwise, grid + BlockSpec, the one-hot
batch update, scalar prefetch, a loop over dynamic slices). Each becomes a
small kernel of ``csrc/bisect_probes.cu`` computing the same function; no
path of the system runs them. ``scripts/torch_cuda_bisect.py`` runs them
stage by stage.

Each wrapper takes its tensors' device as the route: a CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises. Each counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from matfac_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "probe_add_one": (_I, [_P, _P, _I, _P]),
    "probe_grid_matmul": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    "probe_batch_update": (_I, [_P, _P, _P, _P, _I, _I, _I, _P]),
    "probe_prefetch_double": (_I, [_P, _P, _P, _I, _I, _P]),
    "probe_slice_loop": (_I, [_P, _P, _I, _I, _P]),
    "probe_error_string": (ctypes.c_char_p, [_I]),
}


def library() -> ctypes.CDLL:
    """The built and loaded probe library (nvcc on first use)."""
    return _build.load("bisect_probes", _SIGNATURES)


def _run(fn, name: str, *args) -> None:
    lib = library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.probe_error_string(err).decode()} "
                           f"(cudaError {err})")
    fn.launches += 1


def _route(*tabs) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version."""
    dev = tabs[0].device
    if any(t.device != dev or not t.is_contiguous() for t in tabs):
        raise ValueError("inputs must be contiguous and share a device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for device {dev}")
    return dev.type == "cuda"


def _f32(*tabs) -> None:
    if any(t.dtype != torch.float32 for t in tabs):
        raise ValueError("probe data must be float32")


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 (tpu_pallas_bisect.py:49)."""
    _f32(x)
    if not _route(x):
        return add_one_plain(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _run(add_one, "probe_add_one", x.data_ptr(), out.data_ptr(),
             x.numel())
    return out


def grid_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                      rows: int = 128) -> torch.Tensor:
    return a @ b


def grid_matmul(a: torch.Tensor, b: torch.Tensor,
                rows: int = 128) -> torch.Tensor:
    """a [M, K] @ b [K, N] on a grid of M / rows blocks, each a band of
    ``rows`` output rows (tpu_pallas_bisect.py:59)."""
    _f32(a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or \
            a.shape[0] % rows:
        raise ValueError("want a [M, K], b [K, N], M a multiple of rows")
    if not _route(a, b):
        return grid_matmul_plain(a, b, rows)
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _run(grid_matmul, "probe_grid_matmul", a.data_ptr(), b.data_ptr(),
             out.data_ptr(), M, K, N, rows)
    return out


def batch_update_plain(ids: torch.Tensor, g: torch.Tensor,
                       tab: torch.Tensor) -> torch.Tensor:
    upd = torch.zeros_like(tab).index_add_(0, ids.long(),
                                           g.bfloat16().float())
    return tab + upd


def batch_update(ids: torch.Tensor, g: torch.Tensor,
                 tab: torch.Tensor) -> torch.Tensor:
    """tab + the rows of g, rounded to bf16, added by row id (ids [bs]
    int32 in [0, rows), g [bs, k], tab [rows, k]; tpu_pallas_bisect.py:80)."""
    _f32(g, tab)
    if ids.dtype != torch.int32 or ids.dim() != 1 or g.dim() != 2 or \
            tab.dim() != 2 or g.shape != (ids.numel(), tab.shape[1]):
        raise ValueError("want ids [bs] int32, g [bs, k], tab [rows, k]")
    if ids.numel() and (int(ids.min()) < 0 or
                        int(ids.max()) >= tab.shape[0]):
        raise ValueError(f"ids must lie in [0, {tab.shape[0]})")
    if not _route(ids, g, tab):
        return batch_update_plain(ids, g, tab)
    out = torch.empty_like(tab)
    with torch.cuda.device(tab.device):
        _run(batch_update, "probe_batch_update", ids.data_ptr(),
             g.data_ptr(), tab.data_ptr(), out.data_ptr(), ids.numel(),
             tab.shape[0], tab.shape[1])
    return out


def prefetch_double_plain(sel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    out[sel.long()] = x[sel.long()] * 2.0
    return out


def prefetch_double(sel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """2 x each block of x [nb, ...], block t of the grid reaching block
    sel[t] (sel int32, a permutation of [0, nb); tpu_pallas_bisect.py:96)."""
    _f32(x)
    nb = x.shape[0]
    if sel.dtype != torch.int32 or not torch.equal(
            torch.sort(sel.cpu()).values, torch.arange(nb, dtype=torch.int32)):
        raise ValueError(f"sel must be an int32 permutation of [0, {nb})")
    if not _route(sel, x):
        return prefetch_double_plain(sel, x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _run(prefetch_double, "probe_prefetch_double", sel.data_ptr(),
             x.data_ptr(), out.data_ptr(), nb, x[0].numel())
    return out


def slice_loop_plain(x: torch.Tensor, n_slices: int) -> torch.Tensor:
    out = x.clone()
    rows = x.shape[0] // n_slices
    for j in range(n_slices):
        out[j * rows:(j + 1) * rows] += 1.0
    return out


def slice_loop(x: torch.Tensor, n_slices: int) -> torch.Tensor:
    """A copy of x with 1 added to each of its n_slices row slices, one
    slice after another in a loop inside one block (tpu_pallas_bisect.py:115).
    """
    _f32(x)
    if n_slices < 1 or x.shape[0] % n_slices:
        raise ValueError("the rows must split into n_slices equal slices")
    if not _route(x):
        return slice_loop_plain(x, n_slices)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _run(slice_loop, "probe_slice_loop", x.data_ptr(), out.data_ptr(),
             n_slices, x.numel() // n_slices)
    return out


PROBES = (add_one, grid_matmul, batch_update, prefetch_double, slice_loop)
for _fn in PROBES:
    _fn.launches = 0


def stage_inputs(gen: torch.Generator, dev) -> dict:
    """Each probe's inputs at the JAX probes' shapes, from ``gen``, chosen
    so that every result is exact in f32 in any summation order (integer
    matmul operands; gradients multiples of 1/64 that bf16 holds exactly):
    kernel and plain version must agree exactly.
    {stage: (probe, plain, args)}."""
    ints = lambda *shape: torch.randint(-4, 5, shape, generator=gen).float()
    args = {
        "1 elementwise": (add_one, add_one_plain,
                          (torch.randn((128, 128), generator=gen),)),
        "2 grid matmul": (grid_matmul, grid_matmul_plain,
                          (ints(256, 256), ints(256, 256))),
        "3 batch update": (batch_update, batch_update_plain, (
            torch.randint(0, 16, (256,), generator=gen).to(torch.int32),
            torch.randint(-128, 129, (256, 64), generator=gen) / 64.0,
            torch.randn((256, 64), generator=gen))),
        "4 scalar prefetch": (prefetch_double, prefetch_double_plain, (
            torch.tensor([2, 0, 3, 1], dtype=torch.int32),
            torch.randn((4, 128, 128), generator=gen))),
        "5 slice loop": (slice_loop, slice_loop_plain,
                         (torch.randn((512, 128), generator=gen), 4)),
    }
    return {name: (fn, plain, tuple(a.to(dev) if torch.is_tensor(a) else a
                                    for a in a_))
            for name, (fn, plain, a_) in args.items()}
