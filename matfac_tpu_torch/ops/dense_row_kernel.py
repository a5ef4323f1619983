"""Row-stripe dense SGD epoch: the hand-written CUDA kernel's wrapper.

Port of matfac_tpu/ops/dense_row_kernel.py. Its two Pallas TPU kernels
(``dense_rows_epoch_pallas`` on float R+W tiles, ``dense_rows_codes_pallas``
on int8 rating codes) become ONE CUDA kernel templated on tile type,
``csrc/dense_rows.cu`` (design and cost notes there). Not carried over:
the bf16-resident item table of the codes kernel (the port keeps f32
tables, as JAX's default XLA path does), the panel-major relayout and the
sequential grid — they were TPU VMEM and DMA workarounds.

``dense_rows_epoch`` takes the tensors' device as the route: a CPU tensor
runs the plain ``dense_sweep_rows``; a CUDA tensor launches the kernel or
raises. ``dense_rows_epoch.launches`` counts kernel launches (two per
stripe: the panel kernel and the user-reduction kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.ops.dense_block_kernel import dense_sweep_rows

KERNELS_PER_STRIPE = 2     # panel kernel + user-reduction kernel
_RTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_SIGNATURES = {
    "dense_rows_stripe": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # rtype, mm, cn
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # u3, i_tab, R
        ctypes.c_void_p, ctypes.c_void_p,                   # W, scratch
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # stripe, bu, ni
        ctypes.c_int,                                       # k
        ctypes.c_float, ctypes.c_float, ctypes.c_float,     # lr, r_scale, u_reg
        ctypes.c_float, ctypes.c_void_p]),                  # i_reg, stream
    "dense_rows_scratch_floats": (ctypes.c_size_t, [ctypes.c_int] * 3),
    "dense_rows_smem_bytes": (ctypes.c_size_t, [ctypes.c_int, ctypes.c_int]),
    "dense_rows_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc on first use)."""
    return _build.load("dense_rows", _SIGNATURES)


def _check(u3, i_tab, row_order, R_rows, W_rows, r_scale):
    if u3.dim() != 3 or i_tab.dim() != 2 or R_rows.dim() != 3:
        raise ValueError("want u3 [NU, bu, k], i_tab [ni_pad, k], "
                         "R_rows [NU, bu, ni_pad]")
    NU, bu, k = u3.shape
    ni_pad = i_tab.shape[0]
    if i_tab.shape[1] != k or tuple(R_rows.shape) != (NU, bu, ni_pad):
        raise ValueError(f"shape mismatch: u3 {tuple(u3.shape)}, i_tab "
                         f"{tuple(i_tab.shape)}, R_rows "
                         f"{tuple(R_rows.shape)}")
    if W_rows is None:
        if R_rows.dtype != torch.int8 or r_scale is None:
            raise ValueError("W_rows=None means int8 rating codes in "
                             "R_rows with an r_scale")
    elif W_rows.shape != R_rows.shape:
        raise ValueError("W_rows must have R_rows' shape")
    tabs = [u3, i_tab, R_rows] + ([] if W_rows is None else [W_rows])
    if any(t.device != u3.device for t in tabs):
        raise ValueError("u3, i_tab, R_rows and W_rows must share a device")
    if any(not t.is_contiguous() for t in tabs):
        raise ValueError("u3, i_tab, R_rows and W_rows must be contiguous")
    if u3.dtype != torch.float32 or i_tab.dtype != torch.float32:
        raise ValueError("factor tables must be float32")
    if row_order.dim() != 1 or row_order.numel() != NU or \
            row_order.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"row_order must be [{NU}] integer stripe ids")
    if NU and not (0 <= int(row_order.min()) and int(row_order.max()) < NU):
        raise ValueError(f"row_order has stripe ids outside [0, {NU})")


def dense_rows_epoch(u3: torch.Tensor, i_tab: torch.Tensor,
                     row_order: torch.Tensor, lr,
                     R_rows: torch.Tensor, W_rows: Optional[torch.Tensor],
                     r_scale: Optional[float], u_reg: float, i_reg: float,
                     collision_norm: bool, mm_bf16: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One row-stripe dense epoch over the stripes of ``row_order``.

    u3 [NU, bu, k] f32, i_tab [ni_pad, k] f32, R_rows [NU, bu, ni_pad]
    (f32/bf16 ratings with int8 validity W_rows, or int8 codes with
    W_rows=None and r_scale). Updates u3 and i_tab IN PLACE and returns
    them. On the card the kernel takes f32/bf16 R with int8 W, or codes;
    float weights (IFWMF) arrive with ROADMAP queue 1, item 7."""
    _check(u3, i_tab, row_order, R_rows, W_rows, r_scale)
    if u3.device.type == "cpu":
        return dense_sweep_rows(u3, i_tab, row_order, lr, R_rows, W_rows,
                                u_reg, i_reg, collision_norm, mm_bf16,
                                r_scale=r_scale)
    if u3.device.type != "cuda":
        raise ValueError(f"no route for device {u3.device}")
    if R_rows.dtype not in _RTYPES or (
            W_rows is not None and (W_rows.dtype != torch.int8
                                    or R_rows.dtype == torch.int8)):
        raise ValueError("the CUDA kernel takes f32/bf16 R with int8 W "
                         "(float W is ROADMAP queue 1, item 7)")
    NU, bu, k = u3.shape
    ni_pad = i_tab.shape[0]
    lib = library()
    # per-panel partials of the user gradient, sized by the kernel's own
    # layout; torch's caching allocator hands back the same block every
    # epoch
    scratch = torch.empty(lib.dense_rows_scratch_floats(bu, ni_pad, k),
                          dtype=torch.float32, device=u3.device)
    r_ptr = R_rows.data_ptr()
    w_ptr = None if W_rows is None else W_rows.data_ptr()
    rtype = _RTYPES[R_rows.dtype]
    with torch.cuda.device(u3.device):
        stream = torch.cuda.current_stream().cuda_stream
        for s in row_order.tolist():
            err = lib.dense_rows_stripe(
                rtype, int(mm_bf16), int(collision_norm), u3.data_ptr(),
                i_tab.data_ptr(), r_ptr, w_ptr, scratch.data_ptr(), s, bu,
                ni_pad, k, float(lr), float(r_scale or 0.0), float(u_reg),
                float(i_reg), stream)
            if err != 0:
                msg = lib.dense_rows_error_string(err).decode()
                smem = lib.dense_rows_smem_bytes(k, int(mm_bf16))
                raise RuntimeError(
                    f"dense_rows kernel launch failed on stripe {s}: {msg} "
                    f"(cudaError {err}; {smem} B shared memory per block)")
            dense_rows_epoch.launches += KERNELS_PER_STRIPE
    return u3, i_tab


dense_rows_epoch.launches = 0
