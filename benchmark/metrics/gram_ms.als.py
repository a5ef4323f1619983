"""Device ms an epoch in the bucketed ALS sweep's batched Gram and
right-hand-side products (``solvers/als._solve_bucket``'s two
``torch.bmm`` in f32, TF32 off) in the profiled sub-window. The kernels
are found by name, as cuBLAS picks them on one H100: the Grams in
``sm80_xmma_gemm_f32f32_*`` and ``cutlass_80_simt_sgemm_*``, the
right-hand sides (one output row a matrix) in ``internal::gemvx::kernel``
and ``gemvNSP_kernel``. Nothing to read where they did not run."""

KERNELS = ("gemm", "gemv")


def read(rec):
    prof = rec.get("prof")
    if not prof or not prof.get("epochs"):
        return None
    us = sum(o["self_device_us"] for o in prof["ops"] if o["on_device"]
             and any(k in o["name"] for k in KERNELS))
    return us / 1e3 / prof["epochs"] if us > 0 else None
