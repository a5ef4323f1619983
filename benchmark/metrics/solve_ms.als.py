"""Device ms an epoch in the bucketed ALS sweep's batched Cholesky
factorizations and triangular solves (``solvers/als.cholesky_nan`` and
``chol_solve``) in the profiled sub-window. The kernels are found by name,
as ``torch.linalg.cholesky_ex`` and ``solve_triangular`` launch them on
one H100: cuSOLVER's ``potrf_syrk_T16_nc_kernel``,
``potrf_cta_lower_batch``, ``potrfBatch_trsm_lower``, ``potrf_reset_info``
and ``potrf_set_info``, cuBLAS's ``batch_trsm_left_kernel`` and, for small
batches, ``trsv_*`` and ``dtrsv_init*``. Nothing to read where they did not
run."""

KERNELS = ("potrf", "trsm", "trsv")


def read(rec):
    prof = rec.get("prof")
    if not prof or not prof.get("epochs"):
        return None
    us = sum(o["self_device_us"] for o in prof["ops"] if o["on_device"]
             and any(k in o["name"] for k in KERNELS))
    return us / 1e3 / prof["epochs"] if us > 0 else None
