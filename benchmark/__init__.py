"""The benchmark of matfac_tpu_torch (see run.py and PERF.md)."""
