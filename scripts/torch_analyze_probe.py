"""Analyze mode alone on the card: (d)'s data and splits, a stand-in
trained checkpoint, then chip_smoke.py's phase (v).

    python scripts/torch_analyze_probe.py

The stand-in factors are random (seed 0, scale 0.1): phase (v) reads the
checkpoint that phase (u)'s tmf_bias run writes, which this script writes
in its place, so the analysis path runs on the card in about two minutes
instead of the whole smoke's ten. Exits non-zero without a CUDA device.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from matfac_tpu_torch.data import io as mfio  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    cs.phase_env()
    t0 = time.perf_counter()
    data = cs.bench_data(**cs.CELLS["d"][0])
    d = os.path.join(cs.RUN_DIR, "cli")
    os.makedirs(d, exist_ok=True)
    for name in ("train", "test", "val"):
        mfio.write_csr(getattr(data, f"{name}_mat"),
                       os.path.join(d, f"{name}.csr"))
    rng = np.random.default_rng(0)
    for side, n in (("uFac", data.n_users), ("iFac", data.n_items)):
        mfio.write_factor_mat(
            rng.normal(0, 0.1, (n, 64)).astype(np.float32),
            os.path.join(d, f"{cs.CLI_CKPT_RUN}_{side}_standin.mat"))
    cs.log(f"set-up {time.perf_counter() - t0:.1f} s")
    cs.phase_analyze(data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
