"""Stage by stage, do the port's CUDA toolchain probes build, launch and
agree with their plain PyTorch versions on a GPU?

    python scripts/torch_cuda_bisect.py

Port of scripts/tpu_pallas_bisect.py. Stages 1-5 are the five kernels of
``matfac_tpu_torch/csrc/bisect_probes.cu`` (``ops/bisect_probes.py``), one
construct each, at the JAX probes' shapes: elementwise add one (128 x 128),
a grid of 2 blocks of a 256 x 256 product, a batch update scattering 256
bf16-rounded gradient rows into a [256, 64] table by row id, 4 blocks of
128 x 128 doubled through the permutation [2, 0, 3, 1], and a loop adding
one to 4 row slices of 128. Their inputs make every result exact in f32,
so each must equal its plain version exactly. Stage 6 runs the one-hot cell
kernel (``csrc/block_sgd.cu``) for one row-schedule epoch at 2048 x 1024
(density 0.02, k 32, 256-rating steps, 512-blocks) against the plain
version of that epoch, at rtol 1e-3 / atol 1e-5 (bf16 products summed in
another order: chip_smoke.py's bf16 class).

Each stage prints OK or FAIL with its max abs error; the script exits 1 if
any stage failed and 2 without a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch import Params, low_rank_ratings  # noqa: E402
from matfac_tpu_torch.models.base import ModelMF, init_state  # noqa: E402
from matfac_tpu_torch.ops import bisect_probes as bp  # noqa: E402
from matfac_tpu_torch.ops import block_sgd_kernel as bsk  # noqa: E402
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver  # noqa: E402
from matfac_tpu_torch.utils import freq  # noqa: E402

BF16_RTOL, BF16_ATOL = 1e-3, 1e-5


def stage(name: str, fn) -> bool:
    """Run one stage: ``fn`` returns (max abs error, err / tolerance, the
    tolerance in words); the stage holds when the ratio is at most 1."""
    t0 = time.time()
    try:
        err, ratio, tol = fn()
        ok = ratio <= 1.0
        print(f"{name}: {'OK' if ok else 'FAIL'} max_abs {err:.3e} "
              f"({tol}; {time.time() - t0:.1f} s)", flush=True)
        return ok
    except Exception as e:  # noqa: BLE001
        msg = str(e).splitlines()[0][:200] if str(e) else ""
        print(f"{name}: FAIL {type(e).__name__}: {msg}", flush=True)
        return False


def build():
    bp.library()
    return 0.0, 0.0, "nvcc"


def probe(fn, plain, args):
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    return err, 0.0 if err == 0 else float("inf"), "exact"


def block_epoch():
    """One row-schedule epoch of the block kernel and of its plain version
    from the same staged streams, tables and schedule."""
    n_users, n_items = 2048, 1024
    mat, _, _ = low_rank_ratings(n_users, n_items, k=4, density=0.02, seed=0,
                                 noise=0.1, nonneg=True)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    params = Params(fac_dim=32, u_reg=0.01, i_reg=0.01, learn_rate=0.01,
                    seed=0)
    model = ModelMF(params, n_users, n_items)
    solver = BlockSGDSolver(model, params, mat, iu, ii, batch_size=256,
                            bu=512, bi=512, collision_norm=True,
                            engine="pallas", device="cuda")
    u, i = solver.stage_factors(init_state(params, n_users, n_items,
                                           device="cuda"))
    args = (*solver.draw_schedule(), params.learn_rate, *solver.streams)
    kw = solver.sweep_kwargs()
    before = bsk.block_sgd_epoch.launches
    got = bsk.block_sgd_epoch(u.clone(), i.clone(), *args, **kw,
                              slices=solver.slices)
    assert bsk.block_sgd_epoch.launches == before + 1
    want = bsk.block_sweep_rows(u.clone(), i.clone(), *args, **kw)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ratio = max(float(((g - w).abs() / (BF16_ATOL + BF16_RTOL * w.abs()))
                      .max()) for g, w in zip(got, want))
    return err, ratio, f"rtol {BF16_RTOL} / atol {BF16_ATOL}"


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    ok = stage("build", build)
    gen = torch.Generator().manual_seed(0)
    for name, (fn, plain, args) in bp.stage_inputs(gen, "cuda").items():
        ok &= stage(name, lambda: probe(fn, plain, args))
    ok &= stage("6 block kernel, 2048 x 1024", block_epoch)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
