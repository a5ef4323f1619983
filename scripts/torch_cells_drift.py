"""How far the dense diag cell grid's kernel and its plain version drift
apart over an epoch at (w)'s shape, on the card.

    python scripts/torch_cells_drift.py

chip_smoke.py's (w) grid (bu 2560 x bi 512 on (d)'s data, 1,601 cells of
bf16 R + int8 W) from the initial state, one epoch's rounds from a fixed
generator: the kernel (`StripeTiles.cells_epoch`) against `dense_sweep_diag`
after the first 1, 2, 5, 10, 20 and 40 rounds in bf16 products, the whole
epoch in f32 products, and the plain version on the card against the
plain version on the CPU (two correct summation orders). Each line gives
max abs / rel error and err/tol at chip_smoke.py's RTOL / ATOL and at
W_BF16_RTOL / W_BF16_ATOL, the class (w) holds the whole bf16 epoch to.
About two minutes; exits non-zero without a CUDA device.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from matfac_tpu_torch import Params  # noqa: E402
from matfac_tpu_torch.models.base import ModelMF, init_state  # noqa: E402
from matfac_tpu_torch.ops import block_sgd_kernel as bsk  # noqa: E402
from matfac_tpu_torch.ops import dense_row_kernel as drk  # noqa: E402
from matfac_tpu_torch.ops.dense_block_kernel import \
    dense_sweep_diag  # noqa: E402
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver  # noqa: E402
from matfac_tpu_torch.utils import freq  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    cs.phase_env()
    cs.phase_build()
    data = cs.bench_data(**cs.CELLS["d"][0])
    p = Params(**cs.CELLS["d"][1])
    n, m = data.n_users, data.n_items
    iu, ii = freq.invalid_users_items(data.train_mat, n, m)
    solver = BlockSGDSolver(ModelMF(p, n, m), p, data.train_mat, iu, ii,
                            bu=cs.W_BLOCKS[0], bi=cs.W_BLOCKS[1],
                            engine="dense", device="cuda")
    tiles = solver.tiles
    R, W = tiles.R, tiles.W
    ub_idx = bsk.diag_schedule(torch.Generator().manual_seed(1), solver.NU,
                               solver.NI, 1)[0]
    u3, i3 = solver.stage_factors(init_state(p, n, m, device="cuda"))
    cn = solver.collision_norm

    staged = {tiles.mm_bf16: tiles}

    def kernel(rounds, mm):
        if mm not in staged:     # the same tiles in the other precision
            staged[mm] = drk.StripeTiles(R, W, None, tiles.k, p.u_reg,
                                         p.i_reg, cn, mm, NI=tiles.NI)
        return staged[mm].cells_epoch(u3.clone(), i3.clone(), rounds,
                                      p.learn_rate)

    def plain(rounds, mm, dev="cuda"):
        args = [t.to(dev, copy=True) for t in (u3, i3)]   # updated in place
        return dense_sweep_diag(*args, rounds, p.learn_rate, R.to(dev),
                                W.to(dev), p.u_reg, p.i_reg, cn, mm)

    def report(what, got, want):
        got, want = [t.cpu() for t in got], [t.cpu() for t in want]
        a, r, ratio = cs._errors(got, want)
        wide = cs._errors(got, want, cs.W_BF16_RTOL, cs.W_BF16_ATOL)[2]
        cs.log(f"{what}: max_abs {a:.3e} max_rel {r:.3e} err/tol "
               f"{ratio:.3e} (rtol {cs.RTOL}, atol {cs.ATOL}), {wide:.3e} "
               f"(rtol {cs.W_BF16_RTOL}, atol {cs.W_BF16_ATOL})")

    for n_rounds in (1, 2, 5, 10, 20, ub_idx.shape[0]):
        rounds = ub_idx[:n_rounds]
        report(f"bf16 products, kernel vs plain after {n_rounds} rounds",
               kernel(rounds, True), plain(rounds, True))
    report("f32 products, kernel vs plain, the epoch",
           kernel(ub_idx, False), plain(ub_idx, False))
    t0 = time.perf_counter()
    on_cpu = plain(ub_idx, True, "cpu")
    cs.log(f"the plain epoch on the CPU in {time.perf_counter() - t0:.1f} s")
    report("bf16 products, plain on the card vs plain on the CPU, the "
           "epoch", plain(ub_idx, True), on_cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
