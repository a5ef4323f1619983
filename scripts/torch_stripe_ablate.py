"""Where the stripe kernel's time goes: its int8-codes instantiation cut
after each stage, on one NVIDIA GPU, for the stripe entry and for the
cell-grid entry over the same users.

    python scripts/torch_stripe_ablate.py [--layout stripes cells]

The port of scripts/tpu_pallas_codes_ablate.py, at its shape: 40 stripes
of 2,560 users, 157 panels of 128 items (20,096), k = 64, codes drawn
uniformly from {0, 1, 2} (r_scale 0.5), the stripes in order; and the
cell grid of chip_smoke.py cell (w) over the same 102,400 users: 40 x 40
cells of 2,560 users x 512 items (20,480 items, the dummy cell last), one
epoch of diag-schedule rounds (a panel and a step launch a round). Each
stage is a template instantiation of the same source (csrc/dense_rows.cu,
exported as ``dense_rows_ablate``):

  stream  tile and bf16 U chunk loads only (the cp.async ring), after
          the epoch's one bf16 copy of U;
  pmm     + P = U I^T on the tensor cores;
  elem    + E = W (R - P) in P's epilogue, E to shared memory;
  item    + Gi += E^T U and its atomics;
  full    + Gu = E I with its atomics, and the step kernel (items and
          users).

It prints the card's name and power limit, then per layout and stage the
epoch's device time (CUDA events, min of 3 after a warm-up) and what the
stage added, the full epoch's device ms by kernel (torch.profiler), and
the epoch's bound on this card (codes read once, U and I read and
written once, or 6k FLOP a slot at the bf16 tensor-core peak).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch.ops import block_sgd_kernel as bsk  # noqa: E402
from matfac_tpu_torch.ops import dense_row_kernel as drk  # noqa: E402

NU, BU, N_PANELS, K = 40, 2560, 157, 64
NI, BI = 40, 512          # the cell grid: lanes of 512 items
STAGES = ("stream", "pmm", "elem", "item", "full")
LR, R_SCALE, REG = 0.005, 0.5, 0.001
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
KERNELS = ("panel_kernel", "step_kernel", "u_bf16_kernel")


def layout(name: str, gen):
    """(codes, u3, i_tab, cells, counts, n_rounds, lanes): the stripes in
    order, or one epoch of the cell grid's rounds."""
    if name == "stripes":
        codes = torch.randint(0, 3, (NU, BU, N_PANELS * 128), generator=gen,
                              device="cuda", dtype=torch.int8)
        order = torch.arange(NU, dtype=torch.int64)
        return (codes, drk.stripe_cells(order, "cuda"), None, NU, 1,
                N_PANELS * 128)
    codes = torch.randint(0, 3, (NU * NI + 1, BU, BI), generator=gen,
                          device="cuda", dtype=torch.int8)
    codes[-1] = 0
    rounds = bsk.diag_schedule(torch.Generator().manual_seed(1), NU, NI,
                               1)[0]
    plan = drk.cells_plan(rounds, NU, K, True)
    return (codes, plan["cells"].to("cuda"), plan["counts"],
            rounds.shape[0], NI, BI)


def epoch_ms(lib, stage: int, u3, i_tab, codes, cells, counts, n_rounds,
             lanes, reps: int = 3):
    """Min over ``reps`` of one epoch's CUDA-event ms, after a warm-up,
    and the run function."""
    cnt_u, cnt_i = drk.stripe_counts(codes, None)
    ni = codes.shape[2]
    scratch = torch.zeros(lib.dense_rows_scratch_bytes(lanes, NU, BU, ni, K,
                                                       1),
                          dtype=torch.uint8, device="cuda")
    failed, launched = ctypes.c_longlong(-1), ctypes.c_longlong(0)

    def run():
        err = lib.dense_rows_ablate(
            stage, u3.data_ptr(), i_tab.data_ptr(), codes.data_ptr(),
            cnt_u.data_ptr(), cnt_i.data_ptr(), scratch.data_ptr(),
            cells.data_ptr(), None if counts is None else counts.data_ptr(),
            n_rounds, lanes, NU, BU, ni, K, LR, R_SCALE, REG, REG,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(failed),
            ctypes.byref(launched))
        if err:
            raise RuntimeError(f"stage {STAGES[stage]}: "
                               f"{lib.dense_rows_error_string(err).decode()}"
                               f" on round {failed.value}")

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return min(times), times, run


def device_ms(fn) -> dict:
    """Device ms of the stripe source's kernels in one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in KERNELS}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in KERNELS:
                if name in e.name:
                    out[name] += e.time_range.elapsed_us() / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", nargs="+", default=["stripes", "cells"],
                    choices=["stripes", "cells"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stripe_ablate: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = drk.library()
    for name in args.layout:
        gen = torch.Generator(device="cuda").manual_seed(0)
        codes, cells, counts, n_rounds, lanes, ni = layout(name, gen)
        u3 = 0.1 * torch.randn((NU, BU, K), generator=gen, device="cuda")
        i_tab = 0.1 * torch.randn((lanes * ni, K), generator=gen,
                                  device="cuda")
        slots = NU * BU * lanes * ni
        nbytes = slots + 2 * 4 * K * (NU * BU + i_tab.shape[0])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 6.0 * slots * K / BF16_FLOPS * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{name}: {n_rounds} rounds of {lanes} lane(s), {NU} user "
              f"blocks of {BU}, {i_tab.shape[0]} items, k={K}; bound "
              f"{max(t_bytes, t_ops):.3f} ms ({by}: {t_bytes:.3f} ms of "
              f"bytes, {t_ops:.3f} ms of bf16 FLOP)", flush=True)
        print("| stage | ms per epoch (min of 3) | added | runs (ms) |")
        print("|---|---|---|---|")
        prev = 0.0
        for stage, st in enumerate(STAGES):
            ms, runs, run = epoch_ms(lib, stage, u3, i_tab, codes, cells,
                                     counts, n_rounds, lanes)
            print(f"| {st} | {ms:.3f} | {ms - prev:+.3f} | "
                  f"{', '.join(f'{t:.3f}' for t in runs)} |", flush=True)
            prev = ms
        split = device_ms(run)
        print(f"{name}, full epoch, device ms by kernel: "
              + ", ".join(f"{k_} {v:.3f}" for k_, v in split.items()),
              flush=True)
        assert bool(torch.isfinite(u3).all() and torch.isfinite(i_tab)
                    .all())
        del codes, cells, u3, i_tab
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
