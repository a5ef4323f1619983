"""Where the stripe kernel's time goes: its int8-codes instantiation cut
after each stage, on one NVIDIA GPU.

    python scripts/torch_stripe_ablate.py

The port of scripts/tpu_pallas_codes_ablate.py, at its shape: 40 stripes
of 2,560 users, 157 panels of 128 items (20,096), k = 64, codes drawn
uniformly from {0, 1, 2} (r_scale 0.5), the stripes in order. Each stage
is a template instantiation of the same source (csrc/dense_rows.cu,
exported as ``dense_rows_ablate``):

  stream  tile and bf16 U chunk loads only (the cp.async ring), after
          the epoch's one bf16 copy of U;
  pmm     + P = U I^T on the tensor cores;
  elem    + E = W (R - P) in P's epilogue, E to shared memory;
  item    + Gi += E^T U and its atomics;
  full    + Gu = E I with its atomics, and the step kernel (items and
          users).

It prints the card's name and power limit, then per stage the epoch's
device time (CUDA events, min of 3 after a warm-up) and what the stage
added, and the epoch's bound on this card (codes read once, U and I read
and written once, or 6k FLOP a slot at the bf16 tensor-core peak).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch.ops import dense_row_kernel as drk  # noqa: E402

NU, BU, N_PANELS, K = 40, 2560, 157, 64
NI = N_PANELS * 128
STAGES = ("stream", "pmm", "elem", "item", "full")
LR, R_SCALE, REG = 0.005, 0.5, 0.001
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12


def epoch_ms(lib, stage: int, u3, i_tab, codes, order, reps: int = 3):
    """Min over ``reps`` of one epoch's CUDA-event ms, after a warm-up."""
    cnt_u, cnt_i = drk.stripe_counts(codes, None)
    scratch = torch.zeros(lib.dense_rows_scratch_bytes(NU, BU, NI, K, 1),
                          dtype=torch.uint8, device="cuda")
    failed, launched = ctypes.c_longlong(-1), ctypes.c_longlong(0)

    def run():
        err = lib.dense_rows_ablate(
            stage, u3.data_ptr(), i_tab.data_ptr(), codes.data_ptr(),
            cnt_u.data_ptr(), cnt_i.data_ptr(), scratch.data_ptr(),
            order.data_ptr(), NU, NU, BU, NI, K, LR, R_SCALE, REG, REG,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(failed),
            ctypes.byref(launched))
        if err:
            raise RuntimeError(f"stage {STAGES[stage]}: "
                               f"{lib.dense_rows_error_string(err).decode()}"
                               f" on stripe {failed.value}")

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
    return min(times), times


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stripe_ablate: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    codes = torch.randint(0, 3, (NU, BU, NI), generator=gen, device="cuda",
                          dtype=torch.int8)
    u3 = 0.1 * torch.randn((NU, BU, K), generator=gen, device="cuda")
    i_tab = 0.1 * torch.randn((NI, K), generator=gen, device="cuda")
    order = torch.arange(NU, dtype=torch.int64)
    lib = drk.library()
    slots = NU * BU * NI
    nbytes = codes.nbytes + 2 * 4 * K * (NU * BU + NI)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 6.0 * slots * K / BF16_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"shape: {NU} stripes x {BU} users x {NI} items, k={K}; bound "
          f"{max(t_bytes, t_ops):.3f} ms ({by}: {t_bytes:.3f} ms of bytes, "
          f"{t_ops:.3f} ms of bf16 FLOP)", flush=True)
    print("| stage | ms per epoch (min of 3) | added | runs (ms) |")
    print("|---|---|---|---|")
    prev = 0.0
    for stage, name in enumerate(STAGES):
        ms, runs = epoch_ms(lib, stage, u3, i_tab, codes, order)
        print(f"| {name} | {ms:.3f} | {ms - prev:+.3f} | "
              f"{', '.join(f'{t:.3f}' for t in runs)} |", flush=True)
        prev = ms
    assert bool(torch.isfinite(u3).all() and torch.isfinite(i_tab).all())
    return 0


if __name__ == "__main__":
    sys.exit(main())
