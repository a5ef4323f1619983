"""What one minibatch step of the one-hot cell kernel costs, by stage, on
one NVIDIA GPU.

    python scripts/torch_block_micro.py

The port of scripts/tpu_pallas_micro.py (the in-kernel cost of the block
engine's batch update, by stage). Each stage is a template instantiation
of the same source (csrc/block_sgd.cu, exported as ``block_sgd_ablate``;
bf16 products, no collision norm, no rank mask):

  slices   each step's staged slice only (the slot metadata sorted by
           row, once per side, block_sgd_kernel.slice_tables) and the
           step's two cluster barriers;
  gather   + each slot's own and partner row and its prediction;
  sums     + the segment sums (runs of one row within a lane group's
           range of 4 or 8 sorted slots), stored once each;
  full     + the apply (each touched row adds its segments' sums once).

A run walks ``rounds`` rounds of ``lanes`` parallel lanes, one cell of one
full step (bs slots, every one valid) per lane and round, in one launch.
The cost of a step is the probe's two-point iteration difference: (t(HI) -
t(LO)) / (HI - LO) rounds, each t the min of 3 CUDA-event timings after a
warm-up, which cancels the launch and the table's set-up. Shapes: bs 1024;
384-blocks at k 64 and 128 over 53 lanes (the diag schedule of
chip_smoke.py's (i): 53 item blocks at 20,000 items); 1024-blocks at k 64
in one lane (the row schedule of (k)).

It prints the card's name and power limit, then per shape the kernel's
launch plan (route, cluster size C, clusters), the least time the card
could take for one step (``step_bound``), a table of us per step by stage
and what each stage added, then the full step at other cluster sizes.
``slices`` is the step's chain floor: what a step costs before it gathers
a row (its stream loads and its two cluster barriers).
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch.ops import block_sgd_kernel as bsk  # noqa: E402

STAGES = ("slices", "gather", "sums", "full")
# (label, bs, bu = bi, k, lanes, other cluster sizes for the full step)
SHAPES = (("(i) 384-blocks, k=64, 53 lanes", 1024, 384, 64, 53, (1, 4)),
          ("384-blocks, k=128, 53 lanes", 1024, 384, 128, 53, (4,)),
          ("(k) 1024-blocks, k=64, 1 lane", 1024, 1024, 64, 1, (4, 8)))
LO, HI = 32, 160
LR, REG = 0.005, 0.01
# H100 SXM peaks (NVIDIA's data sheet), as chip_smoke.py
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def _streams(shape, seed: int):
    """The probe's cell streams for one run: uniform row ids in each
    block, ratings around 3, every slot valid."""
    _, bs, b, k, lanes, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u_loc = torch.randint(0, b, (lanes, bs), generator=gen, device="cuda",
                          dtype=torch.int32)
    i_loc = torch.randint(0, b, (lanes, bs), generator=gen, device="cuda",
                          dtype=torch.int32)
    vals = 3.0 + torch.randn((lanes, bs), generator=gen, device="cuda")
    return gen, u_loc, i_loc, vals


def step_bound(shape) -> tuple:
    """(least us one step of every lane could take, "bytes" or
    "operations") on the full stage's streams: each slot's u, i, r, w
    (16 B) read once; each row a step touches, k f32, read once and
    written once on each side; 8k FLOP a slot (the prediction's and the
    two gradients' multiply-adds) at the f32 peak."""
    _, bs, b, k, lanes, _ = shape
    _, u_loc, i_loc, _ = _streams(shape, STAGES.index("full"))
    rows = sum(int(torch.unique(x[lane]).numel()) for x in (u_loc, i_loc)
               for lane in range(lanes))
    t_bytes = (16 * bs * lanes + 2 * 4 * k * rows) / HBM_BYTES_PER_S * 1e6
    t_ops = 8.0 * k * bs * lanes / PEAK_F32_FLOPS * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_ms(lib, stage: int, shape, rounds: int, cluster: int = 0,
           reps: int = 3) -> float:
    """Min over ``reps`` of one launch's CUDA-event ms after a warm-up, at
    cluster size ``cluster`` (0: the plan's)."""
    _, bs, b, k, lanes, _ = shape
    gen, u_loc, i_loc, vals = _streams(shape, stage)
    wts = torch.ones((lanes, bs), device="cuda")
    pl = bsk.plan_at(lib, lanes, bs, b, b, k, cluster)
    tables = bsk.slice_tables((u_loc, i_loc, vals, wts, None, None, None),
                              bs, b, b, False, False, pl["range"])
    u_tab = 0.01 * torch.randn((lanes * b, k), generator=gen, device="cuda")
    i_tab = 0.01 * torch.randn((lanes * b, k), generator=gen, device="cuda")
    p = torch.arange(lanes, dtype=torch.int32)
    one = torch.stack([p, p, p, torch.zeros_like(p)], -1)      # [lanes, 4]
    table = one[None].expand(rounds, lanes, 4).contiguous().to("cuda")
    n = lib.block_sgd_scratch_floats(pl["clusters"], pl["cluster"], bs, b, b,
                                     k, pl["range"])
    scratch = torch.zeros(max(n, 1), device="cuda")
    work = torch.zeros(4, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, device="cuda")

    def run():
        err = lib.block_sgd_ablate(
            stage, u_tab.data_ptr(), i_tab.data_ptr(),
            *(tables[x].data_ptr() for x in bsk._TABLES), table.data_ptr(),
            rounds, lanes, 1, bs, b, b, k, -LR, 2 * REG, 2 * REG,
            scratch.data_ptr() if n else None, work.data_ptr(),
            sink.data_ptr(), torch.cuda.current_stream().cuda_stream,
            cluster)
        if err:
            raise RuntimeError(f"stage {STAGES[stage]}: "
                               f"{lib.block_sgd_error_string(err).decode()}")

    run()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    assert bool(torch.isfinite(u_tab).all() and torch.isfinite(i_tab).all())
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_block_micro: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = bsk.library()
    per_step = lambda stage, shape, c=0: (
        run_ms(lib, stage, shape, HI, c) - run_ms(lib, stage, shape, LO, c)
    ) / (HI - LO) * 1e3
    for shape in SHAPES:
        label, bs, b, k, lanes, others = shape
        pl = bsk.plan(lanes, bs, b, b, k)
        print(f"\n{label}: bs {bs}; plan: {pl['route']} route, C = "
              f"{pl['cluster']}, ranges of {pl['range']}, {pl['clusters']} "
              f"clusters "
              f"({pl['resident']} co-resident), {pl['smem']} B shared "
              "memory per CTA", flush=True)
        bound = step_bound(shape)
        print(f"bound: {bound[0]:.4f} us per step ({bound[1]})", flush=True)
        print("| stage | us per step | added |")
        print("|---|---|---|")
        prev = 0.0
        for stage, name in enumerate(STAGES):
            us = per_step(stage, shape)
            print(f"| {name} | {us:.3f} | {us - prev:+.3f} |", flush=True)
            prev = us
        for c in others:
            try:
                o = bsk.plan_at(lib, lanes, bs, b, b, k, c)
                us = per_step(3, shape, c)
            except RuntimeError as e:   # a plan the card cannot co-host
                print(f"full step at C = {c}: {e}", flush=True)
                continue
            print(f"full step at C = {o['cluster']} ({o['route']} route, "
                  f"{o['clusters']} clusters): {us:.3f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
