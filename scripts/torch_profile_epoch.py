"""Where one epoch of the PyTorch port's main paths spends its time on a GPU.

    python scripts/torch_profile_epoch.py [--cell d e g i] [--out DIR]

Cells of chip_smoke.py. d: 100,000 x 20,000 continuous ratings, bf16 R +
int8 W tiles; e: the ML-20M shape, int8 code tiles; both k=64, trained two
epochs through ``train_model(..., device="cuda")``, then profiled with
``torch.profiler`` (CUDA activity), each in its own window:

  * one solver epoch (the hand-written kernel's route, with the views);
  * one plain PyTorch epoch on the same staged tiles;
  * one objective (train SSE + regularization) and one val RMSE.

g: the ranking path, plain BPR at 100,000 x 20,000, k=64, trained two
epochs through ``train_model(algo="bpr", device="cuda")``; windows:

  * one BPR epoch (sampler, gathers, scatters);
  * one val HR@10 through the scorer (the fused top-N kernel, LOO credit);
  * a top-129 pass through the radix route (score and select kernels:
    their split; its first 10 slots are the top-10, and its time hardly
    depends on n) and the top-10 pass through the plain version.

i: the one-hot cell engine, train_model(algo="mf", mf_method="blocksgd")
on cell d's data (diag schedule, 384-blocks, 1024-rating steps, lr 0.005),
trained two epochs; windows:

  * one solver epoch (the block kernel, one launch an epoch);
  * one plain PyTorch diag epoch on the same staged streams and schedule;
  * one objective and one val RMSE.

It prints per window the CUDA-event wall, the device time of each kernel
(summed over launches) and the device's idle share of the window, one
stream: 1 - summed kernel time / wall. The profiler can drop device
events; where a window launches a hand-written kernel it prints the
wrapper's own launch count beside the launches the profiler saw, and an
idle share is only as good as that match. Then the peak device memory.
With ``--out`` the profiler's full tables go to DIR/profile_<cell>.txt.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from matfac_tpu_torch import Params  # noqa: E402
from matfac_tpu_torch.ops import block_sgd_kernel as bsk  # noqa: E402
from matfac_tpu_torch.ops import dense_row_kernel as drk  # noqa: E402
from matfac_tpu_torch.ops import topk_kernel as tk  # noqa: E402
from matfac_tpu_torch.ops.dense_block_kernel import (  # noqa: E402
    dense_sweep_rows)
from matfac_tpu_torch.train.loop import train_model  # noqa: E402


def profiled(fn):
    """(CUDA-event ms of fn, {kernel name: (launches, device ms)}, prof)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    kernels = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name][0] += 1
            kernels[e.name][1] += e.time_range.elapsed_us() / 1e3
    return start.elapsed_time(end), dict(kernels), prof


def report(tag: str, what: str, wall_ms: float, kernels: dict) -> None:
    busy = sum(ms for _, ms in kernels.values())
    print(f"({tag}) {what}: wall {wall_ms:.3f} ms (CUDA events); device "
          f"busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}",
          flush=True)
    if not kernels:
        print(f"({tag})   the profiler saw no device activity", flush=True)
    for name, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        print(f"({tag})   {ms:10.3f} ms {n:5d}x {name[:100]}", flush=True)


def profile_cell(tag: str, out_dir) -> None:
    data_kw, params_kw, _ = cs.CELLS[tag]
    data = cs.bench_data(**data_kw)
    params = Params(**dict(params_kw, max_iter=2))
    torch.cuda.reset_peak_memory_stats()
    rep, model, ev, _ = train_model(data, params, algo="mf",
                                    mf_method="densesgd", device="cuda",
                                    log_fn=lambda s: None)
    solver, state, lr = rep.solver, rep.state, params.learn_rate
    u3, i_tab = solver.stage_factors(state)
    order = torch.randperm(solver.NU)
    p = solver.params

    def plain():
        dense_sweep_rows(u3.clone(), i_tab.clone(), order, lr,
                         solver.tiles.R, solver.tiles.W, p.u_reg, p.i_reg,
                         solver.collision_norm, solver.mm_bf16,
                         r_scale=solver.r_scale)

    current = [state]

    def epoch():   # chained, so the solver's resident tables are reused
        current[0] = solver.epoch(current[0], lr)

    def objective():
        ev.objective(model.eval_view(state), state,
                     use_factors=model.use_factors, use_bias=model.use_bias)

    windows = [("solver epoch (kernel)", epoch),
               ("plain epoch", plain),
               ("objective", objective),
               ("val RMSE", lambda: ev.rmse(model.eval_view(state), "val"))]
    kernels = ("::panel_kernel<", "stripe_step_kernel", "u_bf16_kernel")
    run_windows(tag, windows, (drk.StripeTiles, kernels), out_dir)
    del rep, solver, state, current, ev, u3, i_tab
    torch.cuda.empty_cache()


def profile_block(tag: str, out_dir) -> None:
    data = cs.bench_data(**cs.CELLS["d"][0])
    params = Params(**dict(cs.BLOCK_PARAMS, max_iter=2))
    torch.cuda.reset_peak_memory_stats()
    rep, model, ev, _ = train_model(data, params, algo="mf",
                                    mf_method="blocksgd", device="cuda",
                                    log_fn=lambda s: None)
    solver, state, lr = rep.solver, rep.state, params.learn_rate
    u_tab, i_tab = solver.stage_factors(state)
    sched = solver.draw_schedule()
    kw = solver.sweep_kwargs()

    def plain():
        bsk.block_sweep_diag(u_tab.clone(), i_tab.clone(), *sched, lr,
                             *solver.streams, **kw)

    current = [state]

    def epoch():   # chained, so the solver's resident tables are reused
        current[0] = solver.epoch(current[0], lr)

    def objective():
        obj = ev.objective(model.eval_view(state), state)
        print(f"({tag}) objective {obj!r}", flush=True)

    windows = [("solver epoch (kernel)", epoch),
               ("plain epoch", plain),
               ("objective", objective),
               ("val RMSE", lambda: ev.rmse(model.eval_view(state), "val"))]
    print(f"({tag}) {solver.NU} x {solver.NI} blocks of {solver.bu}, "
          f"{-(-solver.NU // solver.NI) * solver.NI} rounds per epoch, "
          f"{solver.nnz} ratings", flush=True)
    run_windows(tag, windows, (bsk.block_sgd_diag_epoch, ("cell_sgd",)),
                out_dir)
    del rep, solver, state, current, ev, u_tab, i_tab
    torch.cuda.empty_cache()


def profile_ranking(tag: str, out_dir) -> None:
    data_kw, params_kw = cs.BPR_CELL
    data = cs.bench_data(**data_kw)
    params = Params(**dict(params_kw, max_iter=2))
    torch.cuda.reset_peak_memory_stats()
    rep, model, scorer, _ = train_model(data, params, algo="bpr",
                                        mf_method="train", device="cuda",
                                        log_fn=lambda s: None)
    solver, lr = rep.solver, params.learn_rate
    state = rep.state
    view = model.eval_view(rep.best_state)
    args = dict(u_fac=view.u_fac, i_fac=view.i_fac, i_bias=view.i_bias,
                u_bias=view.u_bias, mu=view.mu,
                invalid=scorer.invalid_items_dev, indptr=scorer.indptr,
                indices=scorer.indices, users=scorer._all_users)
    windows = [
        ("BPR epoch", lambda: solver.epoch(state, lr)),
        ("val HR@10 (fused top-N kernel)",
         lambda: scorer.hit_rate(view, data.val_mat, 10)),
        (f"top-{tk.FUSED_MAX_N + 1} pass, radix route",
         lambda: tk.topk_catalog(**args, n=tk.FUSED_MAX_N + 1)),
        ("top-10 pass, plain version", lambda: tk.topk_plain(**args, n=10))]
    run_windows(tag, windows,
                (tk.topk_catalog, ("topk_fused_kernel", "topk_merge_kernel",
                                   "radix_score_kernel",
                                   "radix_select_kernel")), out_dir)
    print(f"({tag}) {solver.n_pos} positives per epoch", flush=True)
    del rep, solver, state, scorer, view, args
    torch.cuda.empty_cache()


def run_windows(tag: str, windows, counted, out_dir) -> None:
    """Profile each (name, fn) window after one warm call; ``counted`` is
    (wrapper with a ``launches`` count, substrings of its kernels' names)."""
    wrapper, parts = counted
    tables = []
    for what, fn in windows:
        fn()   # warm
        before = wrapper.launches
        wall, kernels, prof = profiled(fn)
        report(tag, what, wall, kernels)
        launched = wrapper.launches - before
        if launched:
            seen = sum(n for name, (n, _) in kernels.items()
                       if any(p in name for p in parts))
            print(f"({tag})   hand-written kernel launches: {launched} by "
                  f"the wrapper's count, {seen} seen by the profiler",
                  flush=True)
        tables.append(f"== {what}\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=25))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"({tag}) peak device memory {peak:.3f} GiB (train_model with "
          "eval, then the windows above)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
            f.write("\n\n".join(tables))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", nargs="+", default=["d", "e", "g", "i"],
                    choices=sorted(cs.CELLS) + ["g", "i"])
    ap.add_argument("--out", default=None,
                    help="directory for the profiler's full tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag in args.cell:
        if tag == "g":
            profile_ranking(tag, args.out)
        elif tag == "i":
            profile_block(tag, args.out)
        else:
            profile_cell(tag, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
