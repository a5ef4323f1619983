"""Where a full-catalog top-N pass spends its time on a GPU, and how the
fused kernel's tuning constants move it.

    python scripts/torch_topk_probe.py [--n 10] [--radix-n 1000]
        [--variants kept stages2 ...]

Port of scripts/tpu_topk_probe.py's question (the scorer's cost at the
bench shape) for the port's kernel, ``csrc/topk.cu``. At 100,000 users x
20,000 items, k=64 (chip_smoke.py cell (g)'s shape; random factors of
scale 0.3, biases of 0.1, train rows at density 0.005 with the bench's
item skew) it times, by CUDA events (mean of 5 after 2 warm-ups):

  * the fused route as built from the checkout (``kept``) and from copies
    of the source with other values of its constants, each compiled by
    nvcc beside it (``VARIANTS``): the kernel cut after its loads, its
    scores and its threshold filter (``kCut``: where the time goes), and
    other ring depths and CTAs per SM, which must return the kept build's
    scores and ids bitwise (the same sum order); each with its registers,
    spills and resident CTAs;
  * the radix route on the same inputs (the score and select kernels
    through the [chunk, n_items] scratch) at --radix-n, with each kernel's
    device ms (torch.profiler), through the kept build and through copies
    cut after a step of the select kernel (``kSelCut``: the row's read,
    the radix passes, the gather) or without its sort (``kSelSort``), and
    the plain version.

It prints one line per run and exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch import low_rank_ratings  # noqa: E402
from matfac_tpu_torch.eval.ranking import exclusion_csr  # noqa: E402
from matfac_tpu_torch.ops import _build  # noqa: E402
from matfac_tpu_torch.ops import topk_kernel as tk  # noqa: E402

# name: {constant: value} edits of csrc/topk.cu's fused-route constants
VARIANTS = {
    "kept": {},
    "loads": {"kCut": 0},
    "scores": {"kCut": 1},
    "filter": {"kCut": 2},
    "stats": {"kStats": 1},
    "stages2": {"kStages": 2},
    "ctas2": {"kFusedCtas": 2, "kStages": 2},
    "sel_read": {"kSelCut": 0},
    "sel_passes": {"kSelCut": 1},
    "sel_gather": {"kSelCut": 2},
    "sel_nosort": {"kSelSort": 0},
    "sel_768": {"kSelThreads": 768},
    "sel_1024": {"kSelThreads": 1024},
}
CUTS = ("loads", "scores", "filter", "stats")   # not the kernel's result
# the radix route's select kernel cut after a step, without its sort, or
# with other block sizes (not cuts: the kept build's result)
SEL_CUTS = ("sel_read", "sel_passes", "sel_gather", "sel_nosort",
            "sel_768", "sel_1024")
OUT = os.path.join(_build.BUILD_DIR.parent, "topk_probe")


def build_variants(names):
    """{name: (loaded library, ptxas report of the fused kernel)}: each
    variant's copy of the source compiled by its own nvcc, all at once."""
    src = (_build.CSRC / "topk.cu").read_text()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for const, value in VARIANTS[name].items():
            text, n = re.subn(rf"(constexpr int {const} = )\d+;",
                              rf"\g<1>{value};", text)
            assert n == 1, (name, const)
        cu = os.path.join(OUT, f"topk_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
               cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        rep = re.search(r"topk_fused_kernel.*?\n.*?\n.*?(\d+ bytes spill "
                        r"stores).*?\n.*?Used (\d+) registers", out, re.S)
        lib = ctypes.CDLL(so)
        for fn, (res, args) in tk._SIGNATURES.items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = list(args)
        libs[name] = (lib, f"{rep.group(2)} registers, {rep.group(1)}"
                      if rep else "ptxas report not found")
    return libs


def inputs(dev) -> dict:
    """topk_catalog's inputs at (g)'s shape, on ``dev``."""
    n_users, n_items, k = 100_000, 20_000, 64
    mat, _, _ = low_rank_ratings(n_users, n_items, k=8, density=0.005,
                                 seed=0, noise=0.1, power_law=0.6,
                                 nonneg=True)
    gen = torch.Generator().manual_seed(0)
    indptr, indices = exclusion_csr(mat, n_users, n_items, dev)
    a = dict(u_fac=0.3 * torch.randn((n_users, k), generator=gen),
             i_fac=0.3 * torch.randn((n_items, k), generator=gen),
             i_bias=0.1 * torch.randn((n_items,), generator=gen),
             u_bias=0.1 * torch.randn((n_users,), generator=gen),
             mu=torch.tensor([0.3]),
             invalid=torch.rand((n_items,), generator=gen) < 0.05,
             users=torch.arange(n_users, dtype=torch.int64))
    a = {x: t.to(dev) for x, t in a.items()}
    return dict(a, indptr=indptr, indices=indices)


def fused_pass(lib, a, n):
    """The fused route through ``lib``, planned as the wrapper plans it."""
    B, (n_items, k) = a["users"].numel(), a["i_fac"].shape
    cap = tk.fused_capacity(n)
    resident = lib.topk_fused_resident(cap)
    splits = tk.fused_splits(B, n_items, n, resident)
    keys = (torch.empty((B, splits, n), dtype=torch.int64, device="cuda")
            if splits > 1 else None)
    out_s = torch.zeros((B, n), dtype=torch.float32, device="cuda")
    out_i = torch.empty((B, n), dtype=torch.int32, device="cuda")
    err = lib.topk_fused(
        *(a[x].data_ptr() for x in ("u_fac", "users", "i_fac", "i_bias",
                                    "u_bias", "mu", "invalid", "indptr",
                                    "indices")),
        None if keys is None else keys.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), B, n_items, k, n, cap, splits,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"topk_fused failed: cudaError {err}")
    return (out_s, out_i), resident


def cuda_ms(fn, reps=5) -> float:
    fn(), fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--radix-n", type=int, default=1000)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants(args.variants)
    a = inputs("cuda")
    n = args.n
    want, _ = fused_pass(libs["kept"][0] if "kept" in libs else
                         next(iter(libs.values()))[0], a, n)
    torch.cuda.synchronize()
    for name, (lib, ptxas) in libs.items():
        if name in SEL_CUTS:
            continue
        got, resident = fused_pass(lib, a, n)
        torch.cuda.synchronize()
        same = (name in CUTS
                or all(torch.equal(x, y) for x, y in zip(got, want)))
        ms = cuda_ms(lambda: fused_pass(lib, a, n))
        if name == "stats":
            lib_out, _ = fused_pass(lib, a, n)
            torch.cuda.synchronize()
            warps = 8 * -(-a["users"].numel() // tk.FUSED_TILE_USERS)
            counts = [float(x) / warps for x in lib_out[0].view(-1)[:2]]
            print("selection work a warp (tiles with a candidate, users "
                  "with one): "
                  + ", ".join(f"{c:.2f}" for c in counts), flush=True)
        print(f"fused {name:8s} {VARIANTS[name]}: {ms:.3f} ms a top-{n} "
              f"pass; {ptxas}; {resident} resident CTAs; "
              f"{'a cut' if name in CUTS else f'equal to kept {same}'}",
              flush=True)
        if not same:
            return 1
    rn = args.radix_n
    keep = tk.library
    for name, (lib, _) in libs.items():
        if name != "kept" and name not in SEL_CUTS:
            continue
        tk.library = lambda lib=lib: lib
        try:
            ms_r = cuda_ms(lambda: tk.topk_catalog(**a, n=rn))
            split = stage_ms(lambda: tk.topk_catalog(**a, n=rn))
        finally:
            tk.library = keep
        per_sm = lib.topk_radix_select_per_sm(a["i_fac"].shape[0], rn)
        print(f"radix {name:10s} {VARIANTS[name]}: {ms_r:.3f} ms a top-{rn} "
              f"pass; device ms " + ", ".join(f"{k} {v:.3f}" for k, v in
                                              split.items())
              + f"; {per_sm} select blocks an SM", flush=True)
    ms_p = cuda_ms(lambda: tk.topk_plain(**a, n=n), reps=2)
    print(f"plain top-{n}: {ms_p:.3f} ms", flush=True)
    return 0


def stage_ms(fn) -> dict:
    """Device ms of the radix route's two kernels in one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = ("radix_score_kernel", "radix_select_kernel")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.name:
                    out[name] += e.time_range.elapsed_us() / 1e3
    return out


if __name__ == "__main__":
    sys.exit(main())
