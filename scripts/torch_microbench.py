"""Device microbenchmarks on the port: the primitive rates that explain the
solvers' epoch times (the counterpart of scripts/microbench.py).

JAX's five measurements, timed with CUDA events on the card (one warm
call, then the mean of several): the chained row gather, the chained
scatter-add, the element-level stream gather, the batched Cholesky solve
of [n, 64, 64] systems and CG-6 over the same systems, and a bf16
matmul. The scatter chain is timed twice: through
``ops/scatter.index_add_ordered_`` (the fixed-order sum the scatter
engines use, the counterpart of XLA's ``.at[].add``) and through
``Tensor.index_add_`` (atomics on the card, in no fixed order; no engine
uses it), so the cost of reproducible sums shows at the primitive level;
and one 16,384-row scatter with its hottest row hit 16, 256 and 4,096
times both ways, since the ordered sums add a row's duplicates one after
another.

Runs on the card unless ``--cpu`` (host clock there). ``--quick`` takes
JAX's quick sizes; the size flags default to JAX's shapes.

Usage: python scripts/torch_microbench.py [--cpu] [--quick] [--nnz N]
  [--n-sys N] [--mm M K N]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch.ops.scatter import index_add_ordered_  # noqa: E402
from matfac_tpu_torch.solvers.als import solve_spd_cg  # noqa: E402

BS, K, N_USERS = 65_536, 64, 100_000


def timeit(fn, device, n=3) -> float:
    """Seconds a call: one warm call, then the mean of ``n`` (CUDA events
    on the card, the host clock on the CPU)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n


def run(device="cuda", quick=False, nnz=None, n_sys=None,
        mm=(8192, 20480, 4096), log=print) -> dict:
    """The measurements, printed in the JAX script's lines; returns
    {name: seconds} and the rates."""
    dev = torch.device(device)
    nnz = nnz or (2_000_000 if quick else 9_830_400)
    n_sys = n_sys or (16_384 if quick else 102_400)
    bs, k = BS, K
    nb = nnz // bs
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, N_USERS, nnz)).to(dev)
    tbl = torch.zeros(N_USERS, k, device=dev)
    g = torch.ones(bs, k, device=dev)
    out = {}

    def gather_chain():
        acc = torch.zeros((), device=dev)
        for s in range(nb):
            acc += tbl[idx[s * bs:(s + 1) * bs]].sum()
        return acc

    dt = out["gather"] = timeit(gather_chain, dev)
    log(f"gather chain ({nnz} rows, k={k}): {dt*1000:.0f} ms "
        f"-> {nnz/dt/1e6:.0f}M rows/s")

    def scatter_chain(add):
        def chain():
            t = tbl.clone()
            for s in range(nb):
                add(t, idx[s * bs:(s + 1) * bs])
            return t
        return chain

    dt = out["scatter"] = timeit(scatter_chain(
        lambda t, sl: index_add_ordered_(t, 0, sl, g)), dev)
    log(f"scatter chain: {dt*1000:.0f} ms -> {nnz/dt/1e6:.0f}M rows/s")
    dt = out["scatter_atomic"] = timeit(scatter_chain(
        lambda t, sl: t.index_add_(0, sl, g)), dev)
    log(f"scatter chain, index_add_ (atomics on the card, no fixed order; "
        f"no engine uses it): {dt*1000:.0f} ms -> {nnz/dt/1e6:.0f}M rows/s; "
        f"the ordered sums take {out['scatter'] / dt:.2f}x its time")

    # one batch of 16,384 rows whose first row takes `hot` of them: the
    # ordered sums add a row's duplicates one after another, so their
    # time grows with the hottest row's count; the atomics' does not
    n_hot = 16_384
    g_hot = torch.ones(n_hot, k, device=dev)
    for hot in (16, 256, 4096):
        sl = idx[:n_hot].clone()
        sl[torch.randperm(n_hot, generator=torch.Generator().manual_seed(
            hot))[:hot].to(dev)] = 0
        t_ord = out[f"hot{hot}"] = timeit(
            lambda: index_add_ordered_(tbl.clone(), 0, sl, g_hot), dev, n=10)
        t_at = out[f"hot{hot}_atomic"] = timeit(
            lambda: tbl.clone().index_add_(0, sl, g_hot), dev, n=10)
        log(f"scatter of {n_hot} rows, one row {hot} times: ordered sums "
            f"{t_ord*1e6:.1f} us, index_add_ {t_at*1e6:.1f} us (the table's "
            f"copy in both)")

    # element-level stream gather: a gather of the stream itself at
    # computed positions, against a contiguous slice that costs nothing
    ar = torch.arange(bs, device=dev)

    def elem_gather():
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(nb):
            acc += idx[(s * bs + ar) % nnz].sum()
        return acc

    dt = out["elem_gather"] = timeit(elem_gather, dev)
    log(f"element-level stream gather: {dt*1000:.0f} ms "
        f"(vs ~0 for contiguous slices)")

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n_sys, k, k, generator=gen, device=dev)
    gram = a @ a.transpose(1, 2) + 10.0 * torch.eye(k, device=dev)[None]
    b = torch.randn(n_sys, k, generator=gen, device=dev)

    def chol():
        c = torch.linalg.cholesky(gram)
        s = torch.linalg.solve_triangular(c, b[..., None], upper=False)
        return torch.linalg.solve_triangular(c.transpose(1, 2), s,
                                             upper=True)[..., 0]

    dt = out["cholesky"] = timeit(chol, dev)
    log(f"batched cholesky+solve [{n_sys},{k},{k}]: {dt*1000:.0f} ms "
        f"({dt/n_sys*1e6:.1f} us/system)")
    dt = out["cg6"] = timeit(
        lambda: solve_spd_cg(gram, b, torch.zeros_like(b), 6), dev)
    log(f"batched CG-6 solve: {dt*1000:.0f} ms "
        f"({dt/n_sys*1e6:.1f} us/system)")
    del a, gram, b

    M, KK, N = mm
    m = torch.ones(M, KK, dtype=torch.bfloat16, device=dev)
    qq = torch.ones(KK, N, dtype=torch.bfloat16, device=dev)
    dt = out["matmul"] = timeit(lambda: torch.mm(m, qq), dev, n=5)
    fl = 2 * M * KK * N
    out["matmul_tflops"] = fl / dt / 1e12
    log(f"bf16 matmul {M}x{KK}x{N}: {dt*1000:.1f} ms "
        f"-> {fl/dt/1e12:.0f} TFLOP/s")
    out.update(nnz=nnz, n_sys=n_sys, mm=mm)
    log(f"seconds a call, unrounded: {out}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--nnz", type=int, default=None)
    ap.add_argument("--n-sys", type=int, default=None)
    ap.add_argument("--mm", type=int, nargs=3, default=[8192, 20480, 4096])
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    print("device:", torch.cuda.get_device_name(0) if device == "cuda"
          else "cpu", flush=True)
    run(device, args.quick, args.nnz, args.n_sys, tuple(args.mm),
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
