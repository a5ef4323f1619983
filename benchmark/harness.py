"""The benchmark's shared machinery: a cell's files found by name, the
inputs handed to the program, the window over a training loop's epochs,
the profiled sub-window and its reduction, the checks that decide
``correct``, the import guard and the result line.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs/<name>.json``, whose ``generator`` names ``data/<generator>.py``)
and a traffic mix (``traffic/<name>.json``, whose ``driver`` names
``drivers/<driver>.py`` and whose ``reference`` names
``reference/<entry>.py``); its limits are ``limits/<cell>.json`` and each
metric is read by ``metrics/<metric>.py``. Adding a cell adds files and
edits none.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "matfac_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def quiet(*a, **k) -> None:
    """The program's ``log_fn`` in a run: its lines would cost host time."""


def load_file(path: Path):
    """Import a file of the benchmark by its path (metric files carry dots
    in their names, so they are not importable by module name)."""
    name = "bench_" + "".join(c if c.isalnum() else "_"
                              for c in str(path.relative_to(BENCH)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read`` of ``metrics/<metric>.py``: a reader that computes
    another metric's formula on its own cells aliases it by this."""
    return load_file(BENCH / "metrics" / f"{metric}.py").read


def banned_loaded() -> List[str]:
    """The banned top-level names among the loaded modules, compared whole
    (``matfac_tpu_torch`` is not ``matfac_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


# ----------------------------------------------------------------------
# cells
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def module(self, kind: str, name: str):
        return load_file(BENCH / kind / f"{name}.py")


def load_cell(workload: str, spec_path: Optional[Path] = None) -> Cell:
    """The cell named ``workload`` in BENCHMARK.json and its files; a
    KeyError names what is missing."""
    spec = json.loads((spec_path or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" /
                          f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    mine = lambda m: "workloads" not in m or workload in m["workloads"]
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [m for m in spec["end_to_end"] if mine(m)],
                [m for m in spec["per_layer"] if mine(m)])


def claim_device(chips: int):
    """The card this run measures on; exits 2, printing no result, where
    there is no card or fewer than the cell asks for."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark: the cell needs {chips} CUDA device(s); "
            f"{n} visible")
        sys.exit(2)
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                    device)))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def free_device(device) -> None:
    """Drop what the program left cached, before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the inputs handed to the program
# ----------------------------------------------------------------------

def host_csr(split, n_users: int, n_items: int):
    """The port's host CSR of a split (rows, cols, vals) sorted by row,
    then column."""
    from matfac_tpu_torch.data.csr import RatingMatrix
    rows, cols, vals = split
    indptr = torch.zeros(n_users + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_users), 0)
    return RatingMatrix(indptr.cpu().numpy(),
                        cols.to(torch.int32).cpu().numpy(),
                        vals.cpu().numpy(), n_items)


def port_data(bundle: dict):
    """The port's Data of a generated bundle: host CSR, nothing else."""
    from matfac_tpu_torch.data.dataset import Data
    nu, ni = bundle["n_users"], bundle["n_items"]
    return Data(train_mat=host_csr(bundle["train"], nu, ni),
                test_mat=host_csr(bundle["test"], nu, ni),
                val_mat=host_csr(bundle["val"], nu, ni))


def job_seed(seed: int, job: int) -> int:
    """The seed of job ``job``'s initial factors (job -1 warms up)."""
    return seed * 1_000_003 + job + 1


def job_factors(n_users: int, n_items: int, k: int, seed: int, job: int,
                device):
    """(U, V) f32, uniform(-0.01, 0.01) as the program's ``init_state``
    draws them (Model::Model), made on the device from (seed, job)."""
    g = torch.Generator(device=device).manual_seed(job_seed(seed, job))
    x = torch.rand((n_users + n_items) * k, generator=g, device=device)
    x = (x * 0.02 - 0.01).reshape(n_users + n_items, k)
    return x[:n_users].clone(), x[n_users:].clone()


def job_state(n_users: int, n_items: int, k: int, seed: int, job: int,
              device, dtype=torch.float32):
    """The program's MFState of job ``job``: its factors (in ``dtype``:
    bf16 tables are the program's own lower-precision path), zero
    biases."""
    from matfac_tpu_torch.models.base import MFState
    U, V = (x.to(dtype) for x in job_factors(n_users, n_items, k, seed,
                                               job, device))
    z = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
    return MFState(U, V, z(n_users), z(n_items),
                   torch.zeros((), dtype=torch.float32, device=device))


# ----------------------------------------------------------------------
# the window over a training loop's epochs
# ----------------------------------------------------------------------

class WindowClosed(Exception):
    """Raised by the wrapped epoch at the epoch boundary that ends the
    window (or the profiled sub-window)."""


class EpochWindow:
    """Wraps ``solver.epoch`` on the instance (the loops call
    ``self.solver.epoch``) and the loop's checks.

    The window opens at ``open()`` and closes at the first epoch boundary
    after ``seconds``, once job 0 has run its ``checked_epochs``: the
    wrapped epoch then raises ``WindowClosed``. With ``trace`` the host
    times each epoch's call (its enqueue) and each check, synchronizing
    around the check, and at the boundary that closes the window a
    profiled sub-window of ``profile_epochs`` epochs starts, which the
    host-clock figures leave out. Job 0's factors after each of its first
    ``checked_epochs`` epochs, its losses (``loss_of``) and the values of
    its checks are kept for the comparison with the reference."""

    def __init__(self, solver, seconds: float, trace: bool,
                 checked_epochs: int, profile_epochs: int, device,
                 loss_of: Optional[Callable] = None):
        self.solver = solver
        self._epoch = solver.epoch
        solver.epoch = self.epoch
        self.seconds = seconds
        self.trace = trace
        self.checked = checked_epochs
        self.profile_epochs = profile_epochs
        self.device = device
        self.loss_of = loss_of
        self.job = -1
        self.job_epochs = 0
        self.epochs = 0
        self.failed = 0
        self.enqueue_s: List[float] = []
        self.check_s: List[tuple] = []
        self.kept_states: List[tuple] = []
        self.kept_losses: List = []
        self.kept_checks: Dict[str, List[float]] = {}
        self.phase = "warmup"
        self.prof = None
        self.prof_epochs = 0
        self.t_open = self.t_close = None
        self.prof_wall = None

    def restore(self) -> None:
        del self.solver.epoch   # the class's method again

    def open(self) -> float:
        self.phase = "window"
        self.t_open = time.perf_counter()
        return self.t_open

    def start_job(self, job: int) -> None:
        self.job, self.job_epochs = job, 0

    def epoch(self, state, lr):
        now = time.perf_counter()
        if self.phase == "window" and now >= self.t_open + self.seconds \
                and (self.job > 0 or self.job_epochs >= self.checked):
            self.t_close = now
            if not self.trace or self.profile_epochs <= 0:
                self.phase = "closed"
                raise WindowClosed
            self._start_profile()
        if self.phase == "profile" and self.prof_epochs >= \
                self.profile_epochs:
            self._stop_profile()
            raise WindowClosed
        if self.phase == "profile":
            with torch.profiler.record_function("bench.epoch"):
                out = self._epoch(state, lr)
            self.prof_epochs += 1
            return out
        t0 = time.perf_counter()
        out = self._epoch(state, lr)
        if self.phase == "window":
            self.enqueue_s.append(time.perf_counter() - t0)
            self.epochs += 1
        self.job_epochs += 1
        if self.job == 0 and self.job_epochs <= self.checked:
            self.kept_states.append((out.u_fac.clone(), out.i_fac.clone()))
            if self.loss_of is not None:
                self.kept_losses.append(self.loss_of())
        return out

    def wrap_check(self, owner, name: str, kind: str) -> None:
        """Wrap ``owner.name`` (a check of the loop) on the instance: its
        values in job 0 are kept, and with ``trace`` the host times it in
        the window, synchronized around it."""
        real = getattr(owner, name)

        def call(*a, **k):
            if self.phase == "profile":
                with torch.profiler.record_function("bench.check"):
                    return real(*a, **k)
            timed = self.trace and self.phase == "window"
            if timed:
                sync(self.device)
                t0 = time.perf_counter()
            out = real(*a, **k)
            if not math.isfinite(float(out)):
                self.failed += 1
            if timed:
                sync(self.device)
                self.check_s.append((kind, time.perf_counter() - t0))
            if self.job == 0 and self.job_epochs <= 1:
                self.kept_checks.setdefault(kind, []).append(float(out))
            return out
        setattr(owner, name, call)

    def _start_profile(self) -> None:
        self.phase = "profile"
        self.prof = start_profile()
        self.t_prof = time.perf_counter()

    def _stop_profile(self) -> None:
        sync(self.device)
        self.prof_wall = time.perf_counter() - self.t_prof
        self.prof.stop()
        self.phase = "closed"

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


# ----------------------------------------------------------------------
# the profiled sub-window
# ----------------------------------------------------------------------

def start_profile():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _annotation(e) -> bool:
    """A span of the benchmark's own (``record_function``), which the
    profiler also draws on the device's timeline: not device work."""
    name = getattr(e, "key", None) or e.name
    return bool(getattr(e, "is_user_annotation", False)) or \
        name.startswith("bench.")


def _us(avg, *names) -> float:
    for n in names:
        v = getattr(avg, n, None)
        if v is not None:
            return float(v)
    return 0.0


def summarize_profile(prof, wall_s: float) -> dict:
    """The sub-window's reduction: ``ops`` (each key of ``key_averages()``
    with its count, its device time and whether it ran on the device),
    ``busy_s`` (the union of the device's activity intervals), the wall,
    and the ``breakdown`` (the device ops that took most time, and the
    longest idle gaps of the device labelled by what the host was doing:
    the benchmark's span and the innermost host op at the gap's middle,
    "python" where only the span is open). The benchmark's own spans are
    left out of the device's work. No trace is written."""
    from torch.autograd import DeviceType
    ops = []
    for a in prof.key_averages():
        if _annotation(a):
            continue
        on_dev = getattr(a, "device_type", None) == DeviceType.CUDA
        ops.append(dict(
            name=a.key, count=int(a.count), on_device=bool(on_dev),
            device_total_us=_us(a, "device_time_total", "cuda_time_total"),
            self_device_us=_us(a, "self_device_time_total",
                               "self_cuda_time_total")))
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not _annotation(e):
                dev.append((tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
    busy_us, gaps = 0.0, []
    if dev:
        dev.sort()
        cur_s, cur_e = dev[0]
        for s, e in dev[1:]:
            if s > cur_e:
                busy_us += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_us += cur_e - cur_s
    gaps.sort(reverse=True)
    hs = np.array([h[0] for h in host], np.float64)
    he = np.array([h[1] for h in host], np.float64)
    idle = []
    for length, s, e in gaps[:10]:
        mid = (s + e) / 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        spans = [host[i] for i in inside]
        bench = [h[2] for h in spans if h[2].startswith("bench.")]
        ops_ = [h for h in spans if not h[2].startswith("bench.")]
        inner = (max(ops_, key=lambda h: h[0])[2] if ops_ else
                 "python" if bench else "outside the spans")
        label = (bench[0] + "/" if bench else "") + inner
        idle.append([label[:160], length / 1e6])
    top = sorted((o for o in ops if o["on_device"]),
                 key=lambda o: -o["self_device_us"])[:10]
    return dict(ops=ops, busy_s=busy_us / 1e6, wall_s=wall_s,
                breakdown=dict(
                    device_ops=[[o["name"][:160], o["self_device_us"] / 1e6]
                                for o in top],
                    idle_gaps=idle))


# ----------------------------------------------------------------------
# the comparison with the reference
# ----------------------------------------------------------------------

def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def training_checks(port: dict, ref: dict, u0, i0, hr: bool = False
                    ) -> dict:
    """The numbers compared for a training cell, each a gap of the
    program from the reference (0 is exact), over job 0's first epochs.

    * ``check_gap``: the checks' objective (or the BPR epochs' losses) and
      val RMSE (or HR@10), before and after the first epoch, as a share of
      the reference's (HR@10: the absolute gap of the share of hits);
    * ``step1_norm_gap`` / ``change_norm_gap``: the worst leaf (user or
      item factors) of |‖Δ_prog‖ − ‖Δ_ref‖| / max(‖Δ_ref‖, median leaf's
      ‖Δ_ref‖), Δ the change by the first epoch, and by all the checked
      epochs;
    * ``change_diff``: the worst leaf of ‖X_prog − X_ref‖ / max(‖Δ_ref‖,
      median leaf's) after the checked epochs, the one that separates a
      lower precision.

    A leaf whose first change in the reference is under a thousandth of
    the median leaf's moves by rounding alone, and is left out."""
    starts = (u0, i0)
    d1r = [_norm(ref["states"][0][j] - starts[j]) for j in (0, 1)]
    dnr = [_norm(ref["states"][-1][j] - starts[j]) for j in (0, 1)]
    med1, medn = statistics.median(d1r), statistics.median(dnr)
    leaves = [j for j in (0, 1) if d1r[j] >= 1e-3 * med1]
    out = {}
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    gaps = []
    for kind in port["checks"]:
        p, r = port["checks"][kind], ref["checks"][kind]
        if len(p) < len(r):
            return _failed(out)
        for a, b in zip(p, r):
            gaps.append(abs(a - b) if (hr and kind == "hr10") else rel(a, b))
    for a, b in zip(port.get("losses", []), ref.get("losses", [])):
        gaps.append(rel(a, b))
    out["check_gap"] = max(gaps) if gaps else math.inf
    n1, nn, dd = [], [], []
    for j in leaves:
        pst1, pstn = port["states"][0][j], port["states"][-1][j]
        n1.append(abs(_norm(pst1 - starts[j]) - d1r[j]) / max(d1r[j], med1))
        nn.append(abs(_norm(pstn - starts[j]) - dnr[j]) / max(dnr[j], medn))
        dd.append(_norm(pstn - ref["states"][-1][j]) / max(dnr[j], medn))
    out["step1_norm_gap"] = max(n1)
    out["change_norm_gap"] = max(nn)
    out["change_diff"] = max(dd)
    return out


def _failed(out: dict) -> dict:
    out["check_gap"] = math.inf
    return out


def finite_or_none(v: float):
    """A number as the result line can carry it: null where not finite."""
    return float(v) if math.isfinite(v) else None


def judge(checks: Dict[str, float], limits: dict):
    """(correct, {name: {value, limit}}): every number within its limit;
    a number the limits name that the run did not give, or one that is
    not finite, fails."""
    table, ok = {}, True
    for name, lim in limits["checks"].items():
        v = checks.get(name, math.nan)
        table[name] = dict(value=v, limit=lim["limit"])
        ok &= bool(math.isfinite(v) and v <= lim["limit"])
    return ok, table


# ----------------------------------------------------------------------
# the result
# ----------------------------------------------------------------------

def read_metrics(cell: Cell, record: dict, trace: bool) -> dict:
    """Each of the cell's metrics (its end-to-end ones without trace, its
    per-layer ones with) from its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.module("metrics", m["name"]).read(record)
        if v is not None:
            out[m["name"]] = dict(value=float(v), unit=m["unit"])
    return out
