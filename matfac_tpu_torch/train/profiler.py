"""Tracing / profiling hooks (port of matfac_tpu/train/profiler.py).

The reference's only tracing is wall-clock per-epoch prints
(modelMF.cpp:126-133, SURVEY.md §5). Here: a ``torch.profiler`` trace
around a window, written as a Chrome trace, and a throughput meter
(ratings/sec/chip — the BASELINE.md primary metric).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[profile]:
    """Profile the host and, on a CUDA ``device``, the card over the
    ``with`` block; on exit the Chrome trace (chrome://tracing, Perfetto)
    is written to ``log_dir/trace_<ms since the epoch>.json``, the path
    kept as the profile's ``trace_path``."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir,
                                   f"trace_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(prof.trace_path)


def device_count(device="cuda") -> int:
    """Chips behind ``device``: the visible CUDA devices on the card, 1 on
    the CPU; raises where a CUDA device is asked for and none is
    visible."""
    if torch.device(device).type != "cuda":
        return 1
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible")
    return n


class ThroughputMeter:
    """ratings/sec/chip counter over epochs; the chip count comes from
    ``device`` unless given."""

    def __init__(self, nnz: int, n_chips: Optional[int] = None,
                 device="cuda"):
        self.nnz = nnz
        self.n_chips = n_chips or device_count(device)
        self.reset()

    def reset(self):
        self._epochs = 0
        self._seconds = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._seconds += time.perf_counter() - self._t0
        self._epochs += 1
        self._t0 = None

    @property
    def ratings_per_sec(self) -> float:
        if self._seconds == 0:
            return 0.0
        return self.nnz * self._epochs / self._seconds

    @property
    def ratings_per_sec_per_chip(self) -> float:
        return self.ratings_per_sec / max(self.n_chips, 1)

    def summary(self) -> str:
        return (f"{self._epochs} epochs, "
                f"{self.ratings_per_sec / 1e6:.2f}M ratings/s "
                f"({self.ratings_per_sec_per_chip / 1e6:.2f}M/chip)")
