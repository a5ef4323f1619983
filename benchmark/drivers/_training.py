"""What the training drivers share: the jobs run back to back through a
loop of the program, the window over their epochs, the record the metric
readers read, and the comparison of job 0's first epochs with the
reference.

A job runs the loop from fresh factors made on the card from (seed, job)
until its epochs are done; the next starts at once. The window closes at
the first epoch boundary after ``seconds`` (see ``harness.EpochWindow``);
with ``trace`` a profiled sub-window of the traffic's ``profile_epochs``
follows it.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness, roofline


def window(cell, loop, solver, seed: int, seconds: float, trace: bool,
           device, t0: float, dims, checks, loss_of=None,
           dtype=torch.float32) -> dict:
    """Run the jobs of ``loop`` for the window. ``checks``: (owner, name,
    kind) of the loop's checks to wrap; ``dims``: (n_users, n_items, k);
    ``dtype``: of job 0's tables (bf16: the program's lower-precision
    path, a control). Returns the window's facts and job 0's kept
    epochs."""
    tr = cell.traffic
    nu, ni, k = dims
    win = harness.EpochWindow(solver, seconds, trace, tr["checked_epochs"],
                              tr["profile_epochs"], device, loss_of)
    for owner, name, kind in checks:
        win.wrap_check(owner, name, kind)
    harness.sync(device)
    setup_s = win.open() - t0
    job, start = 0, None
    try:
        while True:
            state = harness.job_state(nu, ni, k, seed, job, device,
                                      dtype if job == 0 else torch.float32)
            if job == 0:
                start = harness.job_factors(nu, ni, k, seed, job, device)
            win.start_job(job)
            loop.run(state)
            job += 1
    except harness.WindowClosed:
        pass
    finally:
        win.restore()
    harness.sync(device)
    out = dict(setup_s=setup_s, epochs=win.epochs, window_s=win.window_s,
               enqueue_s=win.enqueue_s, check_s=win.check_s,
               jobs_started=job + 1, failed=win.failed,
               device=harness.device_info(device, cell.chips), start=start,
               port=dict(states=win.kept_states, checks=win.kept_checks,
                         losses=[float(x) for x in win.kept_losses]))
    if trace:
        out["prof"] = harness.summarize_profile(win.prof, win.prof_wall)
        out["prof"]["epochs"] = win.prof_epochs
    return out


def finish(cell, w: dict, unit: str, units_per_epoch: int, work: tuple,
           inputs: dict, ref_out: dict, hr: bool = False) -> dict:
    """The driver's outcome: the record for the readers, the numbers
    compared, the device; and, for a calibration, what the reference was
    handed and what it gave. ``work``: (FLOPs, bytes) of an epoch."""
    least_epoch_s = roofline.least_time(*work)
    record = dict(setup_s=w["setup_s"], unit=unit,
                  units_per_epoch=units_per_epoch, epochs=w["epochs"],
                  window_s=w["window_s"], enqueue_s=w["enqueue_s"],
                  check_s=w["check_s"], least_epoch_s=least_epoch_s)
    if "prof" in w:
        record["prof"] = w["prof"]
    checks = harness.training_checks(w["port"], ref_out, *w["start"], hr=hr)
    harness.log(f"{cell.name}: {w['epochs']} epochs in {w['window_s']:.3f} s"
                f" ({w['jobs_started']} jobs), set-up {w['setup_s']:.3f} s")
    harness.log(f"least time {1e6 * least_epoch_s:.1f} us an epoch, bound "
                f"by {roofline.bound_by(*work)}")
    if w["enqueue_s"]:
        q = sorted(w["enqueue_s"])
        harness.log(f"epoch enqueue ms: min {1e3 * q[0]:.1f} median "
                    f"{1e3 * q[len(q) // 2]:.1f} max {1e3 * q[-1]:.1f}")
    return dict(record=record, checks=checks, attempted=w["epochs"],
                failed=w["failed"], device=w["device"], inputs=inputs,
                ref=ref_out)


def reference_inputs(bundle: dict, w: dict, seed: int, skip: int) -> dict:
    """What the reference is handed: the generated splits, job 0's first
    factors, the seed and the epochs drawn before job 0 (the warm-up)."""
    return dict(train=bundle["train"], val=bundle["val"],
                n_users=bundle["n_users"], n_items=bundle["n_items"],
                u0=w["start"][0], i0=w["start"][1], seed=seed, skip=skip)


def run_reference(cell, inputs: dict, hp: dict, device):
    harness.free_device(device)
    ref = cell.module("reference", cell.traffic["reference"])
    t = time.perf_counter()
    out = ref.follow(inputs, hp, cell.traffic["checked_epochs"])
    harness.sync(device)
    harness.log(f"reference: {time.perf_counter() - t:.3f} s")
    return out
