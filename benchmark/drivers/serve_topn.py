"""Top-N serving through ``Recommender.recommend``, by one client.

Traffic keys: ``n`` (the list's length), ``users_per_request``,
``arrivals`` and, for an open loop, ``rate_per_s``:

* ``closed``: each request is sent when the previous answer is in host
  memory; the window closes at the first answer after ``--seconds``;
* ``paced``: requests arrive at ``rate_per_s`` with equal gaps, each
  sent at its arrival or, where the client is still busy, as soon as it
  is free; the window takes the arrivals of ``--seconds``. A request's
  latency runs from its arrival, so a wait behind an earlier request
  counts;
* ``poisson``: the same with exponential gaps (the same gaps for every
  seed, the quantiles of the law, in an order drawn from it).

Set-up: the positives and the serving factors made on the card, the train
CSR on the host, the ``Recommender`` (its exclusion lists staged), a pool
of ``pool_requests`` requests drawn from the seed (the users of a request
distinct, cut from random permutations of all users) and
``warmup_requests`` of the same size. The window sends the pool's
requests in order, from the start again if it runs out. Every
``sample_every``-th request of the pool on average (drawn from the seed)
is compared with the reference after the window. With ``trace``,
``profile_requests`` more are sent back to back under the profiler."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import harness, roofline


def request_pool(seed: int, n_users: int, count: int, size: int):
    """``count`` requests of ``size`` distinct user ids (int64 arrays)."""
    rng = np.random.default_rng(seed)
    out, perm, at = [], rng.permutation(n_users), 0
    for _ in range(count):
        if at + size > n_users:
            perm, at = rng.permutation(n_users), 0
        out.append(perm[at:at + size])
        at += size
    return out


def arrival_gaps(tr: dict, seed: int, count: int):
    """The seconds between arrivals (None for a closed loop); Poisson:
    ``count`` quantiles of the exponential law of mean 1 / rate, in an
    order drawn from the seed."""
    if tr["arrivals"] == "closed":
        return None
    if tr["arrivals"] == "paced":
        return np.full(count, 1.0 / float(tr["rate_per_s"]))
    if tr["arrivals"] != "poisson":
        raise ValueError(f"arrivals {tr['arrivals']!r}")
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q) / float(tr["rate_per_s"])
    return gaps[np.random.default_rng(seed).permutation(count)]


def setup(cell, seed: int, device, t0: float) -> dict:
    """Everything before the window: inputs, the program staged, the
    request pool, the arrivals, the warm-up."""
    from matfac_tpu_torch.models.base import EvalView
    from matfac_tpu_torch.serving import Recommender

    cfg, tr = cell.config, cell.traffic
    gen = cell.module("data", cfg["generator"])
    bundle = gen.make(cfg, seed, device)
    U, V = gen.serve_factors(cfg, bundle, device)
    nu, ni, k, n = bundle["n_users"], bundle["n_items"], cfg["fac_dim"], \
        tr["n"]
    harness.log(f"set-up: inputs made at {time.perf_counter() - t0:.3f} s")
    train_mat = harness.host_csr(bundle["train"], nu, ni)
    deg = train_mat.row_degrees()
    z = lambda m: torch.zeros(m, dtype=torch.float32, device=device)
    rec = Recommender(EvalView(U, V, z(nu), z(ni), z(())), train_mat, nu,
                      ni)
    harness.log(f"set-up: recommender staged at {time.perf_counter() - t0:.3f}"
                " s")
    size = tr["users_per_request"]
    pool = request_pool(seed, nu, tr["pool_requests"], size)
    rng = np.random.default_rng(seed + 1)
    sampled = rng.random(len(pool)) < 1.0 / tr["sample_every"]
    gaps = arrival_gaps(tr, seed + 3, len(pool))
    for req in request_pool(seed + 2, nu, tr["warmup_requests"], size):
        rec.recommend(req, n)
    work = [roofline.topn_work(len(r), ni, k, int(deg[r].sum()), n)
            for r in pool]
    least = np.array([roofline.least_time(*w) for w in work])
    harness.log("requests bound by "
                f"{sorted({roofline.bound_by(*w) for w in work})}")
    harness.sync(device)
    return dict(rec=rec, pool=pool, sampled=sampled, gaps=gaps, least=least,
                n=n, inputs=dict(U=U, V=V, train=bundle["train"],
                                 n_users=nu, n_items=ni))


def window(s: dict, seconds: float, gaps=None, keep: bool = True) -> dict:
    """The measured window over the pool's requests; ``gaps`` None is a
    closed loop. Latency: arrival (closed: the call) to the answer in host
    memory; service: the call to the answer."""
    rec, pool, n = s["rec"], s["pool"], s["n"]
    lat, service, kept = [], [], []
    users = i = 0
    t_open = due = time.perf_counter()
    while True:
        t = time.perf_counter()
        if gaps is None:
            if t - t_open >= seconds:
                break
            due = t
        else:
            due += gaps[i % len(gaps)]
            if due - t_open >= seconds:
                break
            while t < due:
                t = time.perf_counter()
        req = pool[i % len(pool)]
        ids, sc = rec.recommend(req, n)
        done = time.perf_counter()
        lat.append(done - due)
        service.append(done - t)
        if keep and i < len(pool) and s["sampled"][i]:
            kept.append((req, ids, sc))
        users += len(req)
        i += 1
    window_s = (t if gaps is None else time.perf_counter()) - t_open
    least = s["least"]
    least_s = float(least.sum() * (i // len(pool))
                    + least[: i % len(pool)].sum())
    return dict(window_s=window_s, latencies_s=lat, service_s=service,
                requests=i, users=users, least_s=least_s,
                request_wall_s=float(sum(service)), kept=kept)


def profile(s: dict, start: int, count: int, device) -> dict:
    """``count`` requests of the pool from ``start``, back to back, under
    the profiler: the device's share of a request."""
    rec, pool, n, least = s["rec"], s["pool"], s["n"], s["least"]
    prof = harness.start_profile()
    tp = time.perf_counter()
    pu, pl = 0, 0.0
    for j in range(count):
        req = pool[(start + j) % len(pool)]
        with torch.profiler.record_function("bench.request"):
            rec.recommend(req, n)
        pu += len(req)
        pl += float(least[(start + j) % len(pool)])
    harness.sync(device)
    wall = time.perf_counter() - tp
    prof.stop()
    out = harness.summarize_profile(prof, wall)
    out.update(requests=count, users=pu, least_s=pl)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float):
    tr = cell.traffic
    s = setup(cell, seed, device, t0)
    setup_s = time.perf_counter() - t0
    record = window(s, seconds, s["gaps"])
    kept = record.pop("kept")
    record["setup_s"] = setup_s
    if trace:
        record["prof"] = profile(s, record["requests"],
                                 tr["profile_requests"], device)
    dev_info = harness.device_info(device, cell.chips)
    inputs = s["inputs"]
    del s
    harness.free_device(device)
    ref = cell.module("reference", tr["reference"])
    checks = serve_checks(ref, inputs, kept, tr["n"], device)
    harness.log(f"{cell.name}: {record['requests']} requests, "
                f"{record['users']} users in {record['window_s']:.3f} s, "
                f"set-up {setup_s:.3f} s, {len(kept)} answers compared")
    return dict(record=record, checks=checks, attempted=record["requests"],
                failed=0, device=dev_info, inputs=inputs, kept=kept)


def serve_checks(ref, inp: dict, kept, n: int, device) -> dict:
    """The numbers compared for a serving cell over the sampled answers,
    each scaled by max(|the reference's best score of the user|, 1):

    * ``score_err``: the widest gap between a served score and the
      reference's score of the same item;
    * ``rank_gap``: the widest gap by which the reference's score of the
      item served at a rank lies below the reference's score at that rank
      (inf where the item may not be served or a row repeats an item)."""
    if not kept:
        return dict(score_err=math.inf, rank_gap=math.inf)
    users = torch.from_numpy(np.concatenate([r for r, _, _ in kept])).to(
        device)
    ids = torch.from_numpy(np.concatenate([i for _, i, _ in kept])).to(
        device)
    sc = torch.from_numpy(np.concatenate([s for _, _, s in kept])).to(device)
    best, at = ref.follow(inp, users, ids, n)
    scale = best[:, :1].abs().clamp(min=1.0)
    srt = torch.sort(ids, dim=1).values
    repeats = (srt[:, 1:] == srt[:, :-1]).any()
    gap = ((best - at) / scale).max()
    return dict(score_err=float(((sc - at).abs() / scale).max()),
                rank_gap=math.inf if bool(repeats) else float(gap))
