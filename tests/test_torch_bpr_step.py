"""The stream-BPR engine's batch on the CPU (matfac_tpu_torch/ops/bpr_step.py):
``bpr_sample_plain`` against a scalar model of the rank-gap sampler on
hand-made train rows (explicit zeros, empty gaps, single-entry rows,
last-entry gaps, padding positives); ``bpr_step_plain`` equals the
engine's former eager step bit for bit, with and without a rank mask and
a staged user plan; ``BPRSolver.epoch_with`` on CPU tables goes through
the plain lines once a batch and equals the former eager epoch bit for
bit, for every route a batch takes (the rank-gap and the literal gap
samplers, posneg, the BPR x TMF+Poisson hybrid's masks given, drawn and
fixed, bf16 tables), its batches counted and no kernel step; the batch
checks the kernel route makes. The kernel route is held to these on the
card: tests/test_torch_cuda_bpr_step.py. This file imports no JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.data.synthetic import leave_one_out_data
from matfac_tpu_torch.models.bpr import ModelBPRPoissonDropout, ModelMFBPR
from matfac_tpu_torch.models.base import MFState
from matfac_tpu_torch.ops import bpr_step as step_mod
from matfac_tpu_torch.ops.scatter import index_add_ordered_, stage_plans
from matfac_tpu_torch.solvers.bpr import BPRSolver
from matfac_tpu_torch.train import profiler as tprof
from matfac_tpu_torch.utils import freq

# case: (model, BPRSolver keywords, how the masks come, tables' type)
CASES = {
    "rankgap": ("bpr", {}, None, torch.float32),
    "gap": ("bpr", {"sampler": "gap"}, None, torch.float32),
    "posneg": ("bpr", {"mode": "posneg"}, None, torch.float32),
    "hybrid_given": ("hybrid", {}, "given", torch.float32),
    "hybrid_drawn": ("hybrid", {}, "drawn", torch.float32),
    "hybrid_sigmoid": ("sigmoid", {}, "fixed", torch.float32),
    "hybrid_posneg": ("hybrid", {"mode": "posneg"}, "given", torch.float32),
    "bf16": ("bpr", {}, None, torch.bfloat16),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data():
    """Implicit feedback with explicit zeros (a third of the train
    entries) and never-rated items, so every sampler branch is taken."""
    data = leave_one_out_data(n_users=70, n_items=90, per_user=12, seed=6,
                              structured=True)
    data.train_mat.values[::3] = 0.0
    return data


def _solver(case, k=8, device="cpu"):
    """The case's solver and a start whose entries are multiples of 2**-8
    in [-1/4, 1/4] (exact in bf16; a dot product of two rows is exact in
    f32 in any order of summation), in the case's type."""
    name, kw, _, dtype = CASES[case]
    data = _data()
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    uf, if_ = freq.row_col_freq(data.train_mat)
    pad = lambda a, n: np.pad(a, (0, max(n - len(a), 0)))[:n]
    p = Params(fac_dim=k, u_reg=0.01, i_reg=0.02, learn_rate=0.1, seed=3,
               batch_size=64, eps=1e-3)
    if name == "bpr":
        model = ModelMFBPR(p, data.n_users, data.n_items)
    else:
        model = ModelBPRPoissonDropout(p, data.n_users, data.n_items,
                                       pad(uf, data.n_users),
                                       pad(if_, data.n_items),
                                       sample_poisson=name == "hybrid")
    s = BPRSolver(model, p, data.train_mat, iu, ii, device=device, **kw)
    g = torch.Generator().manual_seed(4)
    rnd = lambda *shape: (torch.randint(-64, 65, shape, generator=g)
                          / 256).to(device=device, dtype=dtype)
    state = MFState(rnd(data.n_users, k), rnd(data.n_items, k),
                    torch.zeros(data.n_users, device=device),
                    torch.zeros(data.n_items, device=device),
                    torch.zeros((), device=device))
    return s, state


def _triples(s, t, b, bits, border):
    """Step t's (u, p, neg, w) as the former epoch drew them."""
    B = s.batch_size
    if s.mode == "posneg":
        return s.sample_posneg(bits[t])
    sl = slice(b * B, (b + 1) * B)
    sample = s.sample_rankgap if s.sampler == "rankgap" else s.sample_gap
    neg, ok = sample(s.pos_start[sl], s.pos_deg[sl], bits[t, 0], bits[t, 1])
    return s.pos_u[sl], s.pos_i[sl], neg, s.pos_valid[sl] * ok.to(
        torch.float32)


def _masks(s, border, bits, case):
    """The case's masks of each step, drawn ahead (``epoch_with``'s
    ``masks=``), or None where the epoch asks the model."""
    if CASES[case][2] != "given":
        return None
    g = torch.Generator(device=s.device).manual_seed(11)
    steps = range(s.n_batches) if s.mode == "posneg" else range(len(border))
    return [s.model.triple_rank_mask(*_triples(s, t, None if border is None
                                               else int(border[t]), bits,
                                               border)[:3], generator=g)
            for t in steps]


def _eager_epoch(s, state, lr, border, bits, masks=None):
    """``BPRSolver.epoch_with`` as the engine ran it before its batch moved
    to ops/bpr_step.py: the eager chain, line for line (``_step`` and
    ``bpr_pair_terms`` inlined). Returns (state, loss, inversions)."""
    p = s.params
    U, I = state.u_fac.clone(), state.i_fac.clone()
    loss = torch.zeros((), device=s.device)
    inv = torch.zeros((), dtype=torch.int64, device=s.device)
    B = s.batch_size
    steps = (list(enumerate(range(s.n_batches))) if s.mode == "posneg"
             else list(enumerate(border.tolist())))
    for t, b in steps:
        u, pos, neg, w = _triples(s, t, b, bits, border)
        plan = None
        if s.mode != "posneg" and s.step.u_plans:
            plan = s.step.u_plans[b]
        m = None if masks is None else torch.as_tensor(
            masks[t], dtype=torch.float32, device=s.device)
        if m is None:
            m = s.model.triple_rank_mask(u, pos, neg, generator=s.mask_gen)
        pu, qp, qn = U[u], I[pos], I[neg]
        u_reg, i_reg = float(p.u_reg), float(p.i_reg)
        pm = pu if m is None else pu * m
        r_uij = (pm * qp).sum(dim=1) - (pm * qn).sum(dim=1)
        bl = (w * torch.logaddexp(torch.zeros_like(r_uij), -r_uij)).sum()
        coeff = w * (-1.0 / (1.0 + torch.exp(r_uij)))
        gu = coeff[:, None] * (qp - qn) + 2.0 * u_reg * w[:, None] * pu
        gp = coeff[:, None] * pu + 2.0 * i_reg * w[:, None] * qp
        gn = -coeff[:, None] * pu + 2.0 * i_reg * w[:, None] * qn
        if m is not None:
            gu, gp, gn = gu * m, gp * m, gn * m
        bi = ((-r_uij > float(p.eps)) & (w > 0)).sum()
        index_add_ordered_(U, 0, u, (-lr * gu).to(U.dtype), plan)
        index_add_ordered_(I, 0, torch.cat([pos, neg]),
                           (-lr * torch.cat([gp, gn])).to(I.dtype))
        loss, inv = loss + bl, inv + bi
    return state._replace(u_fac=U, i_fac=I), loss, inv


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("case", ["rankgap", "hybrid_given",
                                  "hybrid_sigmoid", "bf16"])
def test_plain_step_equals_the_former_step(case, plan):
    """One batch through ``bpr_step_plain``, given the triples, the mask
    and, or not, the batch's user plan, equals the former eager step on
    the same tables bit for bit: tables, loss and inversions."""
    s, state = _solver(case)
    border, bits = s.draw()
    masks = _masks(s, border, bits, case)
    lr = 0.1
    for t in (0, s.n_batches - 1):
        b = int(border[t])
        want, wl, wi = _eager_epoch(
            s, state, lr, border[t:t + 1], bits[t:t + 1],
            None if masks is None else masks[t:t + 1])
        u, pos, neg, w = _triples(s, t, b, bits, border)
        m = masks[t] if masks is not None else s.model.triple_rank_mask(
            u, pos, neg)
        up = stage_plans(u[None, :], s.model.n_users)[0] if plan else None
        U, I = state.u_fac.clone(), state.i_fac.clone()
        gl, gi = step_mod.bpr_step_plain(
            U, I, u, pos, neg, w, lr, float(s.params.u_reg),
            float(s.params.i_reg), float(s.params.eps), m, up)
        assert torch.equal(U, want.u_fac) and torch.equal(I, want.i_fac)
        assert torch.equal(gl, wl) and torch.equal(gi, wi)
        assert not torch.equal(U, state.u_fac)


@pytest.mark.parametrize("case", list(CASES))
def test_a_cpu_epoch_goes_through_the_plain_step(case, monkeypatch):
    """``epoch_with`` on CPU tables calls ``bpr_step_plain`` once a batch
    (the kernel route never) and equals the former eager epoch bit for
    bit, the drawn masks included; under a profiler its batches are
    counted and no kernel step is."""
    s, state = _solver(case)
    border, bits = s.draw()
    masks = _masks(s, border, bits, case)
    calls = []
    real = step_mod.bpr_step_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(step_mod, "bpr_step_plain", counted)
    launches = (step_mod.BPRStep.launches, step_mod.BPRStep.sample_launches)
    gen0 = s.mask_gen.get_state()
    tprof.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        got = s.epoch_with(MFState(*(t.clone() for t in state)), 0.1,
                           border, bits, masks)
    finally:
        prof.stop()
    counts = tprof.records()["counts"]
    tprof.reset()
    s.mask_gen.set_state(gen0)
    want, loss, inv = _eager_epoch(s, state, 0.1, border, bits, masks)
    assert len(calls) == s.n_batches
    assert (step_mod.BPRStep.launches,
            step_mod.BPRStep.sample_launches) == launches
    assert counts.get("bpr.batches") == s.n_batches
    assert "bpr.step" not in counts
    assert _same(got, want)
    assert torch.equal(s.last_loss, loss)
    assert torch.equal(s.last_inversions, inv) and int(inv) > 0
    assert not _same(got, state)


# ----------------------------------------------------------------------
# the rank-gap sampler on hand-made train rows
# ----------------------------------------------------------------------

N_ITEMS = 12
# case: rows of (item, rating); 0.0 an explicit zero (not a positive)
ROWS = {
    # explicit zeros inside, at the front and at the end of rows
    "explicit_zeros": [[(0, 0.0), (2, 1.0), (5, 0.0), (9, 1.0)],
                       [(1, 1.0), (3, 0.0), (4, 1.0), (11, 0.0)],
                       [(6, 1.0), (7, 0.0)], [(2, 1.0), (10, 1.0)]],
    # consecutive items, and gaps that hold only never-rated items (8)
    "empty_gaps": [[(3, 1.0), (4, 1.0), (5, 1.0)],
                   [(7, 1.0), (9, 1.0), (10, 1.0), (11, 1.0)],
                   [(0, 1.0), (1, 1.0), (2, 1.0)], [(6, 1.0), (7, 1.0)]],
    # one entry a row: its gap runs from 0 (jj == 0 wins over the last)
    "single_entry_rows": [[(0, 1.0)], [(7, 1.0)], [(11, 1.0)], [(3, 1.0)],
                          [(1, 0.0), (5, 1.0)]],
    # rows that end at the last item, or well before it
    "last_entry_gaps": [[(2, 1.0), (11, 1.0)], [(0, 1.0), (4, 1.0)],
                        [(5, 1.0), (9, 1.0), (10, 1.0), (11, 1.0)],
                        [(1, 1.0), (6, 1.0)]],
    # 11 positives in batches of 4: one padding positive
    "padding_positives": [[(1, 1.0), (4, 1.0), (9, 1.0)],
                          [(0, 1.0), (2, 1.0), (6, 1.0), (10, 1.0)],
                          [(3, 1.0), (5, 1.0)], [(7, 1.0), (11, 1.0)]],
}


def rows_matrix(rows):
    indptr = np.cumsum([0] + [len(r) for r in rows])
    items = np.array([i for r in rows for i, _ in r], np.int32)
    vals = np.array([v for r in rows for _, v in r], np.float32)
    return RatingMatrix(indptr, items, vals, N_ITEMS)


def rows_solver(case, device="cpu", n_tries=3):
    """A rank-gap solver over the case's rows, batches of 4."""
    mat = rows_matrix(ROWS[case])
    p = Params(fac_dim=4, seed=5, batch_size=4)
    none = np.zeros(mat.nrows, bool), np.zeros(N_ITEMS, bool)
    return BPRSolver(ModelMFBPR(p, mat.nrows, N_ITEMS), p, mat, *none,
                     n_tries=n_tries, device=device)


def scalar_rankgap(mat, start, deg, jj, jb):
    """The rank-gap sampler one positive at a time, from the CSR itself
    (sampleNegItem's gaps, modelMFBPR.cpp:191-242, drawn by rank over the
    train items in the gap): (neg, found) of each positive."""
    ip, cols, vals = mat.indptr, mat.indices, mat.values
    train = np.bincount(cols, minlength=N_ITEMS) > 0
    nnz = len(cols)
    out = []
    for e in range(len(start)):
        found = None
        for q in range(jj.shape[0]):
            pos = min(max(int(start[e]) + int(jj[q, e]) % int(deg[e]), 0),
                      nnz - 1)
            if vals[pos] == 0.0:
                found = int(cols[pos])
                break
            row = int(np.searchsorted(ip, pos, side="right")) - 1
            at, n = pos - int(ip[row]), int(ip[row + 1] - ip[row])
            col = int(cols[pos])
            if at == 0:
                lo, hi = 0, col
            elif at == n - 1:
                lo, hi = col + 1, N_ITEMS
            else:
                lo, hi = col + 1, int(cols[pos + 1])
            gap = [i for i in range(lo, hi) if train[i]]
            if gap:
                found = gap[int(jb[q, e]) % len(gap)]
                break
        out.append((0 if found is None else found, found is not None))
    return out


@pytest.mark.parametrize("case", list(ROWS))
def test_sample_plain_equals_the_scalar_sampler(case):
    """Every batch's negatives and weights through the plain route (and
    the solver's ``sample_rankgap``) equal the scalar sampler's, on words
    that reach every entry of every row."""
    s = rows_solver(case)
    mat = rows_matrix(ROWS[case])
    border, bits = s.draw()
    sample, _ = s.step.epoch_plain(None, None, 0.1, bits, None, None)
    found = []
    for t, b in enumerate(border.tolist()):
        sl = slice(b * 4, (b + 1) * 4)
        neg, w = sample(t, b)
        neg2, ok = s.sample_rankgap(s.pos_start[sl], s.pos_deg[sl],
                                    bits[t, 0], bits[t, 1])
        want = scalar_rankgap(mat, s.pos_start[sl].numpy(),
                              s.pos_deg[sl].numpy(), bits[t, 0].numpy(),
                              bits[t, 1].numpy())
        assert neg.tolist() == neg2.tolist() == [n for n, _ in want]
        assert ok.tolist() == [f for _, f in want]
        assert w.tolist() == [float(v and f) for v, (_, f) in
                              zip(s.pos_valid[sl].tolist(), want)]
        found += [f for _, f in want]
    assert any(found)
    if case in ("empty_gaps", "single_entry_rows", "last_entry_gaps"):
        assert not all(found)      # some positives find no negative
    if case == "padding_positives":
        assert s.n_pos % 4 and float(s.pos_valid.sum()) == s.n_pos


# ----------------------------------------------------------------------
# what the kernel route checks of a batch
# ----------------------------------------------------------------------

def _batch(B=8, k=4):
    return dict(neg=torch.zeros(B, dtype=torch.int64),
                w=torch.ones(B), m=torch.ones(B, k),
                u=torch.zeros(B, dtype=torch.int64),
                p=torch.zeros(B, dtype=torch.int64))


BAD = {
    "neg_int32": ("neg", lambda t: t.to(torch.int32)),
    "w_float64": ("w", lambda t: t.double()),
    "w_strided": ("w", lambda t: torch.ones(16)[::2]),
    "mask_shape": ("m", lambda t: t[:, :3]),
    "mask_column_stride": ("m", lambda t: torch.ones(4, 8).t()),
    "u_length": ("u", lambda t: t[:7]),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_the_kernel_route_refuses_a_batch_it_does_not_take(bad):
    """``_check_batch`` takes int64 ids, f32 weights, a f32 [B, k] mask of
    unit column stride and raises on anything else."""
    good = _batch()
    step_mod._check_batch(**good, B=8, k=4, device=-1)
    name, spoil = BAD[bad]
    args = dict(good, **{name: spoil(good[name])})
    with pytest.raises(ValueError):
        step_mod._check_batch(**args, B=8, k=4, device=-1)


def test_a_cpu_solver_refuses_cuda_tables():
    """A solver staged on the CPU stages no kernel arguments; its step
    takes CPU tables only."""
    s, state = _solver("rankgap")
    assert s.step._args is None

    class Cuda:
        is_cpu = False

    with pytest.raises(ValueError, match="staged on the CPU"):
        s.step.epoch(Cuda(), state.i_fac, 0.1, None, None, None)
