"""The stream-BPR engine's batch on the card (csrc/bpr_step.cu through
matfac_tpu_torch/ops/bpr_step.py) against its plain version on the card:
the kernel sampler's negatives and weights equal the eager sampler's bit
for bit (hand-made rows and a larger set with explicit zeros); one step
of the kernel stays within f32 rounding of ``bpr_step_plain`` for every
route a batch takes (the rank-gap and gap samplers, posneg with its user
side sorted in the call, the hybrid's masks given, drawn and fixed),
f32 and bf16 tables, k 64, 128 and an odd k, and its plans equal
``plan_ordered``'s; two runs of an epoch give the same bits, loss and
inversions; an epoch makes one sampler and one step call a batch, two
scatters a batch, no ``index_add_ordered_`` call and no host sync; tables
the kernel does not take, and a batch past the stream, raise. Every test
here is marked ``cuda`` and skips without a CUDA device. This file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_bpr_step.py
"""

import numpy as np
import pytest
import torch

from matfac_tpu_torch.models.base import MFState
from matfac_tpu_torch.ops import bpr_step as step_mod
from matfac_tpu_torch.ops.scatter import plan_ordered

from test_torch_bpr_step import (CASES, ROWS, _masks, _solver, _triples,
                                 rows_matrix, rows_solver, scalar_rankgap)

KS = [64, 128, 33]
# f32 rounding: the dot products' and the batch loss's order of summation
TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 tables: the eager chain rounds its bf16 products to bf16
BF16_TOL = dict(rtol=2e-2, atol=2e-3)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests run the hand-written "
                    "BPR batch kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sums(dev):
    return (torch.zeros((), device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def _close(got, want, dtype):
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROWS) + ["lo_data"])
def test_kernel_sampler_equals_the_eager_sampler(case):
    """Every batch's negatives and weights from ``sample(t, b)`` equal the
    eager sampler's on the card bit for bit (and the scalar sampler's on
    the hand-made rows)."""
    dev = _cuda()
    s = _solver("rankgap", device=dev)[0] if case == "lo_data" else \
        rows_solver(case, device=dev)
    U = torch.zeros(s.model.n_users, 4, device=dev)
    I = torch.zeros(s.n_items, 4, device=dev)
    border, bits = s.draw()
    sample, _ = s.step.epoch(U, I, 0.1, bits, *_sums(dev))
    B = s.batch_size
    for t, b in enumerate(border.tolist()):
        sl = slice(b * B, (b + 1) * B)
        neg, w = (x.clone() for x in sample(t, b))
        want, ok = s.sample_rankgap(s.pos_start[sl], s.pos_deg[sl],
                                    bits[t, 0], bits[t, 1])
        assert torch.equal(neg, want), (t, b)
        assert torch.equal(w, s.pos_valid[sl] * ok.to(torch.float32))
        if case != "lo_data":
            scalar = scalar_rankgap(rows_matrix(ROWS[case]),
                                    s.pos_start[sl].cpu().numpy(),
                                    s.pos_deg[sl].cpu().numpy(),
                                    bits[t, 0].cpu().numpy(),
                                    bits[t, 1].cpu().numpy())
            assert neg.tolist() == [n for n, _ in scalar]


def _batch_inputs(s, t, b, bits, border, masks):
    u, p, neg, w = _triples(s, t, b, bits, border)
    m = masks[t] if masks is not None else s.model.triple_rank_mask(
        u, p, neg, generator=s.mask_gen)
    return u, p, neg, w, m


STEP_CASES = ["rankgap", "gap", "posneg", "hybrid_given", "hybrid_sigmoid",
              "hybrid_posneg"]


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", STEP_CASES)
def test_kernel_step_matches_the_plain_step(case, dtype, k):
    """One batch from one start through the kernel and through
    ``bpr_step_plain`` on the card: the tables within f32 rounding (bf16:
    within the eager chain's bf16 rounding), the loss and inversions too;
    the item plan of the call equals ``plan_ordered([p; neg])``, a user
    plan sorted in the call (posneg) ``plan_ordered(u)``."""
    dev = _cuda()
    s, state = _solver(case, k=k, device=dev)
    state = state._replace(u_fac=state.u_fac.to(dtype),
                           i_fac=state.i_fac.to(dtype))
    border, bits = s.draw()
    masks = _masks(s, border, bits, case)
    posneg = s.mode == "posneg"
    t = 1
    b = t if posneg else int(border[t])
    u, p, neg, w, m = _batch_inputs(s, t, b, bits, border, masks)
    U, I = state.u_fac.clone(), state.i_fac.clone()
    loss, inv = _sums(dev)
    rankgap = not posneg and s.sampler == "rankgap"
    _, step = s.step.epoch(U, I, 0.1, bits if rankgap else None, loss, inv)
    step(b, neg, w, m, *((u, p) if posneg else ()))
    Up, Ip = state.u_fac.clone(), state.i_fac.clone()
    plan = s.step.u_plans[b] if not posneg else None
    wl, wi = step_mod.bpr_step_plain(
        Up, Ip, u, p, neg, w, 0.1, float(s.params.u_reg),
        float(s.params.i_reg), float(s.params.eps), m, plan)
    torch.cuda.synchronize()
    _close(U, Up, dtype)
    _close(I, Ip, dtype)
    assert not torch.equal(U, state.u_fac)
    f32 = dtype == torch.float32
    assert float(loss) == pytest.approx(float(wl), rel=1e-4 if f32 else 1e-2)
    assert abs(int(inv) - int(wi)) <= (0 if f32 else 4)
    ids = s.step._ids
    want = plan_ordered(torch.cat([p, neg]))
    assert torch.equal(ids["i_rows"].long(), want.rows)
    assert torch.equal(ids["i_order"].long(), want.order)
    if posneg:
        want = plan_ordered(u)
        assert torch.equal(ids["u_rows"].long(), want.rows)
        assert torch.equal(ids["u_order"].long(), want.order)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_two_runs_of_an_epoch_are_bit_identical(case):
    """Two runs of one epoch from one start on one set of draws (the mask
    generator reset): the same bits, loss and inversions; with f32 tables
    within f32 rounding of the plain route's epoch on the card."""
    dev = _cuda()
    s, state = _solver(case, device=dev)
    border, bits = s.draw()
    masks = _masks(s, border, bits, case)
    gen0 = s.mask_gen.get_state()

    def run():
        s.mask_gen.set_state(gen0)
        st = s.epoch_with(MFState(*(t.clone() for t in state)), 0.1,
                          border, bits, masks)
        return st, s.last_loss.clone(), s.last_inversions.clone()

    (a, la, ia), (b, lb, ib) = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(la, lb) and torch.equal(ia, ib)
    if state.u_fac.dtype != torch.float32:
        return
    real = s.step.epoch
    s.step.epoch = s.step.epoch_plain
    try:
        c, lc, ic = run()
    finally:
        s.step.epoch = real
    _close(a.u_fac, c.u_fac, torch.float32)
    _close(a.i_fac, c.i_fac, torch.float32)
    assert float(la) == pytest.approx(float(lc), rel=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rankgap", "gap", "posneg",
                                  "hybrid_drawn"])
def test_an_epoch_is_two_kernel_calls_a_batch(case, monkeypatch):
    """An epoch makes one sampler call a batch (rank-gap) and one step
    call a batch, which report two ordered scatters each, and calls no
    ``index_add_ordered_``."""
    dev = _cuda()
    s, state = _solver(case, device=dev)

    def refuse(*a, **k):
        raise AssertionError("the eager scatter on the kernel route")

    monkeypatch.setattr(step_mod, "index_add_ordered_", refuse)
    before = (step_mod.BPRStep.launches, step_mod.BPRStep.sample_launches,
              step_mod.BPRStep.scatter_launches)
    s.epoch(state, 0.1)
    torch.cuda.synchronize()
    n = s.n_batches
    rankgap = s.mode == "stream" and s.sampler == "rankgap"
    assert (step_mod.BPRStep.launches - before[0],
            step_mod.BPRStep.sample_launches - before[1],
            step_mod.BPRStep.scatter_launches - before[2]) == \
        (n, n if rankgap else 0, 2 * n)


@pytest.mark.cuda
def test_an_epoch_makes_no_host_sync():
    """The batches of a rank-gap epoch enqueue without a host sync."""
    dev = _cuda()
    s, state = _solver("rankgap", device=dev)
    border, bits = s.draw()
    order = border.tolist()
    sample, step = s.step.epoch(state.u_fac, state.i_fac, 0.1, bits,
                                *_sums(dev))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t, b in enumerate(order):
            step(b, *sample(t, b), None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_what_the_kernel_does_not_take_raises():
    """Tables of another type, of mixed types, with strided columns, too
    few rows or on the CPU beside a card solver; words of another shape;
    a batch past the stream, a step past the words: each raises."""
    dev = _cuda()
    s, state = _solver("rankgap", device=dev)
    U, I = state.u_fac, state.i_fac
    border, bits = s.draw()
    sums = _sums(dev)
    for bad in ((U.double(), I.double()), (U, I.to(torch.bfloat16)),
                (U.t().contiguous().t(), I), (U[:-1], I),
                (U, I.cpu())):
        with pytest.raises(ValueError):
            s.step.epoch(*bad, 0.1, bits, *sums)
    with pytest.raises(ValueError):
        s.step.epoch(U, I, 0.1, bits[:, :, :1], *sums)
    sample, step = s.step.epoch(U, I, 0.1, bits, *sums)
    neg, w = sample(0, 0)
    with pytest.raises(ValueError):
        step(0, neg.int(), w, None)
    with pytest.raises(RuntimeError):
        step(s.n_batches, neg, w, None)
    with pytest.raises(RuntimeError):
        sample(bits.shape[0], 0)
    with pytest.raises(RuntimeError):
        sample(0, s.n_batches)
    torch.cuda.synchronize()
