"""The sgd engine's fused batch step on the card (csrc/sgd_step.cu through
matfac_tpu_torch/ops/sgd_step.py) against its plain version on the card,
for every input the step takes, f32 and bf16 tables, k 64, 128 and an odd
k: one batch from a start whose dot products are exact in any order
equals the plain step bit for bit (the only difference the kernel may
make is the dot product's order of summation); an epoch stays within f32
rounding of the plain route; two runs of an epoch give the same bits; an
epoch makes one kernel call a batch, no ``index_add_ordered_`` call and
no host sync. Every test here is marked ``cuda`` and skips without a CUDA
device. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sgd_step.py
"""

import numpy as np
import pytest
import torch

from matfac_tpu_torch.ops import scatter as scatter_mod
from matfac_tpu_torch.ops import sgd_step as step_mod

from test_torch_sgd_step import CASES, _masks, _solver

DTYPES = ["float32", "bfloat16"]
KS = [64, 128, 33]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests run the hand-written "
                    "sgd step kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_solver(case, k, dtype):
    return _solver(case, k=k, device="cuda", dtype=dtype)


def _plain(solver):
    """``solver``'s epochs through ``sgd_step_plain`` on the card (the
    eager route, its scatters by the staged plans)."""
    solver.step.epoch = solver.step.epoch_plain
    return solver


def _epoch(solver, state, border, masks, gen0):
    solver._mask_gen.set_state(gen0)
    return solver.epoch_with(state, 0.05, border, masks)


def _bf16_ulps(got, want):
    """The largest gap in units of the last place of the table's largest
    value in bf16."""
    top = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top + 1e-30)) - 7)
    return float((got.float() - want.float()).abs().max()) / ulp


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_step_equals_the_plain_step(case, dtype, k):
    """The first batch of an epoch from an exact start: bit for bit; the
    whole epoch: f32 at rtol 1e-5 / atol 1e-6 (the dot products' order of
    summation, carried through the batches), bf16 within 2 ulps of the
    table's largest value (a flipped rounding)."""
    _cuda()
    s, state = _card_solver(case, k, dtype)
    border = s.batch_order()
    masks = _masks(s, border.tolist()) if case != "tmfdropout_drawn" \
        else None
    gen0 = s._mask_gen.get_state()
    first = border[:1]
    got1 = _epoch(s, state, first, masks and masks[:1], gen0)
    got = _epoch(s, state, border, masks, gen0)
    p, _ = _card_solver(case, k, dtype)
    _plain(p)
    want1 = _epoch(p, state, first, masks and masks[:1], gen0)
    want = _epoch(p, state, border, masks, gen0)
    torch.cuda.synchronize()
    for a, b, name in zip(got1, want1, state._fields):
        assert torch.equal(a, b), name
    for a, b, name in zip(got, want, state._fields):
        assert a.dtype == b.dtype and a.device.type == "cuda"
        if dtype == "float32":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                       msg=name)
        elif b.numel() > 1:
            assert _bf16_ulps(a, b) <= 2, name
    moved = got.u_fac if s.model.use_factors else got.u_bias
    assert not torch.equal(moved, state.u_fac if s.model.use_factors
                           else state.u_bias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["mf", "tmf_bias", "tmfdropout_drawn",
                                  "collision_norm"])
def test_two_runs_of_an_epoch_are_bit_identical(case, dtype):
    _cuda()
    s, state = _card_solver(case, 64, dtype)
    border = s.batch_order()
    gen0 = s._mask_gen.get_state()
    a = _epoch(s, state, border, None, gen0)
    b = _epoch(s, state, border, None, gen0)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mf", "tmf_bias"])
def test_an_epoch_is_one_kernel_call_a_batch(case, monkeypatch):
    """One ``sgd_step`` call a batch, which reports its ordered scatter
    launches (one a batch side: 2, 4 with biases);
    ``index_add_ordered_`` and the ordered scatter's own entry are not
    called."""
    _cuda()
    s, state = _card_solver(case, 64, "float32")

    def refuse(*a, **k):
        raise AssertionError("the fused route called index_add_ordered_")

    monkeypatch.setattr(step_mod, "index_add_ordered_", refuse)
    steps = step_mod.SGDStep.launches
    fused = step_mod.SGDStep.scatter_launches
    scatters = scatter_mod.ordered_scatter.launches
    s.epoch_with(state, 0.05, s.batch_order())
    torch.cuda.synchronize()
    assert step_mod.SGDStep.launches == steps + s.n_batches
    sides = 4 if s.model.use_bias else 2
    assert step_mod.SGDStep.scatter_launches == fused + sides * s.n_batches
    assert scatter_mod.ordered_scatter.launches == scatters


@pytest.mark.cuda
def test_an_epoch_makes_no_host_sync():
    _cuda()
    s, state = _card_solver("tmf_bias", 64, "float32")
    border = s.batch_order()
    s.epoch_with(state, 0.05, border)     # builds, loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s.epoch_with(state, 0.05, border)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_column_major_start_trains_as_a_row_major_one(dtype):
    """An SVD start hands the engine column-major tables: the epoch copies
    them row-major and gives the same bits."""
    _cuda()
    s, state = _card_solver("reg_vec", 64, dtype)
    border = s.batch_order()
    cm = state._replace(u_fac=state.u_fac.t().contiguous().t(),
                        i_fac=state.i_fac.t().contiguous().t())
    assert cm.i_fac.stride(1) != 1
    a = s.epoch_with(cm, 0.05, border)
    b = s.epoch_with(state, 0.05, border)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_tables_the_kernel_does_not_take_raise():
    _cuda()
    s, state = _card_solver("mf", 64, "float32")
    with pytest.raises(ValueError, match="does not take"):
        s.step.epoch(state.u_fac.double(), state.i_fac.double(),
                     state.u_bias, state.i_bias, 0.05)
    with pytest.raises(ValueError, match="does not take"):
        s.step.epoch(state.u_fac.t(), state.i_fac, state.u_bias,
                     state.i_bias, 0.05)
    step = s.step.epoch(state.u_fac.clone(), state.i_fac.clone(),
                        state.u_bias.clone(), state.i_bias.clone(), 0.05)
    w = torch.ones(s.batch_size, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="weights"):
        step(0, w, None, None)
    # a batch past the stream: the C entry refuses it before any launch
    w = torch.ones(s.batch_size, device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        step(s.n_batches, w, None, None)
