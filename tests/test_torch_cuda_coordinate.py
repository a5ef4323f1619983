"""The coordinate family of the port (matfac_tpu_torch.solvers.als and
solvers.ccd) on the card: each solver's epoch on CUDA tensors against the
same epoch on the CPU, CCD / CCD++ epochs bit-identical run to run, an
exact CCD++ resume, and the int8 Gram product. Every test here is marked
``cuda`` and skips without a CUDA device. This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_coordinate.py
"""

import numpy as np
import pytest
import torch

from matfac_tpu_torch import Data, Params, low_rank_ratings
from matfac_tpu_torch.data.io import split_train_test_val
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.models.base import ModelMF, init_state
from matfac_tpu_torch.solvers import als, ccd
from matfac_tpu_torch.utils import freq as ufreq


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card's "
                    "epochs against the CPU's")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data():
    """Power-law degrees around freq-adaptive CCD++'s threshold (75)."""
    mat, _, _ = low_rank_ratings(600, 150, k=4, density=0.25, seed=2,
                                 noise=0.05, power_law=0.5, nonneg=True)
    tr, te, va = split_train_test_val(mat, 0.1, 0.1, seed=1)
    data = Data(train_mat=tr, test_mat=te, val_mat=va)
    iu, ii = ufreq.invalid_users_items(tr, data.n_users, data.n_items)
    p = Params(fac_dim=8, u_reg=0.05, i_reg=0.05, seed=3)
    return data, p, ModelMF(p, data.n_users, data.n_items), iu, ii


SOLVERS = {
    "als": (als.ALSSolver, {}),
    "als_cg": (als.ALSSolver, dict(cg_iters=6)),
    "ialspp": (als.SubspaceALSSolver, dict(block_dim=3)),
    "dense_f32": (als.DenseALSSolver, dict(row_block=64,
                                           dense_dtype=torch.float32)),
    "dense_bf16": (als.DenseALSSolver, dict(row_block=64,
                                            dense_dtype=torch.bfloat16)),
    "dense_int8": (als.DenseALSSolver, dict(row_block=64, cg_iters=6,
                                            gram_int8=True)),
    "ccdpp": (ccd.CCDPPSolver, {}),
    "ccdpp_g4": (ccd.CCDPPSolver, dict(group_dims=4)),
    "ccdpp_freqadap": (ccd.CCDPPSolver, dict(freq_adaptive=True)),
    "ccd": (ccd.CCDSolver, {}),
}


def _pair(name, dev):
    data, p, model, iu, ii = _data()
    cls, kw = SOLVERS[name]
    make = lambda d: cls(model, p, data.train_mat, iu, ii, device=d, **kw)
    return make("cpu"), make(dev), init_state(p, data.n_users,
                                              data.n_items, device="cpu")


def _same_objective(cpu, want, got):
    """CG's sixth iterate at fac_dim 8 is not converged, and where a Gram is
    near-singular it moves along the flat directions by up to 0.22 when the
    Gram is perturbed by 1e-7 relative (measured on the CPU with this
    data): card and CPU are held by the train objective of their epochs,
    which moved by 2.2e-4 relative under that perturbation, at rtol
    1e-3."""
    data, p, model, iu, ii = _data()
    ev = Evaluator(data, iu, ii, p, "cpu")
    obj = lambda st: ev.objective(model.eval_view(st), st)
    assert np.isfinite(obj(got))
    np.testing.assert_allclose(obj(got), obj(want), rtol=1e-3)


def _epoch(solver, state, draws):
    if draws is None:
        return solver.epoch(state, 0.0)
    return solver.epoch_with(state, 0.0, draws)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SOLVERS))
def test_epoch_on_the_card_matches_the_cpu(name):
    """Two epochs with the same draws, on the card and on the CPU, at the
    CPU parity tests' multi-epoch class, rtol / atol 2e-3 (cuSOLVER's
    Cholesky, cuBLAS's products and the g-wide row sums add in another
    order than the CPU's, and at fac_dim 8 on rank-4 data the systems
    amplify that), the bf16 dense Grams at their 5e-3 class, and the CG
    solvers by their objective (``_same_objective``). CCD carries its
    residual, so its two runs go on from their own epochs; ALS has no
    state but the tables, and each epoch starts the card from the CPU's
    tables."""
    dev = _cuda()
    cpu, card, s0 = _pair(name, dev)
    if name == "ccdpp_freqadap":   # 97 of 150 items at the threshold 75
        assert 0 < int(card.item_dim_ok.sum()) < card.n_items
    sc, sg = s0, type(s0)(*(t.to(dev) for t in s0))
    tol = (5e-3, 5e-3) if name == "dense_bf16" else (2e-3, 2e-3)
    for _ in range(2):
        if not isinstance(cpu, ccd.CCDPPSolver):
            sg = type(sc)(*(t.to(dev) for t in sc))
        draws = cpu.draw() if hasattr(cpu, "draw") else None
        sc, sg = _epoch(cpu, sc, draws), _epoch(card, sg, draws)
        torch.cuda.synchronize()
        assert sg.u_fac.device.type == "cuda"
        if getattr(cpu, "cg_iters", 0):
            _same_objective(cpu, sc, type(sg)(*(t.cpu() for t in sg)))
            continue
        for a, b in ((sg.u_fac, sc.u_fac), (sg.i_fac, sc.i_fac)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=tol[0], atol=tol[1])
    if isinstance(cpu, ccd.CCDPPSolver):
        np.testing.assert_allclose(card.res.cpu().numpy(), cpu.res.numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ccdpp", "ccdpp_g4", "ccdpp_freqadap",
                                  "ccd"])
def test_ccd_epochs_are_bit_identical_on_the_card(name):
    """The segment sums are contiguous reductions with no atomics: two runs
    of an epoch from one state, residual and draws give the same bits."""
    dev = _cuda()
    _, card, s0 = _pair(name, dev)
    s0 = type(s0)(*(t.to(dev) for t in s0))
    card.epoch(s0, 0.0)                       # past the first-epoch init
    res0 = card.res.clone()
    draws = card.draw()
    outs = []
    for _ in range(2):
        card.res = res0.clone()
        st = card.epoch_with(s0, 0.0, draws)
        outs.append((st.u_fac, st.i_fac, card.res))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.cuda
def test_ccdpp_resume_is_bit_exact_on_the_card(tmp_path):
    """train_model(mf_method="ccd++", device="cuda") stopped at epoch 2 and
    resumed to 4 equals the uninterrupted run bit for bit."""
    from matfac_tpu_torch.train.loop import train_model
    _cuda()
    data, p, *_ = _data()
    p = p.replace(max_iter=4, disp_iter=1000, save_iter=1, ccd_group_dims=2)
    run = lambda prefix, params, resume: train_model(
        data, params, mf_method="ccd++", device="cuda",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=2), False)
    res = run("part", p, True)
    assert all(torch.equal(a, b) for a, b in zip(full.state, res.state))
    assert torch.equal(full.solver.res, res.solver.res)


@pytest.mark.cuda
def test_gram_int8_takes_the_int8_product_on_the_card(monkeypatch):
    """gram_int8 runs each row block's Gram through torch._int_mm on the
    card (one call a block, both sweeps), and a shape it refuses raises: no
    switch to another product."""
    dev = _cuda()
    _, card, s0 = _pair("dense_int8", dev)
    calls = []
    orig = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm",
                        lambda a, b: calls.append(a.shape) or orig(a, b))
    card.epoch(type(s0)(*(t.to(dev) for t in s0)), 0.0)
    n_blocks = (card.nu_pad + card.ni_pad) // card.row_block
    assert len(calls) == n_blocks
    with pytest.raises(RuntimeError):
        als.dense_als_sweep(torch.zeros(16, 8, device=dev),
                            torch.ones(16, 8, device=dev),
                            torch.ones(16, 16, device=dev), 0.1, 16,
                            cg_iters=2, gram_int8=True,
                            mask8=torch.ones(16, 16, dtype=torch.int8,
                                             device=dev))


@pytest.mark.cuda
def test_bucketed_als_epoch_makes_no_card_sync():
    """One bucketed ALS epoch (exact solves) on the card under a recording
    profiler, with ``set_sync_debug_mode("error")``: neither the sweep nor
    its spans and counters wait for the card. Item 0 is rated by every
    user, so its bucket is the widest (a saturated item). The first epoch
    runs before the mode is set, so that cuBLAS and cuSOLVER are set up
    outside the checked one."""
    from torch.profiler import ProfilerActivity, profile

    from matfac_tpu_torch.data.csr import RatingMatrix
    from matfac_tpu_torch.train import profiler as tprof
    dev = _cuda()
    rng = np.random.default_rng(4)
    nu, ni, k = 600, 150, 8
    dense = rng.random((nu, ni)) < 0.2
    dense[:, 0] = True
    r, c = np.nonzero(dense)
    vals = rng.integers(1, 11, r.size).astype(np.float32) * 0.5
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=nu))])
    mat = RatingMatrix(indptr, c.astype(np.int32), vals, ni)
    p = Params(fac_dim=k, u_reg=0.05, i_reg=0.05, seed=3)
    model = ModelMF(p, nu, ni)
    none = np.zeros(nu, bool), np.zeros(ni, bool)
    solver = als.ALSSolver(model, p, mat, *none, device=dev)
    assert solver.i_buckets[-1].row_ids[0] == 0 and \
        solver.i_buckets[-1].cap >= nu
    state = init_state(p, nu, ni, device=dev)
    state = solver.epoch(state, 0.0)
    torch.cuda.synchronize()
    tprof.reset()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = solver.epoch(state, 0.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        prof.stop()
    assert bool(torch.isfinite(state.u_fac).all())
    rec = tprof.records()
    tprof.reset()
    assert [s.name for s in rec["spans"]].count("als.epoch") == 1
    buckets = solver.u_buckets + solver.i_buckets
    assert rec["counts"]["als.slots"] == sum(b.mask.size for b in buckets)
    assert rec["counts"]["als.ratings"] == 2 * r.size
