"""The rest of the port's main-directory trainers on the card: the BPR x
TMF+Poisson hybrid's epoch, the dense-stripe BPR engine's epoch and the SVD
init, each on CUDA tensors against the same call on the CPU with the same
draws, and train_model for bpr_poisson, bpr with bpr_engine="dense" and
sgdparsvd with device="cuda". Every test here is marked ``cuda`` and skips
without a CUDA device. This file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_bpr.py
"""

import numpy as np
import pytest
import torch

from matfac_tpu_torch import Data, Params, low_rank_ratings
from matfac_tpu_torch.data.io import split_train_test_val
from matfac_tpu_torch.models.base import MFState
from matfac_tpu_torch.models.bpr import ModelBPRPoissonDropout, ModelMFBPR
from matfac_tpu_torch.ops.svd_init import svd_init
from matfac_tpu_torch.solvers.bpr import BPRSolver
from matfac_tpu_torch.solvers.bpr_dense import DenseBPRSolver
from matfac_tpu_torch.train.loop import train_model
from matfac_tpu_torch.utils import freq as ufreq

# f32 sums in another order (index_add_'s atomics on the card)
BPR_TOL = (1e-4, 1e-5)
# the JAX package's replica tolerance of the dense engine
DENSE_TOL = (2e-4, 2e-5)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card's "
                    "epochs against the CPU's")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data():
    mat, _, _ = low_rank_ratings(400, 300, k=4, density=0.08, seed=2,
                                 noise=0.1, power_law=0.6, nonneg=True)
    tr, te, va = split_train_test_val(mat, 0.1, 0.1, seed=1)
    data = Data(train_mat=tr, test_mat=te, val_mat=va)
    iu, ii = ufreq.invalid_users_items(tr, data.n_users, data.n_items)
    uf, if_ = ufreq.row_col_freq(tr)
    pad = lambda a, n: np.pad(a, (0, max(n - len(a), 0)))[:n]
    return data, iu, ii, pad(uf, data.n_users), pad(if_, data.n_items)


def _params(**kw):
    base = dict(fac_dim=16, u_reg=0.001, i_reg=0.001, learn_rate=0.1,
                seed=3, batch_size=512, max_iter=3, disp_iter=1000,
                eval_user_block=256, eval_item_block=256)
    base.update(kw)
    return Params(**base)


def _start(data, k, seed=4):
    g = torch.Generator().manual_seed(seed)
    return MFState(torch.randn(data.n_users, k, generator=g) * 0.1,
                   torch.randn(data.n_items, k, generator=g) * 0.1,
                   torch.zeros(data.n_users), torch.zeros(data.n_items),
                   torch.zeros(()))


def _on(state, dev):
    return type(state)(*(t.to(dev, copy=True) for t in state))


def _close(a, b, tol):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [True, False])
@pytest.mark.parametrize("mode", ["stream", "posneg"])
def test_hybrid_epoch_on_the_card_matches_the_cpu(mode, sample):
    """One epoch of the hybrid with the same words and, for sampled ranks,
    the same per-step masks (drawn on the CPU)."""
    dev = _cuda()
    data, iu, ii, uf, if_ = _data()
    p = _params()
    model = ModelBPRPoissonDropout(p, data.n_users, data.n_items, uf, if_,
                                   sample_poisson=sample)
    make = lambda d: BPRSolver(model, p, data.train_mat, iu, ii, mode=mode,
                               device=d)
    cpu, card = make("cpu"), make(dev)
    border, bits = cpu.draw()
    masks = None
    if sample:
        gen = torch.Generator().manual_seed(5)
        masks = []
        for t in range(cpu.n_batches):
            if mode == "posneg":
                u, pos, neg, _ = cpu.sample_posneg(bits[t])
            else:
                sl = slice(int(border[t]) * cpu.batch_size,
                           (int(border[t]) + 1) * cpu.batch_size)
                neg, _ = cpu.sample_rankgap(cpu.pos_start[sl],
                                            cpu.pos_deg[sl], bits[t, 0],
                                            bits[t, 1])
                u, pos = cpu.pos_u[sl], cpu.pos_i[sl]
            masks.append(model.triple_rank_mask(u, pos, neg, generator=gen))
    s0 = _start(data, p.fac_dim)
    sc = cpu.epoch_with(_on(s0, "cpu"), 0.1, border, bits, masks)
    sg = card.epoch_with(_on(s0, dev), 0.1, border, bits, masks)
    torch.cuda.synchronize()
    assert sg.u_fac.device.type == "cuda"
    _close(sg.u_fac, sc.u_fac, BPR_TOL)
    _close(sg.i_fac, sc.i_fac, BPR_TOL)
    assert float(card.last_loss) == pytest.approx(float(cpu.last_loss),
                                                  rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cn", [False, True])
@pytest.mark.parametrize("kw", [dict(n_negs=1), dict(n_negs=2),
                                dict(panel_q=16)])
def test_dense_epoch_on_the_card_matches_the_cpu(kw, cn):
    """Two epochs of the dense engine with the same draws: staged arrays
    equal, factors at the JAX replica tolerance."""
    dev = _cuda()
    data, iu, ii, _, _ = _data()
    p = _params()
    model = ModelMFBPR(p, data.n_users, data.n_items)
    make = lambda d: DenseBPRSolver(model, p, data.train_mat, iu, ii,
                                    bu=128, collision_norm=cn, device=d,
                                    **kw)
    cpu, card = make("cpu"), make(dev)
    for f in ("u_locs", "ipos", "wpos", "cnt_u", "cnt_i", "W_rows"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    s0 = _start(data, p.fac_dim)
    sc, sg = _on(s0, "cpu"), _on(s0, dev)
    lr = 0.5 if cn else 0.05
    for _ in range(2):
        row_of, d = cpu.draw()
        sc = cpu.epoch_with(sc, lr, row_of, d)
        sg = card.epoch_with(sg, lr, row_of, d)
    torch.cuda.synchronize()
    _close(sg.u_fac, sc.u_fac, DENSE_TOL)
    _close(sg.i_fac, sc.i_fac, DENSE_TOL)
    assert int(card.last_inversions) == pytest.approx(
        int(cpu.last_inversions), abs=2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "pure_svd", "sparsity_only"])
def test_svd_init_on_the_card_matches_the_cpu(mode):
    """The same omega on both devices: singular values at rtol 1e-4,
    vectors up to sign at atol 1e-3."""
    dev = _cuda()
    data, *_ = _data()
    kw = {"plain": {}, "pure_svd": dict(pure_svd=True),
          "sparsity_only": dict(sparsity_only=True)}[mode]
    omega = torch.randn(data.train_mat.ncols, 14,
                        generator=torch.Generator().manual_seed(1)).numpy()
    gu, gv, gs = svd_init(data.train_mat, 6, omega=omega, device=dev, **kw)
    cu, cv, cs = svd_init(data.train_mat, 6, omega=omega, device="cpu",
                          **kw)
    np.testing.assert_allclose(gs, cs, rtol=1e-4)
    if mode == "pure_svd":
        gv, cv = gv / gs[None, :], cv / cs[None, :]
    for a, b in ((gu, cu), (gv, cv)):
        np.testing.assert_allclose(np.abs((a * b).sum(0)), 1.0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,method,engine", [
    ("bpr_poisson", "train", "stream"), ("bpr_poisson", "sigmoid", "stream"),
    ("bpr", "train", "dense"), ("bpr_poisson", "train", "dense")])
def test_ranking_trainers_run_on_the_card(algo, method, engine):
    """train_model with device="cuda": the tables stay on the card, val
    HR@10 rises above the initial state's, the hybrid falls back to the
    stream engine under bpr_engine="dense"."""
    _cuda()
    data, *_ = _data()
    logs = []
    rep, model, scorer, _ = train_model(
        data, _params(max_iter=6, bpr_engine=engine), algo=algo,
        mf_method=method, device="cuda", log_fn=logs.append)
    assert rep.state.u_fac.device.type == "cuda"
    want = (DenseBPRSolver if (algo, engine) == ("bpr", "dense")
            else BPRSolver)
    assert type(rep.solver) is want
    assert (engine == "dense" and algo == "bpr_poisson") == any(
        "falling back" in s for s in logs)
    assert all(np.isfinite([h.val_rmse for h in rep.history]))
    assert rep.best_iter >= 0


@pytest.mark.cuda
def test_sgdparsvd_runs_on_the_card():
    """train_model(mf_method="sgdparsvd", device="cuda"): the SVD init on
    the card, val RMSE falls from its start."""
    _cuda()
    data, *_ = _data()
    p = Params(fac_dim=8, u_reg=0.05, i_reg=0.05, learn_rate=0.01,
               max_iter=4, seed=1, disp_iter=1000, batch_size=512)
    rep, model, ev, _ = train_model(data, p, mf_method="sgdparsvd",
                                    device="cuda", log_fn=lambda s: None)
    assert rep.state.u_fac.device.type == "cuda"
    assert rep.solver.reg_vec.device.type == "cuda"
    vals = [h.val_rmse for h in rep.history]
    assert np.isfinite(vals).all() and vals[-1] < vals[0]
