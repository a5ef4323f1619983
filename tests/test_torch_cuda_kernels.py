"""The hand-written CUDA kernels (matfac_tpu_torch/csrc/dense_rows.cu,
csrc/topk.cu and csrc/block_sgd.cu) against their plain PyTorch versions, on
the card. Every test here is marked
``cuda`` and skips without a CUDA device. This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from matfac_tpu_torch.ops import block_sgd_kernel as tbsk
from matfac_tpu_torch.ops import dense_block_kernel as tdbk
from matfac_tpu_torch.ops import dense_row_kernel as tdrk
from matfac_tpu_torch.ops import sgd_kernel as tsk
from matfac_tpu_torch.ops import topk_kernel as ttk
from matfac_tpu_torch.solvers.block_sgd import stage_batch_collision_counts

LR, U_REG, I_REG = 0.05, 0.01, 0.02


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


MODES = ["f32+W", "bf16+W", "codes", "f32+fW", "bf16+bfW"]


def _tiles(mode, rng, shape, dev, density=0.1):
    """(R, W, r_scale) on the card: f32 / bf16 ratings with int8 validity
    ("+W") or float weights in [0.5, 2) of the rating's type ("+fW",
    "+bfW": IFWMF's tiles), or int8 half-star codes."""
    valid = rng.random(shape) < density
    if mode == "codes":
        codes = np.where(valid, rng.integers(1, 11, shape), 0)
        return torch.from_numpy(codes.astype(np.int8)).to(dev), None, 0.5
    R = torch.from_numpy(np.where(valid, rng.normal(3.0, 1.0, shape), 0.0)
                         .astype(np.float32))
    if mode.endswith("+W"):
        W = torch.from_numpy(valid.astype(np.int8))
    else:
        W = torch.from_numpy(np.where(valid, rng.uniform(0.5, 2.0, shape),
                                      0.0).astype(np.float32))
    if mode.startswith("bf16"):
        R = R.to(torch.bfloat16)
        W = W.to(torch.bfloat16) if mode == "bf16+bfW" else W
    return R.to(dev), W.to(dev), None


@pytest.mark.cuda
@pytest.mark.parametrize("collision_norm", [True, False])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain(mode, mm_bf16, collision_norm):
    """One epoch at a ragged shape (catalog not a multiple of either
    kernel's item panel, stripe not a multiple of its user chunk; the
    int8 rows are not whole 16-byte pieces), rtol 1e-3 /
    atol 1e-5: summation order over bu and over panels. At mm_bf16 the
    factors are small enough that a bf16 flip of E, which one ulp of P
    decides, moves a factor by less than atol; without collision
    normalization the step takes lr / 20, ~the per-user count."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    NU, bu, ni, k = 4, 100, 200, 64
    R, W, r_scale = _tiles(mode, rng, (NU, bu, ni), dev)
    scale = 0.03 if mm_bf16 else 0.3
    u3 = torch.from_numpy(scale * rng.normal(size=(NU, bu, k))).float()
    i_tab = torch.from_numpy(scale * rng.normal(size=(ni, k))).float()
    u3, i_tab = u3.to(dev), i_tab.to(dev)
    order = torch.from_numpy(rng.permutation(NU))
    lr = LR if collision_norm else LR / 20
    before = tdrk.dense_rows_epoch.launches
    uk, ik = tdrk.dense_rows_epoch(u3.clone(), i_tab.clone(), order, lr, R,
                                   W, r_scale, U_REG, I_REG, collision_norm,
                                   mm_bf16)
    assert tdrk.dense_rows_epoch.launches - before == \
        tdrk.epoch_launches(NU, k, mm_bf16)
    up, ip = tdbk.dense_sweep_rows(u3.clone(), i_tab.clone(), order, lr, R,
                                   W, U_REG, I_REG, collision_norm, mm_bf16,
                                   r_scale=r_scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(uk, up, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(ik, ip, rtol=1e-3, atol=1e-5)


def _dyadic(rng, shape):
    """+-(m + d) / 256, m in [65, 127], |d| < 1/4: bf16 rounds each value
    to exactly +-m / 256, so the products of the rounded operands, and P,
    are exact in f32 in any summation order."""
    m = rng.integers(65, 128, shape) + rng.uniform(-0.25, 0.25, shape)
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    return torch.from_numpy(sign * m / 256.0).float()


@pytest.mark.cuda
@pytest.mark.parametrize("collision_norm", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_bf16_rounding_exact(mode, collision_norm):
    """One stripe whose bf16 rounding is exact: no rounding of E can flip
    between summation orders, so the kernel matches the plain version in
    its own matmul precision at rtol 1e-5 / atol 1e-6, and misses the
    plain version in the other precision at the same tolerance (the
    control that shows mm_bf16's rounding is what is checked)."""
    dev = _cuda()
    rng = np.random.default_rng(11)
    bu, ni, k = 100, 200, 64
    R, W, r_scale = _tiles(mode, rng, (1, bu, ni), dev)
    u3 = _dyadic(rng, (1, bu, k)).to(dev)
    i_tab = _dyadic(rng, (ni, k)).to(dev)
    order = torch.zeros(1, dtype=torch.int64)
    lr = LR if collision_norm else LR / 10
    kern, plain = {}, {}
    for mm in (True, False):
        kern[mm] = tdrk.dense_rows_epoch(u3.clone(), i_tab.clone(), order,
                                         lr, R, W, r_scale, U_REG, I_REG,
                                         collision_norm, mm)
        plain[mm] = tdbk.dense_sweep_rows(u3.clone(), i_tab.clone(), order,
                                          lr, R, W, U_REG, I_REG,
                                          collision_norm, mm,
                                          r_scale=r_scale)
    torch.cuda.synchronize()
    for mm in (True, False):
        for got, want, ctl in zip(kern[mm], plain[mm], plain[not mm]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            assert not torch.allclose(got, ctl, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 33, 128, 160])
@pytest.mark.parametrize("ni", [200, 1024])
@pytest.mark.parametrize("mode", ["codes", "bf16+W", "f32+fW"])
def test_kernel_padding_and_edges(mode, ni, k):
    """k padded to the tensor cores' 16-deep steps (10, 33; 128 fills
    them; 160 takes the CUDA-core kernel), stripes of 130 users (two full
    64-user chunks and a ragged third), catalogs of 200 items (a ragged
    128-item panel; int8 rows not whole 16-byte pieces: element loads) and
    1024 (whole panels, 16-byte copies); three stripes, rtol 1e-3 /
    atol 1e-5 at mm_bf16's scale."""
    dev = _cuda()
    rng = np.random.default_rng(13)
    NU, bu = 3, 130
    R, W, r_scale = _tiles(mode, rng, (NU, bu, ni), dev)
    u3 = torch.from_numpy(0.03 * rng.normal(size=(NU, bu, k))).float().to(dev)
    i_tab = torch.from_numpy(0.03 * rng.normal(size=(ni, k))).float().to(dev)
    order = torch.from_numpy(rng.permutation(NU))
    assert tdrk.epoch_launches(NU, k, True) == \
        NU * tdrk.KERNELS_PER_STRIPE + (k <= 128)   # + the bf16 copy of U
    got = tdrk.dense_rows_epoch(u3.clone(), i_tab.clone(), order, LR, R, W,
                                r_scale, U_REG, I_REG, True, True)
    want = tdbk.dense_sweep_rows(u3.clone(), i_tab.clone(), order, LR, R, W,
                                 U_REG, I_REG, True, True, r_scale=r_scale)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["f64_weights", "codes_with_weights"])
def test_kernel_rejects_what_it_cannot_take(bad):
    dev = _cuda()
    u3 = torch.zeros((2, 8, 4), device=dev)
    i_tab = torch.zeros((16, 4), device=dev)
    R = torch.zeros((2, 8, 16), device=dev)
    W = R.double()
    if bad == "codes_with_weights":
        R, W = R.to(torch.int8), R.clone()
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        tdrk.dense_rows_epoch(u3, i_tab, torch.arange(2), LR, R, W, 0.5,
                              U_REG, I_REG, True, False)


def _topk_inputs(rng, n_users, n_items, k, exact, dev):
    """topk_catalog's inputs: ~10% invalid items, ~5% rated, user 0 rates
    all but 5 items, user 1 every item; exact=True: scores exact in f32
    (factors m/128, biases and mu multiples of 1/64) and every other item
    a copy of its neighbour: exact ties."""
    if exact:
        u = rng.integers(-127, 128, (n_users, k)) / 128.0
        i = rng.integers(-127, 128, (n_items, k)) / 128.0
        ub = rng.integers(-64, 65, n_users) / 64.0
        ib = rng.integers(-64, 65, n_items) / 64.0
        i[1::2], ib[1::2] = i[0:n_items - 1:2], ib[0:n_items - 1:2]
    else:
        u, i = rng.normal(0, 0.3, (n_users, k)), rng.normal(0, 0.3,
                                                            (n_items, k))
        ub, ib = rng.normal(0, 0.1, n_users), rng.normal(0, 0.1, n_items)
    rated = rng.random((n_users, n_items)) < 0.05
    rated[0] = True
    rated[0, rng.choice(n_items, 5, replace=False)] = False
    rated[1] = True
    r, c = np.nonzero(rated)
    indptr = np.concatenate([[0], np.cumsum(rated.sum(1))])
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                                 device=dev)
    return dict(u_fac=f32(u), i_fac=f32(i), u_bias=f32(ub), i_bias=f32(ib),
                mu=f32(0.25),
                invalid=torch.from_numpy(rng.random(n_items) < 0.1).to(dev),
                indptr=torch.from_numpy(indptr.astype(np.int64)).to(dev),
                indices=torch.from_numpy(c.astype(np.int32)).to(dev),
                users=torch.from_numpy(rng.permutation(n_users)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("n", [1, 10, 100, 1000])
@pytest.mark.parametrize("k", [32, 64, 128])
def test_topk_kernel_matches_plain(k, n, exact):
    """A ragged catalog (1201 items), users with fewer scorable items than
    n and none at all. Scores at rtol 1e-5 / atol 1e-6 (f32 dot products
    in another order; exact cases equal), ids equal where no neighbour is
    within that (exact cases: everywhere, the smaller id first on ties)."""
    dev = _cuda()
    args = _topk_inputs(np.random.default_rng(k + n), 200, 1201, k, exact,
                        dev)
    before = ttk.topk_catalog.launches
    gs, gi = ttk.topk_catalog(**args, n=n)
    assert ttk.topk_catalog.launches - before == ttk.KERNELS_PER_CHUNK
    ws, wi = ttk.topk_plain(**args, n=n)
    torch.cuda.synchronize()
    gs, gi, ws, wi = gs.cpu(), gi.cpu(), ws.cpu(), wi.cpu()
    if exact:
        assert torch.equal(gs, ws) and torch.equal(gi, wi)
        if n > 1:   # the ties are there, and the smaller id leads
            tie = (gs[:, 1:] == gs[:, :-1]) & (gi[:, 1:] >= 0)
            assert bool(tie.any())
            assert bool((gi[:, :-1][tie] < gi[:, 1:][tie]).all())
        return
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-6)
    tol = 2 * (1e-6 + 1e-5 * ws.abs())
    inf = torch.full((ws.shape[0], 1), float("inf"))
    gap = ws[:, :-1] - ws[:, 1:]
    held = ((torch.cat([inf, gap], 1) > tol) & (torch.cat([gap, inf], 1)
                                                > tol)) | (wi == -1)
    assert torch.equal(gi[held], wi[held])
    row1 = (args["users"] == 1).nonzero().item()
    assert (gi[row1] == -1).all()   # user 1 rated every item


@pytest.mark.cuda
def test_topk_kernel_rejects_what_it_cannot_take():
    dev = _cuda()
    args = _topk_inputs(np.random.default_rng(0), 8, 50, 4, False, dev)
    with pytest.raises(ValueError, match="n <= 4096"):
        ttk.topk_catalog(**args, n=5000)
    with pytest.raises(ValueError, match="float32"):
        ttk.topk_catalog(**dict(args, u_fac=args["u_fac"].double()), n=3)


# ----------------------------------------------------------------------
# the one-hot cell kernel (csrc/block_sgd.cu)
# ----------------------------------------------------------------------

# (bu, bi, k): the deltas fit shared memory, or go to the global scratch
BLOCK_ROUTES = {"smem": (64, 48, 64), "scratch": (256, 256, 128)}


def _cell_streams(rng, n_rows, S, bs, bu, bi, k, weights, dummy=False):
    """Streams [n_rows (+ 1 all-invalid dummy row), S] as the solver stages
    them: ~80% valid slots, padding slots w = 0, ids 0, lam 1; ids from 8
    rows, so they repeat within every batch; weights 0/1 or float in
    [0.2, 1) on the valid slots (IFWMF-like); collision counts of each
    static batch slice."""
    valid = rng.random((n_rows, S)) < 0.8
    if dummy:
        valid = np.concatenate([valid, np.zeros((1, S), bool)])
    shape = valid.shape
    u = np.where(valid, rng.integers(0, min(8, bu), shape), 0)
    i = np.where(valid, rng.integers(0, min(8, bi), shape), 0)
    r = np.where(valid, rng.normal(3.0, 1.0, shape), 0.0)
    w = valid * (1.0 if weights == "01" else rng.uniform(0.2, 1.0, shape))
    lam = np.where(valid, rng.integers(1, k + 1, shape), 1)
    u, i, lam = (a.astype(np.int32) for a in (u, i, lam))
    r, w = r.astype(np.float32), w.astype(np.float32)
    cnu = stage_batch_collision_counts(w, u, bs, bu)
    cni = stage_batch_collision_counts(w, i, bs, bi)
    return [torch.from_numpy(a) for a in (u, i, r, w, cnu, cni, lam)]


def _block_kw(bs, bu, bi, NI, collision_norm, use_mask, mm_bf16):
    return dict(bs=bs, bu=bu, bi=bi, NI=NI, u_reg=U_REG, i_reg=I_REG,
                collision_norm=collision_norm, use_mask=use_mask,
                mm_bf16=mm_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["smem", "scratch"])
@pytest.mark.parametrize("weights", ["01", "float"])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
def test_block_row_kernel_matches_plain(collision_norm, use_mask, weights,
                                        route):
    """The row schedule (one launch per user-block row, one CTA walking the
    row's cells) at f32, 3 rows x 2 cells x 3 steps from random batch
    offsets, ids repeating within every batch: rtol 1e-5 / atol 1e-6, the
    class the JAX package pins between its two engines (summation order
    only). Without collision normalization a row's step is the sum of ~8
    repeats, so the step takes lr / 8."""
    dev = _cuda()
    bu, bi, k = BLOCK_ROUTES[route]
    assert (tbsk.library().block_sgd_scratch_floats(1, bu, bi, k) > 0) == \
        (route == "scratch")
    rng = np.random.default_rng(21)
    NU, NI, bs, n_steps = 3, 2, 64, 3
    S = bs * n_steps
    streams = [x.reshape(NU, NI * S).to(dev) for x in _cell_streams(
        rng, NU * NI, S, bs, bu, bi, k, weights)]
    u_tab = torch.from_numpy(0.3 * rng.normal(size=(NU * bu, k))).float()
    i_tab = torch.from_numpy(0.3 * rng.normal(size=(NI * bi, k))).float()
    u_tab, i_tab = u_tab.to(dev), i_tab.to(dev)
    sched = (rng.permutation(NU),
             np.stack([rng.permutation(NI) for _ in range(NU)]),
             rng.integers(0, n_steps, (NU, NI)))
    assert sched[2].any()
    lr = LR if collision_norm else LR / 8
    kw = _block_kw(bs, bu, bi, NI, collision_norm, use_mask, False)
    before = tbsk.block_sgd_epoch.launches
    got = tbsk.block_sgd_epoch(u_tab.clone(), i_tab.clone(), *sched, lr,
                               *streams, **kw)
    assert tbsk.block_sgd_epoch.launches - before == NU
    want = tbsk.block_sweep_rows(u_tab.clone(), i_tab.clone(), *sched, lr,
                                 *streams, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["smem", "scratch"])
@pytest.mark.parametrize("weights", ["01", "float"])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
def test_block_diag_kernel_matches_plain(collision_norm, use_mask, weights,
                                         route):
    """The diag schedule (one launch per round, one CTA per real lane) at
    f32: 5 user blocks x 3 item blocks in 6 rounds of 3 lanes, one of them
    a dummy lane; 2 steps per cell from random batch offsets. Tolerance as
    for the row schedule."""
    dev = _cuda()
    bu, bi, k = BLOCK_ROUTES[route]
    rng = np.random.default_rng(22)
    NU, NI, bs, n_steps = 5, 3, 64, 2
    S = bs * n_steps
    streams = [x.to(dev) for x in _cell_streams(
        rng, NU * NI, S, bs, bu, bi, k, weights, dummy=True)]
    u_tab = torch.from_numpy(0.3 * rng.normal(size=(NU * bu, k))).float()
    i_tab = torch.from_numpy(0.3 * rng.normal(size=(NI * bi, k))).float()
    u_tab, i_tab = u_tab.to(dev), i_tab.to(dev)
    sched = tbsk.diag_schedule(torch.Generator().manual_seed(4), NU, NI,
                               n_steps)
    assert bool((sched[0] == NU).any()) and bool(sched[2].any())
    lr = LR if collision_norm else LR / 8
    kw = _block_kw(bs, bu, bi, NI, collision_norm, use_mask, False)
    before = tbsk.block_sgd_diag_epoch.launches
    got = tbsk.block_sgd_diag_epoch(u_tab.clone(), i_tab.clone(), *sched,
                                    lr, *streams, **kw)
    assert tbsk.block_sgd_diag_epoch.launches - before == sched[0].shape[0]
    want = tbsk.block_sweep_diag(u_tab.clone(), i_tab.clone(), *sched, lr,
                                 *streams, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_weights", [(False, "01"), (True, "float")])
@pytest.mark.parametrize("collision_norm", [True, False])
@pytest.mark.parametrize("schedule", ["row", "diag"])
def test_block_kernel_bf16_rounding_exact(schedule, collision_norm,
                                          mask_weights):
    """One step per factor block from factors whose bf16 rounding is exact
    (_dyadic): the predictions are exact in any summation order, so no
    rounding can flip, and the kernel matches the plain version in its own
    precision at rtol 1e-5 / atol 1e-6 and misses the plain version in the
    other precision (the control that shows mm_bf16's rounding points are
    what is checked). Row: one row of one cell; diag: one round of 4
    lanes."""
    dev = _cuda()
    use_mask, weights = mask_weights
    rng = np.random.default_rng(23)
    bu, bi, k, bs = 64, 48, 64, 128
    NU = NI = 1 if schedule == "row" else 4
    streams = [x.to(dev) for x in _cell_streams(
        rng, NU * NI, bs, bs, bu, bi, k, weights, dummy=schedule == "diag")]
    u_tab = _dyadic(rng, (NU * bu, k)).to(dev)
    i_tab = _dyadic(rng, (NI * bi, k)).to(dev)
    if schedule == "row":
        sched, fn, plain = ((np.zeros(1), np.zeros((1, 1)),
                             np.zeros((1, 1))),
                            tbsk.block_sgd_epoch, tbsk.block_sweep_rows)
    else:
        sched, fn, plain = ((rng.permutation(NU)[None], np.arange(NI)[None],
                             np.zeros((1, NI))),
                            tbsk.block_sgd_diag_epoch, tbsk.block_sweep_diag)
    lr = LR if collision_norm else LR / 8
    kern, ref = {}, {}
    for mm in (True, False):
        kw = _block_kw(bs, bu, bi, NI, collision_norm, use_mask, mm)
        kern[mm] = fn(u_tab.clone(), i_tab.clone(), *sched, lr, *streams,
                      **kw)
        ref[mm] = plain(u_tab.clone(), i_tab.clone(), *sched, lr, *streams,
                        **kw)
    torch.cuda.synchronize()
    for mm in (True, False):
        for got, want, ctl in zip(kern[mm], ref[mm], ref[not mm]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            assert not torch.allclose(got, ctl, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(32, 24, 8, 64, 16), (8, 8, 32, 96, 32),
                                  (384, 384, 64, 2048, 1024)])
def test_fused_cell_update_kernel_matches_plain(case):
    """fused_cell_update's one-lane launch against its plain version (the
    Pallas body's index_add_ per term) on the cases of the JAX package's
    interpret-mode test and two more, atol 1e-5 as there."""
    dev = _cuda()
    BU, BI, k, S, bs = case
    rng = np.random.default_rng(S)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    args = (f32(0.1 * rng.standard_normal((BU, k))),
            f32(0.1 * rng.standard_normal((BI, k))),
            i32(rng.integers(0, BU, S)), i32(rng.integers(0, BI, S)),
            f32(rng.standard_normal(S)), f32(rng.random(S) > 0.2))
    before = tsk.fused_cell_update.launches
    got = tsk.fused_cell_update(*args, 0.05, bs, 0.01, 0.02)
    assert tsk.fused_cell_update.launches - before == 1
    want = tsk.fused_cell_plain(*args, 0.05, bs, 0.01, 0.02)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0.0, atol=1e-5)
    assert not torch.equal(got[0], args[0])   # the inputs are not updated


@pytest.mark.cuda
def test_block_kernel_rejects_what_it_cannot_take():
    dev = _cuda()
    rng = np.random.default_rng(0)
    streams = [x.to(dev) for x in _cell_streams(rng, 4, 64, 64, 16, 16, 8,
                                                "01", dummy=True)]
    u_tab = torch.zeros((32, 8), device=dev)
    i_tab = torch.zeros((16, 8), device=dev)
    sched = tbsk.diag_schedule(torch.Generator().manual_seed(0), 2, 1, 1)
    kw = _block_kw(64, 16, 16, 1, True, False, True)
    bad = [s.clone() for s in streams]
    bad[0][0, 0] = 16
    with pytest.raises(ValueError, match="outside"):
        tbsk.block_sgd_diag_epoch(u_tab, i_tab, *sched, LR, *bad, **kw)
    with pytest.raises(ValueError, match="float32"):
        tbsk.block_sgd_diag_epoch(u_tab.double(), i_tab, *sched, LR,
                                  *streams, **kw)
    with pytest.raises(ValueError, match="share a block"):
        tbsk.block_sgd_diag_epoch(u_tab, i_tab, np.zeros((1, 2)),
                                  np.zeros((1, 2)), np.zeros((1, 2)), LR,
                                  *streams, **dict(kw, NI=2))
