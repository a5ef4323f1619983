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


def _stripe_epoch(args, mm_bf16, lr=LR, collision_norm=True):
    u3, i_tab, order, R, W, r_scale = args
    return tdrk.dense_rows_epoch(u3.clone(), i_tab.clone(), order, lr, R, W,
                                 r_scale, U_REG, I_REG, collision_norm,
                                 mm_bf16)


def _stripe_args(mode, rng, dev, NU=4, bu=300, ni=1000, k=64, scale=0.1):
    R, W, r_scale = _tiles(mode, rng, (NU, bu, ni), dev)
    u3 = torch.from_numpy(scale * rng.normal(size=(NU, bu, k))).float()
    i_tab = torch.from_numpy(scale * rng.normal(size=(ni, k))).float()
    return (u3.to(dev), i_tab.to(dev), torch.from_numpy(rng.permutation(NU)),
            R, W, r_scale)


@pytest.mark.cuda
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_stripe_epoch_is_deterministic(mode, mm_bf16):
    """The gradient partials are summed in fixed point: one epoch run twice
    gives bit-identical factors, for every tile kind and both routes."""
    dev = _cuda()
    args = _stripe_args(mode, np.random.default_rng(31), dev)
    a = _stripe_epoch(args, mm_bf16)
    b = _stripe_epoch(args, mm_bf16)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("rtype", [torch.float32, torch.bfloat16])
def test_stripe_codes_equal_float_tiles_bitwise(rtype, mm_bf16):
    """Half-star ratings: int8 codes with r_scale 0.5 and float tiles of
    code * 0.5 with int8 validity give bit-identical factors (the JAX
    package pins the same, tests/test_dense_block.py:355), on both routes
    and at k = 64 (2 CTAs an SM) and 128 (1)."""
    dev = _cuda()
    rng = np.random.default_rng(32)
    for k in (64, 128):
        codes, _, _ = _tiles("codes", rng, (3, 260, 1200), dev)
        u3 = torch.from_numpy(0.1 * rng.normal(size=(3, 260, k))).float()
        i_tab = torch.from_numpy(0.1 * rng.normal(size=(1200, k))).float()
        order = torch.from_numpy(rng.permutation(3))
        base = (u3.to(dev), i_tab.to(dev), order)
        R = (codes.float() * 0.5).to(rtype)
        W = (codes != 0).to(torch.int8)
        got = _stripe_epoch((*base, codes, None, 0.5), mm_bf16)
        want = _stripe_epoch((*base, R, W, None), mm_bf16)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_densesgd_resume_is_bit_exact_on_the_card(tmp_path):
    """densesgd stopped after 3 epochs and resumed to 5 equals the
    uninterrupted 5-epoch run, bit for bit."""
    from matfac_tpu_torch import (Data, Params, low_rank_ratings,
                                  split_train_test_val)
    from matfac_tpu_torch.train.loop import train_model
    _cuda()
    mat, _, _ = low_rank_ratings(600, 500, k=4, density=0.1, seed=2,
                                 noise=0.1, nonneg=True)
    tr, te, va = split_train_test_val(mat, 0.1, 0.1, seed=1)
    data = Data(train_mat=tr, test_mat=te, val_mat=va)
    p = Params(fac_dim=16, u_reg=0.01, i_reg=0.01, learn_rate=0.05,
               max_iter=5, seed=1, disp_iter=1000, save_iter=1)
    run = lambda prefix, params, resume: train_model(
        data, params, mf_method="densesgd", device="cuda",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    run("part", p.replace(max_iter=3), False)
    res = run("part", p, True)
    assert torch.equal(full.state.u_fac, res.state.u_fac)
    assert torch.equal(full.state.i_fac, res.state.i_fac)


@pytest.mark.cuda
@pytest.mark.parametrize("mm_bf16", [False, True])
def test_stripe_range_guard_goes_non_finite(mm_bf16):
    """A diverging learn rate: a gradient partial outside the fixed-point
    range poisons its sum and the factors go non-finite, as the plain
    version's f32 sums overflow; no sum wraps into a finite value."""
    dev = _cuda()
    args = _stripe_args("f32+W", np.random.default_rng(33), dev, scale=1.0)
    u3, i_tab, order, R, W, _ = args
    k_state, p_state = (u3, i_tab), (u3, i_tab)
    for _ in range(6):
        k_state = tdrk.dense_rows_epoch(k_state[0].clone(), k_state[1].clone(),
                                        order, 10.0, R, W, None, U_REG, I_REG,
                                        False, mm_bf16)
        p_state = tdbk.dense_sweep_rows(p_state[0].clone(), p_state[1].clone(),
                                        order, 10.0, R, W, U_REG, I_REG, False,
                                        mm_bf16)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(p_state[1]).all())
    assert not bool(torch.isfinite(k_state[1]).all())


# the tile kinds the rank masks are instantiated for (0/1 weights)
MASK_MODES = ["codes", "f32+W", "bf16+W"]


def _ranks(rng, NU, bu, ni, k, kind, dev, full=False):
    """(Lu [NU, bu], Li [ni], Q [NU, k]) int32 on the card: random lambdas
    in [1, k] (all k when ``full``), with the identity rank rows (TMF's
    static ranks) or one Poisson CRN quantile row per visit."""
    lo = k if full else 1
    Lu = torch.from_numpy(rng.integers(lo, k + 1, (NU, bu)).astype(np.int32))
    Li = torch.from_numpy(rng.integers(lo, k + 1, ni).astype(np.int32))
    if kind == "static":
        Q = tdbk.identity_quantiles(NU, k)
    else:
        from matfac_tpu_torch.models.longtail import poisson_cdf_table
        Q = tdbk.visit_quantiles(torch.from_numpy(poisson_cdf_table(k)),
                                 torch.from_numpy(rng.random(NU)
                                                  .astype(np.float32)))
    return Lu.to(dev), Li.to(dev), Q.to(dev)


def _masked_pair(args, ranks, mm_bf16, lr=LR, collision_norm=True):
    """(kernel, plain) epochs of the same masked inputs."""
    u3, i_tab, order, R, W, r_scale = args
    got = tdrk.dense_rows_epoch(u3.clone(), i_tab.clone(), order, lr, R, W,
                                r_scale, U_REG, I_REG, collision_norm,
                                mm_bf16, ranks=ranks)
    Lu, Li, Q = ranks
    want = tdbk.dense_sweep_rows(u3.clone(), i_tab.clone(), order, lr, R, W,
                                 U_REG, I_REG, collision_norm, mm_bf16,
                                 r_scale=r_scale, Lu3=Lu, Li=Li, Q=Q)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["static", "poisson"])
@pytest.mark.parametrize("collision_norm", [True, False])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("mode", MASK_MODES)
def test_masked_kernel_matches_plain(mode, mm_bf16, collision_norm, kind):
    """Rank masks (TMF's static ranks, TMF+Dropout's quantile rows per
    visit) through the kernel and the plain version: one epoch at the
    ragged shape of test_kernel_matches_plain, rtol 1e-3 / atol 1e-5."""
    dev = _cuda()
    rng = np.random.default_rng(41)
    NU, bu, ni, k = 4, 100, 200, 64
    R, W, r_scale = _tiles(mode, rng, (NU, bu, ni), dev)
    scale = 0.03 if mm_bf16 else 0.3
    u3 = torch.from_numpy(scale * rng.normal(size=(NU, bu, k))).float()
    i_tab = torch.from_numpy(scale * rng.normal(size=(ni, k))).float()
    args = (u3.to(dev), i_tab.to(dev), torch.from_numpy(rng.permutation(NU)),
            R, W, r_scale)
    ranks = _ranks(rng, NU, bu, ni, k, kind, dev)
    before = tdrk.dense_rows_epoch.launches
    got, want = _masked_pair(args, ranks, mm_bf16,
                             LR if collision_norm else LR / 20,
                             collision_norm)
    assert tdrk.dense_rows_epoch.launches - before == \
        tdrk.epoch_launches(NU, k, mm_bf16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-5)
    # the masks bite: dims at or past an item's rank keep their values
    assert not torch.equal(want[1], tdbk.dense_sweep_rows(
        *(a.clone() for a in args[:2]), args[2], LR, R, W, U_REG, I_REG,
        collision_norm, mm_bf16, r_scale=r_scale)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 160])
@pytest.mark.parametrize("mode", ["codes", "bf16+W"])
def test_masked_kernel_padding_and_edges(mode, k):
    """k = 10 (padded to 16 on the tensor cores) and 160 (the CUDA-core
    kernel), stripes of 130 users, a ragged 200-item catalog; Poisson rank
    rows, rtol 1e-3 / atol 1e-5."""
    dev = _cuda()
    rng = np.random.default_rng(43)
    NU, bu, ni = 3, 130, 200
    R, W, r_scale = _tiles(mode, rng, (NU, bu, ni), dev)
    u3 = torch.from_numpy(0.03 * rng.normal(size=(NU, bu, k))).float()
    i_tab = torch.from_numpy(0.03 * rng.normal(size=(ni, k))).float()
    args = (u3.to(dev), i_tab.to(dev), torch.from_numpy(rng.permutation(NU)),
            R, W, r_scale)
    got, want = _masked_pair(args, _ranks(rng, NU, bu, ni, k, "poisson", dev),
                             True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("collision_norm", [True, False])
@pytest.mark.parametrize("mode", MASK_MODES)
def test_masked_kernel_bf16_rounding_exact(mode, collision_norm):
    """One masked stripe whose bf16 rounding is exact: the kernel matches
    the plain version in its own matmul precision at rtol 1e-5 / atol 1e-6
    and misses the other precision (the control)."""
    dev = _cuda()
    rng = np.random.default_rng(44)
    bu, ni, k = 100, 200, 64
    R, W, r_scale = _tiles(mode, rng, (1, bu, ni), dev)
    args = (_dyadic(rng, (1, bu, k)).to(dev), _dyadic(rng, (ni, k)).to(dev),
            torch.zeros(1, dtype=torch.int64), R, W, r_scale)
    ranks = _ranks(rng, 1, bu, ni, k, "static", dev)
    lr = LR if collision_norm else LR / 10
    pairs = {mm: _masked_pair(args, ranks, mm, lr, collision_norm)
             for mm in (True, False)}
    for mm in (True, False):
        for got, want, ctl in zip(pairs[mm][0], pairs[mm][1],
                                  pairs[not mm][1]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            assert not torch.allclose(got, ctl, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 160])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("mode", MASK_MODES)
def test_full_rank_masks_equal_the_unmasked_kernel(mode, mm_bf16, k):
    """Every rank at k: the masked instantiation gives the unmasked
    kernel's factors bit for bit, on both routes; with every lambda at k
    and identity rank rows, and with random lambdas and rows of k."""
    dev = _cuda()
    rng = np.random.default_rng(45)
    args = _stripe_args(mode, rng, dev, k=k)
    NU, bu, k = args[0].shape
    for full in (True, False):
        ranks = _ranks(rng, NU, bu, args[1].shape[0], k, "static", dev,
                       full=full)
        if not full:
            ranks = (*ranks[:2], torch.full_like(ranks[2], k))
        u3, i_tab, order, R, W, r_scale = args
        got = tdrk.dense_rows_epoch(u3.clone(), i_tab.clone(), order, LR, R,
                                    W, r_scale, U_REG, I_REG, True, mm_bf16,
                                    ranks=ranks)
        want = _stripe_epoch(args, mm_bf16)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("rtype", [torch.float32, torch.bfloat16])
def test_masked_codes_equal_float_tiles_bitwise(rtype, mm_bf16):
    """Masked half-star codes and masked float tiles of code * 0.5 with
    int8 validity give bit-identical factors; the masked epoch run twice
    is bit-identical too."""
    dev = _cuda()
    rng = np.random.default_rng(46)
    NU, bu, ni, k = 3, 260, 1200, 64
    codes, _, _ = _tiles("codes", rng, (NU, bu, ni), dev)
    u3 = torch.from_numpy(0.1 * rng.normal(size=(NU, bu, k))).float()
    i_tab = torch.from_numpy(0.1 * rng.normal(size=(ni, k))).float()
    base = (u3.to(dev), i_tab.to(dev), torch.from_numpy(rng.permutation(NU)))
    ranks = _ranks(rng, NU, bu, ni, k, "poisson", dev)
    run = lambda R, W, r_scale: tdrk.dense_rows_epoch(
        base[0].clone(), base[1].clone(), base[2], LR, R, W, r_scale, U_REG,
        I_REG, True, mm_bf16, ranks=ranks)
    got = run(codes, None, 0.5)
    again = run(codes, None, 0.5)
    want = run((codes.float() * 0.5).to(rtype), (codes != 0).to(torch.int8),
               None)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32+fW", "bf16+bfW"])
def test_masked_kernel_refuses_float_weights(mode):
    """Rank masks are instantiated for 0/1-weight tiles only: float W
    raises, and nothing falls back to the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(47)
    args = _stripe_args(mode, rng, dev, NU=2, bu=64, ni=256, k=16)
    u3, i_tab, order, R, W, r_scale = args
    ranks = _ranks(rng, 2, 64, 256, 16, "static", dev)
    before = tdrk.dense_rows_epoch.launches
    with pytest.raises(ValueError, match="rank masks are instantiated"):
        tdrk.dense_rows_epoch(u3, i_tab, order, LR, R, W, r_scale, U_REG,
                              I_REG, True, True, ranks=ranks)
    assert tdrk.dense_rows_epoch.launches == before


def _longtail_data():
    from matfac_tpu_torch import (Data, low_rank_ratings,
                                  split_train_test_val)
    mat, _, _ = low_rank_ratings(600, 500, k=4, density=0.1, seed=2,
                                 noise=0.1, nonneg=True, power_law=0.8)
    tr, te, va = split_train_test_val(mat, 0.1, 0.1, seed=1)
    return Data(train_mat=tr, test_mat=te, val_mat=va)


@pytest.mark.cuda
def test_tmfdropout_densesgd_resume_is_bit_exact_on_the_card(tmp_path):
    """TMF+Dropout on densesgd (the masked kernel, quantile rows drawn by
    the solver's generator) stopped after 3 epochs and resumed to 5 equals
    the uninterrupted run, bit for bit; its ranks are not all k."""
    from matfac_tpu_torch import Params
    from matfac_tpu_torch.train.loop import train_model
    _cuda()
    data = _longtail_data()
    p = Params(fac_dim=16, u_reg=0.01, i_reg=0.01, learn_rate=0.05,
               max_iter=5, seed=1, disp_iter=1000, save_iter=1)
    run = lambda prefix, params, resume: train_model(
        data, params, algo="tmfdropout", mf_method="densesgd", device="cuda",
        prefix=str(tmp_path / prefix), resume=resume,
        log_fn=lambda s: None)[0]
    full = run("full", p, False)
    Lu, Li = full.solver.rank_tabs
    assert int(Lu.min()) < 16 and full.solver.pois_cdf is not None
    run("part", p.replace(max_iter=3), False)
    res = run("part", p, True)
    assert torch.equal(full.state.u_fac, res.state.u_fac)
    assert torch.equal(full.state.i_fac, res.state.i_fac)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["mf", "tmfdropout", "mf_bias"])
def test_scatter_engine_trains_on_the_card(algo):
    """train_model's default method (the scatter engine) on the card: val
    RMSE finite and below the initial state's, state on the card."""
    from matfac_tpu_torch import Params
    from matfac_tpu_torch.models.base import init_state
    from matfac_tpu_torch.train.loop import train_model
    _cuda()
    data = _longtail_data()
    p = Params(fac_dim=16, u_reg=0.01, i_reg=0.01, learn_rate=0.01,
               max_iter=5, seed=1, disp_iter=1000, batch_size=1024)
    rep, model, ev, _ = train_model(data, p, algo=algo, device="cuda",
                                    log_fn=lambda s: None)
    assert rep.state.u_fac.device.type == "cuda"
    val0 = ev.rmse(model.eval_view(init_state(p, data.n_users, data.n_items,
                                              device="cuda")), "val")
    assert np.isfinite(rep.best_metric) and rep.best_metric < val0


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
    assert ttk.topk_catalog.launches - before == ttk.pass_launches(200, 1201,
                                                                   n)
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


def _topk_check(got, want, exact):
    """Scores at rtol 1e-5 / atol 1e-6 and ids where no neighbour is that
    close (exact cases: both equal)."""
    gs, gi, ws, wi = (t.cpu() for t in (*got, *want))
    if exact:
        assert torch.equal(gs, ws) and torch.equal(gi, wi)
        return
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-6)
    tol = 2 * (1e-6 + 1e-5 * ws.abs())
    inf = torch.full((ws.shape[0], 1), float("inf"))
    gap = ws[:, :-1] - ws[:, 1:]
    held = ((torch.cat([inf, gap], 1) > tol) & (torch.cat([gap, inf], 1)
                                                > tol)) | (wi == -1)
    assert torch.equal(gi[held], wi[held])


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["large", "small"])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("k", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 10, 64, ttk.FUSED_MAX_N])
def test_topk_fused_route_matches_plain(n, k, exact, size):
    """The fused route on ragged shapes: "large" B fills the card with user
    tiles (one slice, one launch), "small" B splits the catalog (slices and
    the merge, two launches); exact cases (ties from duplicated items)
    equal, the smaller id first."""
    dev = _cuda()
    n_users, n_items = (20_000, 1_100) if size == "large" else (150, 2_900)
    args = _topk_inputs(np.random.default_rng(k + n), n_users, n_items, k,
                        exact, dev)
    pl = ttk.fused_plan(n_users, n_items, n)
    assert pl["route"] == "fused"
    assert (pl["splits"] == 1) == (size == "large"), pl
    before = ttk.topk_catalog.launches
    got = ttk.topk_catalog(**args, n=n)
    assert ttk.topk_catalog.launches - before == 1 + (size == "small")
    _topk_check(got, ttk.topk_plain(**args, n=n), exact)
    if exact and n > 1:
        gs, gi = (t.cpu() for t in got)
        tie = (gs[:, 1:] == gs[:, :-1]) & (gi[:, 1:] >= 0)
        assert bool(tie.any())
        assert bool((gi[:, :-1][tie] < gi[:, 1:][tie]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 1000])
def test_topk_user_alone_scores_as_in_a_full_pass(n):
    """A user's scores do not depend on the other users, the slice or the
    tile it is scored in: one user alone (split catalog) gives bitwise the
    row it gets in a full pass (one slice), on both routes."""
    dev = _cuda()
    args = _topk_inputs(np.random.default_rng(5), 20_000, 1_100, 64, False,
                        dev)
    full_s, full_i = ttk.topk_catalog(**args, n=n)
    for row in (0, 7, 19_999):
        user = args["users"][row:row + 1]
        s, i = ttk.topk_catalog(**dict(args, users=user), n=n)
        assert torch.equal(s[0], full_s[row]) and torch.equal(i[0],
                                                              full_i[row])


@pytest.mark.cuda
def test_topk_launches_per_pass_and_no_score_scratch():
    """Launches a pass: 1 (fused, the card filled), 2 (fused, split), one
    pair a user chunk (radix, n > FUSED_MAX_N); the fused route allocates
    no [B, n_items] score scratch (peak memory grows by less than a tenth
    of one)."""
    dev = _cuda()
    args = _topk_inputs(np.random.default_rng(6), 20_000, 3_000, 64, False,
                        dev)
    for B, n, want in ((20_000, 10, 1), (300, 10, 2),
                       (20_000, 1000, -(-20_000 // ttk.chunk_users(3_000))
                        * ttk.KERNELS_PER_CHUNK)):
        a = dict(args, users=args["users"][:B].contiguous())
        assert ttk.pass_launches(B, 3_000, n) == want
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = ttk.topk_catalog.launches
        ttk.topk_catalog(**a, n=n)
        torch.cuda.synchronize()
        assert ttk.topk_catalog.launches - before == want
        if n <= ttk.FUSED_MAX_N:
            grew = torch.cuda.max_memory_allocated() - base
            assert grew < B * 3_000 * 4 / 10, grew


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["1 elementwise", "2 grid matmul",
                                   "3 batch update", "4 scalar prefetch",
                                   "5 slice loop"])
def test_bisect_probe_matches_plain(stage):
    """Each toolchain probe (csrc/bisect_probes.cu) launches once and
    equals its plain version exactly (its inputs make every result exact
    in f32)."""
    from matfac_tpu_torch.ops import bisect_probes as tbp
    dev = _cuda()
    fn, plain, args = tbp.stage_inputs(torch.Generator().manual_seed(0),
                                       dev)[stage]
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    want = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# the one-hot cell kernel (csrc/block_sgd.cu)
# ----------------------------------------------------------------------

# (bu, bi, k, bs): a step's segment sums in the cluster's shared memory
# (small blocks; the JAX default 1024-blocks at k = 64), or in the global
# scratch (2048-blocks at k = 256 and 2048-slot steps: up to 4,608 sums of
# 1 KiB, above 227 KiB a CTA even at C = 16)
BLOCK_ROUTES = {"cluster": (64, 48, 64, 64),
                "cluster1024": (1024, 1024, 64, 256),
                "scratch": (2048, 2048, 256, 2048)}


def _cell_streams(rng, n_rows, S, bs, bu, bi, k, weights, dummy=False):
    """Streams [n_rows (+ 1 all-invalid dummy row), S] as the solver stages
    them: ~80% valid slots, padding slots w = 0, ids 0, lam 1; ids from
    max(8, bs / 8) rows, so they repeat within every batch (~6 times: the
    steps stay stable) and some rows of a large batch span several of the
    kernel's 8-slot ranges;
    weights 0/1 or float in [0.2, 1) on the valid slots (IFWMF-like);
    collision counts of each static batch slice."""
    valid = rng.random((n_rows, S)) < 0.8
    if dummy:
        valid = np.concatenate([valid, np.zeros((1, S), bool)])
    shape = valid.shape
    n_ids = max(8, bs // 8)
    u = np.where(valid, rng.integers(0, min(n_ids, bu), shape), 0)
    i = np.where(valid, rng.integers(0, min(n_ids, bi), shape), 0)
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
@pytest.mark.parametrize("route", list(BLOCK_ROUTES))
@pytest.mark.parametrize("weights", ["01", "float"])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
def test_block_row_kernel_matches_plain(collision_norm, use_mask, weights,
                                        route):
    """The row schedule (one launch, one cluster walking the 6 cells in
    order) at f32, 3 rows x 2 cells x 3 steps from random batch offsets,
    ids repeating within every batch: rtol 1e-5 / atol 1e-6, the class the
    JAX package pins between its two engines (summation order only).
    Without collision normalization a row's step is the sum of ~8 repeats,
    so the step takes lr / 8."""
    dev = _cuda()
    bu, bi, k, bs = BLOCK_ROUTES[route]
    pl = tbsk.plan(1, bs, bu, bi, k)
    assert pl["route"] == route.replace("1024", "")
    assert pl["cluster"] >= 2   # the chain spreads over several SMs
    rng = np.random.default_rng(21)
    NU, NI, n_steps = 3, 2, 3
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
    tbsk.reset_counts(tbsk.block_sgd_epoch)
    got = tbsk.block_sgd_epoch(u_tab.clone(), i_tab.clone(), *sched, lr,
                               *streams, **kw)
    assert tbsk.block_sgd_epoch.launches == 1
    assert tbsk.cells_done(tbsk.block_sgd_epoch) == NU * NI
    want = tbsk.block_sweep_rows(u_tab.clone(), i_tab.clone(), *sched, lr,
                                 *streams, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


NI_DIAG = 3


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(BLOCK_ROUTES))
@pytest.mark.parametrize("weights", ["01", "float"])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
def test_block_diag_kernel_matches_plain(collision_norm, use_mask, weights,
                                         route):
    """The diag schedule (one launch, one cluster per lane, a grid barrier
    between rounds) at f32: 5 user blocks x 3 item blocks in 6 rounds of 3
    lanes, one of them a dummy lane; 2 steps per cell from random batch
    offsets. Tolerance as for the row schedule."""
    dev = _cuda()
    bu, bi, k, bs = BLOCK_ROUTES[route]
    assert tbsk.plan(NI_DIAG, bs, bu, bi, k)["route"] == \
        route.replace("1024", "")
    rng = np.random.default_rng(22)
    NU, NI, n_steps = 5, NI_DIAG, 2
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
    tbsk.reset_counts(tbsk.block_sgd_diag_epoch)
    got = tbsk.block_sgd_diag_epoch(u_tab.clone(), i_tab.clone(), *sched,
                                    lr, *streams, **kw)
    assert tbsk.block_sgd_diag_epoch.launches == 1
    assert tbsk.cells_done(tbsk.block_sgd_diag_epoch) == NU * NI
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
    tbsk.reset_counts(tsk.fused_cell_update)
    got = tsk.fused_cell_update(*args, 0.05, bs, 0.01, 0.02)
    assert tsk.fused_cell_update.launches == 1
    assert tbsk.cells_done(tsk.fused_cell_update) == 1
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


def _diag_pair(dev, rng, NU, NI, sched, bu=64, bi=48, k=64, S=128, bs=64,
               streams=None):
    """(kernel, plain) diag epochs at f32 from the same inputs, and the
    kernel's finished-cell count."""
    if streams is None:
        streams = _cell_streams(rng, NU * NI, S, bs, bu, bi, k, "float",
                                dummy=True)
    streams = [x.to(dev) for x in streams]
    u_tab = torch.from_numpy(0.3 * rng.normal(size=(NU * bu, k))).float()
    i_tab = torch.from_numpy(0.3 * rng.normal(size=(NI * bi, k))).float()
    u_tab, i_tab = u_tab.to(dev), i_tab.to(dev)
    kw = _block_kw(bs, bu, bi, NI, True, False, False)
    tbsk.reset_counts(tbsk.block_sgd_diag_epoch)
    got = tbsk.block_sgd_diag_epoch(u_tab.clone(), i_tab.clone(), *sched,
                                    LR, *streams, **kw)
    cells = tbsk.cells_done(tbsk.block_sgd_diag_epoch)
    assert tbsk.block_sgd_diag_epoch.launches == 1
    want = tbsk.block_sweep_diag(u_tab.clone(), i_tab.clone(), *sched, LR,
                                 *streams, **kw)
    torch.cuda.synchronize()
    return got, want, cells


@pytest.mark.cuda
def test_block_diag_uneven_rounds_and_an_all_dummy_round():
    """Rounds with 3, 1, 0 and 2 real lanes of G = 3 (the idle clusters
    still meet every round barrier), then 12 rounds that move every user
    block across lanes, hence across clusters, from round to round (a
    factor row read past a stale L1 line would show): f32 at rtol 1e-5 /
    atol 1e-6; the device counter holds the real lanes."""
    dev = _cuda()
    rng = np.random.default_rng(24)
    NU, NI = 5, 3
    ub = np.array([[0, 1, 2], [5, 3, 5], [5, 5, 5], [4, 5, 0]])
    sched = (ub, np.tile(np.arange(NI), (4, 1)),
             rng.integers(0, 2, (4, NI)))
    got, want, cells = _diag_pair(dev, rng, NU, NI, sched)
    assert cells == int((ub < NU).sum()) == 6
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    NU = 12
    sched = tbsk.diag_schedule(torch.Generator().manual_seed(9), NU, NI, 2)
    got, want, cells = _diag_pair(dev, rng, NU, NI, sched)
    assert cells == NU * NI
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["row", "diag"])
def test_block_kernel_skips_padding_steps_exactly(schedule):
    """Cells staged as the solver stages them, valid slots first: live
    lengths 0, 1, 64, 70 and 200 of S = 256 in steps of 64, so the later
    steps of most cells are all padding and the kernel skips them; from
    random batch offsets, held to the plain version (which runs every step)
    at f32 rtol 1e-5 / atol 1e-6."""
    dev = _cuda()
    rng = np.random.default_rng(25)
    bu, bi, k, S, bs = 64, 48, 64, 256, 64
    NU, NI = (3, 2) if schedule == "row" else (5, 3)
    n_cells = NU * NI
    streams = _cell_streams(rng, n_cells, S, bs, bu, bi, k, "float",
                            dummy=schedule == "diag")
    live = np.resize([0, 1, 64, 70, 200], n_cells)
    keep = np.arange(S)[None, :] < live[:, None]
    keep = np.concatenate([keep, np.zeros((len(streams[0]) - n_cells, S),
                                          bool)])
    u, i, r, w, _, _, lam = (x.numpy() for x in streams)
    w = np.where(keep, np.maximum(w, 0.2), 0.0).astype(np.float32)
    u, i, r = (np.where(keep, a, 0).astype(a.dtype) for a in (u, i, r))
    cnu = stage_batch_collision_counts(w, u, bs, bu)
    cni = stage_batch_collision_counts(w, i, bs, bi)
    streams = [torch.from_numpy(a) for a in (u, i, r, w, cnu, cni, lam)]
    nv = tbsk.slice_tables([x.to(dev) for x in streams], bs, bu, bi, True,
                           False, 8)["cnt"][:, 2].cpu().numpy()
    per_slice = np.clip(live[:, None] - bs * np.arange(S // bs), 0, bs)
    assert np.array_equal(nv[:n_cells * (S // bs)], per_slice.ravel())
    if schedule == "diag":
        sched = tbsk.diag_schedule(torch.Generator().manual_seed(3), NU, NI,
                                   S // bs)
        got, want, cells = _diag_pair(dev, rng, NU, NI, sched, S=S, bs=bs,
                                      streams=streams)
        assert cells == n_cells
    else:
        streams = [x.reshape(NU, NI * S).to(dev) for x in streams]
        u_tab = torch.from_numpy(0.3 * rng.normal(size=(NU * bu, k))).float()
        i_tab = torch.from_numpy(0.3 * rng.normal(size=(NI * bi, k))).float()
        u_tab, i_tab = u_tab.to(dev), i_tab.to(dev)
        sched = (rng.permutation(NU),
                 np.stack([rng.permutation(NI) for _ in range(NU)]),
                 rng.integers(0, S // bs, (NU, NI)))
        kw = _block_kw(bs, bu, bi, NI, True, False, False)
        got = tbsk.block_sgd_epoch(u_tab.clone(), i_tab.clone(), *sched, LR,
                                   *streams, **kw)
        want = tbsk.block_sweep_rows(u_tab.clone(), i_tab.clone(), *sched,
                                     LR, *streams, **kw)
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_block_plan_picks_the_route_by_shape():
    """The plan: (i)'s 53 lanes of 384-blocks and 1024-slot steps take
    clusters of 2 (106 of 132 SMs); one lane at the JAX default 1024-blocks
    takes 16 CTAs (8 where the card cannot host 16); 2048-slot steps on
    2048-blocks at k = 256 take the global scratch; every plan's clusters
    are co-resident; the range length follows the lane groups."""
    _cuda()
    diag = tbsk.plan(53, 1024, 384, 384, 64)
    assert (diag["route"], diag["cluster"], diag["clusters"]) == \
        ("cluster", 2, 53)
    row = tbsk.plan(1, 1024, 1024, 1024, 64)
    assert (row["route"], row["clusters"]) == ("cluster", 1)
    assert row["cluster"] in (8, 16)
    assert tbsk.plan(1, 2048, 2048, 2048, 256)["route"] == "scratch"
    # 2 x 128 ranges of 8 slots fill (i)'s 128 lane groups; (k)'s 512 or
    # 1024 groups take ranges of 4
    assert (diag["range"], row["range"]) == (8, 4)
    for p in (diag, row):
        assert p["clusters"] <= p["resident"]


@pytest.mark.cuda
def test_block_kernel_raises_where_the_grid_cannot_be_co_resident():
    """A grid of more clusters than can be resident at once would deadlock
    at the round barrier: the launch is refused before it is made, and the
    tables are untouched."""
    dev = _cuda()
    rng = np.random.default_rng(26)
    bu, bi, k, S, bs = 64, 48, 64, 128, 64
    streams = [x.to(dev) for x in _cell_streams(rng, 1, S, bs, bu, bi, k,
                                                "01")]
    u_tab = torch.ones((bu, k), device=dev)
    i_tab = torch.ones((bi, k), device=dev)
    lanes = torch.zeros((2, 1, 4), dtype=torch.int32, device=dev)
    pl = tbsk.plan(1, bs, bu, bi, k)
    slices = tbsk.stage_slices(streams, bs, bu, bi, True, False, pl["range"])
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    cells = torch.zeros(1, dtype=torch.int64, device=dev)
    err = tbsk.library().block_sgd_run(
        0, 1, 0, u_tab.data_ptr(), i_tab.data_ptr(),
        *(slices[x].data_ptr() for x in tbsk._TABLES), lanes.data_ptr(), 2,
        1, S // bs, bs, bu, bi, k, -LR, 2 * U_REG, 2 * I_REG, pl["cluster"],
        pl["resident"] + 1, pl["range"], None, bar.data_ptr(),
        cells.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err == 720   # cudaErrorCooperativeLaunchTooLarge
    torch.cuda.synchronize()
    assert bool((u_tab == 1).all() and (i_tab == 1).all())
    assert int(cells) == 0
