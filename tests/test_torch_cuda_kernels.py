"""The hand-written CUDA kernel (matfac_tpu_torch/csrc/dense_rows.cu)
against its plain PyTorch version, on the card. Every test here is marked
``cuda`` and skips without a CUDA device. This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from matfac_tpu_torch.ops import dense_block_kernel as tdbk
from matfac_tpu_torch.ops import dense_row_kernel as tdrk

LR, U_REG, I_REG = 0.05, 0.01, 0.02


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("collision_norm", [True, False])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("mode", ["f32+W", "bf16+W", "codes"])
def test_kernel_matches_plain(mode, mm_bf16, collision_norm):
    """One epoch at a ragged shape (catalog not a multiple of the 64-item
    panel, stripe not a multiple of the 32-user chunk), rtol 1e-3 /
    atol 1e-5: summation order over bu and over panels. At mm_bf16 the
    factors are small enough that a bf16 flip of E, which one ulp of P
    decides, moves a factor by less than atol; without collision
    normalization the step takes lr / 20, ~the per-user count."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    NU, bu, ni, k = 4, 100, 200, 64
    valid = rng.random((NU, bu, ni)) < 0.1
    if mode == "codes":
        codes = np.where(valid, rng.integers(1, 11, valid.shape), 0)
        R, W, r_scale = torch.from_numpy(codes.astype(np.int8)), None, 0.5
    else:
        R = torch.from_numpy(np.where(valid, rng.normal(3.0, 1.0,
                                                        valid.shape), 0.0)
                             .astype(np.float32))
        R = R.to(torch.bfloat16) if mode == "bf16+W" else R
        W, r_scale = torch.from_numpy(valid.astype(np.int8)).to(dev), None
    R = R.to(dev)
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
        NU * tdrk.KERNELS_PER_STRIPE
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
@pytest.mark.parametrize("mode", ["f32+W", "bf16+W", "codes"])
def test_kernel_bf16_rounding_exact(mode, collision_norm):
    """One stripe whose bf16 rounding is exact: no rounding of E can flip
    between summation orders, so the kernel matches the plain version in
    its own matmul precision at rtol 1e-5 / atol 1e-6, and misses the
    plain version in the other precision at the same tolerance (the
    control that shows mm_bf16's rounding is what is checked)."""
    dev = _cuda()
    rng = np.random.default_rng(11)
    bu, ni, k = 100, 200, 64
    valid = rng.random((1, bu, ni)) < 0.1
    if mode == "codes":
        codes = np.where(valid, rng.integers(1, 11, valid.shape), 0)
        R, W, r_scale = torch.from_numpy(codes.astype(np.int8)), None, 0.5
    else:
        R = torch.from_numpy(np.where(valid, rng.normal(3.0, 1.0,
                                                        valid.shape), 0.0)
                             .astype(np.float32))
        R = R.to(torch.bfloat16) if mode == "bf16+W" else R
        W, r_scale = torch.from_numpy(valid.astype(np.int8)).to(dev), None
    R = R.to(dev)
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
def test_kernel_rejects_float_weights():
    dev = _cuda()
    u3 = torch.zeros((2, 8, 4), device=dev)
    i_tab = torch.zeros((16, 4), device=dev)
    R = torch.zeros((2, 8, 16), device=dev)
    with pytest.raises(ValueError, match="int8 W"):
        tdrk.dense_rows_epoch(u3, i_tab, torch.arange(2), LR, R, R.clone(),
                              None, U_REG, I_REG, True, False)
