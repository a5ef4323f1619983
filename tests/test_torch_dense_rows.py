"""Parity of the port's dense stripe math (matfac_tpu_torch.ops) with the
JAX package: the XLA ``cell_dense_update`` / ``dense_sweep_rows``, both
Pallas row kernels in interpret mode, and ``densify_rows_host``. The
same numpy inputs go to both packages. The CUDA kernel itself runs only
on a card: tests/test_torch_cuda_kernels.py (marker ``cuda``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matfac_tpu.ops import dense_block_kernel as jdbk
from matfac_tpu.ops.dense_row_kernel import (dense_rows_codes_pallas,
                                             dense_rows_epoch_pallas)
from matfac_tpu_torch.ops import dense_block_kernel as tdbk
from matfac_tpu_torch.ops import dense_row_kernel as tdrk

LR, U_REG, I_REG = 0.05, 0.01, 0.02
# mm_bf16=False: f32 matmuls in both packages, summation order only.
# mm_bf16=True: a one-ulp difference in P can flip one bf16 rounding of E.
TOL = {False: dict(rtol=1e-5, atol=1e-6), True: dict(rtol=1e-3, atol=1e-5)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tiles(mode, rng, shape, density=0.3):
    """(R, W, r_scale) numpy tiles: float ratings with int8 or f32
    weights, or int8 half-star codes."""
    valid = rng.random(shape) < density
    if mode == "codes":
        return (np.where(valid, rng.integers(1, 11, shape), 0)
                .astype(np.int8), None, 0.5)
    R = np.where(valid, rng.normal(3.0, 1.0, shape), 0.0).astype(np.float32)
    if mode == "float_w_int8":
        return R, valid.astype(np.int8), None
    W = np.where(valid, rng.uniform(0.5, 2.0, shape), 0.0)
    return R, W.astype(np.float32), None


def _factors(rng, *shape):
    return rng.normal(0.0, 0.3, shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
@pytest.mark.parametrize("mode", ["float_w_int8", "float_w_f32", "codes"])
def test_cell_dense_update_matches_jax(mode, collision_norm, mm_bf16):
    rng = np.random.default_rng(0)
    U, I = _factors(rng, 24, 8), _factors(rng, 40, 8)
    R, W, r_scale = _tiles(mode, rng, (24, 40))
    mm_dtype = jnp.bfloat16 if mm_bf16 else jnp.float32
    uj, ij = jdbk.cell_dense_update(
        _j(U), _j(I), _j(R), _j(W), jnp.float32(LR), U_REG, I_REG,
        collision_norm, mm_dtype, r_scale=r_scale)
    ut, it = tdbk.cell_dense_update(
        _t(U), _t(I), _t(R), _t(W), LR, U_REG, I_REG, collision_norm,
        mm_bf16, r_scale=r_scale)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL[mm_bf16])
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), **TOL[mm_bf16])


def _stripes(mode, seed=1, NU=5, bu=12, ni=128, k=6, density=0.2):
    rng = np.random.default_rng(seed)
    R, W, r_scale = _tiles(mode, rng, (NU, bu, ni), density=density)
    orders = [rng.permutation(NU).astype(np.int32) for _ in range(2)]
    return (_factors(rng, NU, bu, k), _factors(rng, ni, k), R, W, r_scale,
            orders)


@pytest.mark.parametrize("collision_norm", [False, True])
@pytest.mark.parametrize("mode", ["float_w_int8", "codes"])
def test_dense_sweep_rows_matches_jax(mode, collision_norm):
    u3, i_tab, R, W, r_scale, orders = _stripes(mode)
    uj, ij = _j(u3), _j(i_tab)
    ut, it = _t(u3), _t(i_tab)
    for order in orders:   # 2 epochs, same stripe orders
        uj, ij = jdbk.dense_sweep_rows(
            uj, ij, _j(order), jnp.float32(LR), _j(R), _j(W), U_REG, I_REG,
            collision_norm, mm_bf16=False, r_scale=r_scale)
        ut, it = tdbk.dense_sweep_rows(
            ut, it, _t(order), LR, _t(R), _t(W), U_REG, I_REG,
            collision_norm, mm_bf16=False, r_scale=r_scale)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL[False])
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), **TOL[False])


@pytest.mark.parametrize("collision_norm", [False, True])
def test_port_matches_pallas_float_kernel(collision_norm):
    """dense_rows_epoch (CPU route) vs dense_rows_epoch_pallas in
    interpret mode, 2 epochs, f32 matmuls."""
    u3, i_tab, R, W, _, orders = _stripes("float_w_int8", seed=2)
    uj, ij = _j(u3), _j(i_tab)
    ut, it = _t(u3), _t(i_tab)
    for order in orders:
        uj, ij = dense_rows_epoch_pallas(
            uj, ij, _j(order), jnp.float32(LR), _j(R), _j(W), panel=64,
            u_reg=U_REG, i_reg=I_REG, collision_norm=collision_norm,
            mm_bf16=False, interpret=True)
        ut, it = tdrk.dense_rows_epoch(
            ut, it, _t(order), LR, _t(R), _t(W), None, U_REG, I_REG,
            collision_norm, mm_bf16=False)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL[False])
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), **TOL[False])


@pytest.mark.parametrize("collision_norm", [False, True])
def test_port_matches_pallas_codes_kernel(collision_norm):
    """dense_rows_epoch on int8 codes vs dense_rows_codes_pallas in
    interpret mode, 2 epochs. The Pallas kernel stores its item table in
    bf16 between stripes; the port keeps f32 (a documented deviation), so
    the class is the JAX package's own for that store, 5e-3 / 5e-4, at
    its regime (init-scale factors, tests/test_pallas_dense_rows.py).
    Both start from a bf16-exact table."""
    # init-scale factors and ~12 ratings per user in a stripe, as in the
    # JAX package's own test of this class
    u3, i_tab, R, _, r_scale, orders = _stripes("codes", seed=3,
                                                density=0.1)
    rng = np.random.default_rng(3)
    u3 = rng.uniform(-0.01, 0.01, u3.shape).astype(np.float32)
    i_tab = np.asarray(jnp.asarray(
        rng.uniform(-0.01, 0.01, i_tab.shape).astype(np.float32))
        .astype(jnp.bfloat16).astype(jnp.float32))
    NU, bu, ni = R.shape
    panel = 64
    R_panels = R.reshape(NU, bu, ni // panel, panel).transpose(0, 2, 1, 3)
    uj, ij = _j(u3), jnp.asarray(i_tab).astype(jnp.bfloat16)
    ut, it = _t(u3), _t(i_tab)
    for order in orders:
        uj, ij = dense_rows_codes_pallas(
            uj, ij, _j(order), jnp.float32(LR), _j(R_panels), panel=panel,
            r_scale=r_scale, u_reg=U_REG, i_reg=I_REG,
            collision_norm=collision_norm, interpret=True)
        ut, it = tdrk.dense_rows_epoch(
            ut, it, _t(order), LR, _t(R), None, r_scale, U_REG, I_REG,
            collision_norm, mm_bf16=True)
    tol = dict(rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **tol)
    np.testing.assert_allclose(it.numpy(),
                               np.asarray(ij.astype(jnp.float32)), **tol)


def test_cpu_route_is_the_plain_version_and_launches_nothing():
    u3, i_tab, R, W, _, orders = _stripes("float_w_int8", seed=4)
    before = tdrk.dense_rows_epoch.launches
    ut, it = tdrk.dense_rows_epoch(_t(u3), _t(i_tab), _t(orders[0]), LR,
                                   _t(R), _t(W), None, U_REG, I_REG, True,
                                   True)
    up, ip = tdbk.dense_sweep_rows(_t(u3), _t(i_tab), _t(orders[0]), LR,
                                   _t(R), _t(W), U_REG, I_REG, True, True)
    assert torch.equal(ut, up) and torch.equal(it, ip)
    assert tdrk.dense_rows_epoch.launches == before


@pytest.mark.parametrize("bad", ["shape", "contiguity", "codes_scale",
                                 "order_range", "order_len", "order_repeat",
                                 "f64_table"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    u3, i_tab, R, W, _, orders = _stripes("float_w_int8", seed=5)
    args = dict(u3=_t(u3), i_tab=_t(i_tab), row_order=_t(orders[0]),
                R_rows=_t(R), W_rows=_t(W), r_scale=None)
    if bad == "shape":
        args["i_tab"] = args["i_tab"][:-1]
    elif bad == "contiguity":
        args["R_rows"] = args["R_rows"].transpose(1, 2).contiguous() \
            .transpose(1, 2)
    elif bad == "codes_scale":
        args["R_rows"] = args["R_rows"].to(torch.int8)
        args["W_rows"] = None
    elif bad == "order_range":
        args["row_order"] = args["row_order"] + 1
    elif bad == "order_len":
        args["row_order"] = args["row_order"][:-1]
    elif bad == "order_repeat":   # each stripe once an epoch
        args["row_order"] = args["row_order"].clone()
        args["row_order"][1] = args["row_order"][0]
    else:
        args["u3"] = args["u3"].double()
    with pytest.raises(ValueError):
        tdrk.dense_rows_epoch(lr=LR, u_reg=U_REG, i_reg=I_REG,
                              collision_norm=True, mm_bf16=False, **args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_densify_rows_matches_jax_bit_for_bit(dtype):
    """Same grid as densify_rows_host, duplicates summed, across several
    row chunks."""
    rng = np.random.default_rng(6)
    n_cells, bu, bi, n = 4, 8, 48, 300
    cell = rng.integers(0, n_cells, n)
    u_loc = rng.integers(0, bu, n).astype(np.int32)
    i_loc = rng.integers(0, bi, n).astype(np.int32)
    dup = rng.integers(0, n, 20)    # pairs of duplicate (row, col) slots
    cell, u_loc, i_loc = (np.concatenate([a, a[dup]])
                          for a in (cell, u_loc, i_loc))
    if dtype == "int8":
        vals = rng.integers(-60, 60, len(cell)).astype(np.int8)
    else:
        vals = rng.normal(0, 2, len(cell)).astype(np.float32)
    jx = jdbk.densify_rows_host(cell, u_loc, i_loc, vals, n_cells, bu, bi,
                                getattr(jnp, dtype), chunk_elems=5 * bi)
    tt = tdbk.densify_rows(cell, u_loc, i_loc, vals, n_cells, bu, bi,
                           getattr(torch, dtype), device="cpu",
                           chunk_elems=5 * bi)
    got = tt.view(torch.int16 if dtype == "bfloat16" else tt.dtype).numpy()
    want = np.asarray(jx)
    if dtype == "bfloat16":
        want = want.view(np.int16)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["float_w_int8", "float_w_f32", "codes"])
def test_stripe_counts_are_the_validity_counts(mode):
    """The counts the kernel reads are the plain version's cnt_u / cnt_i:
    W > 0 (never the weights), or code != 0; negative weights count as
    invalid, as in cell_dense_update."""
    _, _, R, W, _, _ = _stripes(mode, seed=6)
    if W is not None:
        W = W.copy()
        W[0, 0, :3] = -1
    cnt_u, cnt_i = tdrk.stripe_counts(_t(R), _t(W))
    valid = (W > 0) if W is not None else (R != 0)
    np.testing.assert_array_equal(cnt_u.numpy(), valid.sum(2))
    np.testing.assert_array_equal(cnt_i.numpy(), valid.sum(1))
    assert cnt_u.dtype == cnt_i.dtype == torch.float32
