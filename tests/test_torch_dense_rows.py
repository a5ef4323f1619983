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
    """StripeTiles.rows_epoch (CPU route) vs dense_rows_epoch_pallas in
    interpret mode, 2 epochs, f32 matmuls."""
    u3, i_tab, R, W, _, orders = _stripes("float_w_int8", seed=2)
    uj, ij = _j(u3), _j(i_tab)
    ut, it = _t(u3), _t(i_tab)
    tiles = tdrk.StripeTiles(_t(R), _t(W), None, u3.shape[2], U_REG, I_REG,
                             collision_norm, mm_bf16=False)
    for order in orders:
        uj, ij = dense_rows_epoch_pallas(
            uj, ij, _j(order), jnp.float32(LR), _j(R), _j(W), panel=64,
            u_reg=U_REG, i_reg=I_REG, collision_norm=collision_norm,
            mm_bf16=False, interpret=True)
        ut, it = tiles.rows_epoch(ut, it, _t(order), LR)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL[False])
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), **TOL[False])


@pytest.mark.parametrize("collision_norm", [False, True])
def test_port_matches_pallas_codes_kernel(collision_norm):
    """StripeTiles.rows_epoch on int8 codes vs dense_rows_codes_pallas in
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
    tiles = tdrk.StripeTiles(_t(R), None, r_scale, u3.shape[2], U_REG, I_REG,
                             collision_norm, mm_bf16=True)
    for order in orders:
        uj, ij = dense_rows_codes_pallas(
            uj, ij, _j(order), jnp.float32(LR), _j(R_panels), panel=panel,
            r_scale=r_scale, u_reg=U_REG, i_reg=I_REG,
            collision_norm=collision_norm, interpret=True)
        ut, it = tiles.rows_epoch(ut, it, _t(order), LR)
    tol = dict(rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **tol)
    np.testing.assert_allclose(it.numpy(),
                               np.asarray(ij.astype(jnp.float32)), **tol)


def test_cpu_route_is_the_plain_version_and_launches_nothing():
    u3, i_tab, R, W, _, orders = _stripes("float_w_int8", seed=4)
    before = tdrk.StripeTiles.launches
    tiles = tdrk.StripeTiles(_t(R), _t(W), None, u3.shape[2], U_REG, I_REG,
                             True, True)
    ut, it = tiles.rows_epoch(_t(u3), _t(i_tab), _t(orders[0]), LR)
    up, ip = tdbk.dense_sweep_rows(_t(u3), _t(i_tab), _t(orders[0]), LR,
                                   _t(R), _t(W), U_REG, I_REG, True, True)
    assert torch.equal(ut, up) and torch.equal(it, ip)
    assert tiles.counts is None and tiles.hists is None   # nothing staged
    assert tdrk.StripeTiles.launches == before


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
        tdrk.StripeTiles(args["R_rows"], args["W_rows"], args["r_scale"],
                         u3.shape[2], U_REG, I_REG, True, False).rows_epoch(
            args["u3"], args["i_tab"], args["row_order"], LR)


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


# ----------------------------------------------------------------------
# rank masks (TMF's static ranks, TMF+Dropout's per-visit Poisson ranks)
# ----------------------------------------------------------------------

def _lambdas(rng, NU, bu, ni, k):
    return (rng.integers(1, k + 1, (NU, bu)).astype(np.int32),
            rng.integers(1, k + 1, ni).astype(np.int32))


def _masks(L, k):
    return (np.arange(k) < L[..., None]).astype(np.float32)


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
@pytest.mark.parametrize("mode", ["float_w_int8", "float_w_f32", "codes"])
def test_masked_cell_dense_update_matches_jax(mode, collision_norm, mm_bf16):
    """cell_dense_update with 0/1 rank masks Mu / Mi: the masked products,
    the masked counts (vm @ Mi) o Mu, the unmasked normalization; f32 and
    bf16 operands at the classes of the unmasked test."""
    rng = np.random.default_rng(20)
    U, I = _factors(rng, 24, 8), _factors(rng, 40, 8)
    R, W, r_scale = _tiles(mode, rng, (24, 40))
    Lu, Li = _lambdas(rng, 1, 24, 40, 8)
    Mu, Mi = _masks(Lu[0], 8), _masks(Li, 8)
    mm_dtype = jnp.bfloat16 if mm_bf16 else jnp.float32
    uj, ij = jdbk.cell_dense_update(
        _j(U), _j(I), _j(R), _j(W), jnp.float32(LR), U_REG, I_REG,
        collision_norm, mm_dtype, Mu=_j(Mu), Mi=_j(Mi), r_scale=r_scale)
    ut, it = tdbk.cell_dense_update(
        _t(U), _t(I), _t(R), _t(W), LR, U_REG, I_REG, collision_norm,
        mm_bf16, Mu=_t(Mu), Mi=_t(Mi), r_scale=r_scale)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL[mm_bf16])
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), **TOL[mm_bf16])
    # masked dims of entities that rate nothing there keep their values
    assert np.array_equal(ut.numpy()[Mu == 0], U[Mu == 0])


def _poisson(k, NU, seed):
    from matfac_tpu_torch.models.longtail import poisson_cdf_table
    rng = np.random.default_rng(seed)
    return poisson_cdf_table(k), rng.random(NU).astype(np.float32)


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("collision_norm", [False, True])
@pytest.mark.parametrize("ranks", ["static", "poisson"])
@pytest.mark.parametrize("mode", ["float_w_int8", "codes"])
def test_masked_dense_sweep_rows_matches_jax(mode, ranks, collision_norm,
                                             mm_bf16):
    """Two epochs of dense_sweep_rows with the same stripe orders: static
    masks Mu3 / Mi (TMF), or lambda tables with the Poisson CDF table and
    the same round uniforms (TMF+Dropout); and the port's per-visit rank
    table Q form (``visit_quantiles`` / ``identity_quantiles``, what the
    stripe kernel reads) gives the port's mask form bit for bit."""
    u3, i_tab, R, W, r_scale, orders = _stripes(mode, seed=21)
    NU, bu, k = u3.shape
    ni = i_tab.shape[0]
    Lu, Li = _lambdas(np.random.default_rng(22), NU, bu, ni, k)
    if ranks == "static":
        kw_j = dict(Mu3=_j(_masks(Lu, k)), Mi=_j(_masks(Li, k)))
        kw_t = dict(Mu3=_t(_masks(Lu, k)), Mi=_t(_masks(Li, k)))
        q_of = lambda epoch: tdbk.identity_quantiles(NU, k)
    else:
        cdf, _ = _poisson(k, NU, 0)
        us = [_poisson(k, NU, 1 + e)[1] for e in range(2)]
        kw_j = [dict(Lu3=_j(Lu), Li=_j(Li), pois_cdf=_j(cdf),
                     round_u=_j(u)) for u in us]
        kw_t = [dict(Lu3=_t(Lu), Li=_t(Li), pois_cdf=_t(cdf),
                     round_u=_t(u)) for u in us]
        q_of = lambda epoch: tdbk.visit_quantiles(_t(cdf), _t(us[epoch]))
    uj, ij = _j(u3), _j(i_tab)
    ut, it = _t(u3), _t(i_tab)
    uq, iq = _t(u3), _t(i_tab)
    for e, order in enumerate(orders):
        kj = kw_j if ranks == "static" else kw_j[e]
        kt = kw_t if ranks == "static" else kw_t[e]
        uj, ij = jdbk.dense_sweep_rows(
            uj, ij, _j(order), jnp.float32(LR), _j(R), _j(W), U_REG, I_REG,
            collision_norm, mm_bf16=mm_bf16, r_scale=r_scale, **kj)
        ut, it = tdbk.dense_sweep_rows(
            ut, it, _t(order), LR, _t(R), _t(W), U_REG, I_REG,
            collision_norm, mm_bf16=mm_bf16, r_scale=r_scale, **kt)
        uq, iq = tdbk.dense_sweep_rows(
            uq, iq, _t(order), LR, _t(R), _t(W), U_REG, I_REG,
            collision_norm, mm_bf16=mm_bf16, r_scale=r_scale, Lu3=_t(Lu),
            Li=_t(Li), Q=q_of(e))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL[mm_bf16])
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), **TOL[mm_bf16])
    assert torch.equal(ut, uq) and torch.equal(it, iq)


@pytest.mark.parametrize("k", [4, 8])
def test_visit_quantiles_match_jax_and_are_monotone(k):
    """Q[t, lam - 1] = clip(#{m : C[lam - 1, m] < U_t}, 1, k), the rank
    row JAX's dense_sweep_rows derives per visit, exactly; nondecreasing
    in lambda at every uniform (what the kernel's masked counts need)."""
    cdf, _ = _poisson(k, 1, 0)
    us = np.linspace(1e-6, 1 - 1e-6, 2001).astype(np.float32)
    Q = tdbk.visit_quantiles(_t(cdf), _t(us)).numpy()
    want = np.clip((cdf[None] < us[:, None, None]).sum(-1), 1, k)
    assert Q.dtype == np.int32 and np.array_equal(Q, want)
    assert np.all(np.diff(Q, axis=1) >= 0)
    assert np.array_equal(tdbk.identity_quantiles(3, k).numpy(),
                          np.tile(np.arange(1, k + 1, dtype=np.int32), (3, 1)))


@pytest.mark.parametrize("ranks", ["static", "poisson"])
@pytest.mark.parametrize("mode", ["float_w_int8", "codes"])
def test_rank_hists_give_the_masked_counts(mode, ranks):
    """The suffix histograms the kernel gathers its masked regularization
    counts from: for every visit row q and dim d, hist[.., j] with j the
    first index of q above d equals (vm @ Mi)[.., d] where the entity's
    own mask is live (exact integers), for users and items."""
    _, _, R, W, _, _ = _stripes(mode, seed=23)
    NU, bu, ni = R.shape
    k = 6
    Lu, Li = _lambdas(np.random.default_rng(24), NU, bu, ni, k)
    hist_u, hist_i = tdrk.rank_hists(_t(R), _t(W), _t(Lu), _t(Li), k)
    assert (hist_u.dtype, hist_i.dtype) == (torch.int32, torch.int16)
    if ranks == "static":
        Q = tdbk.identity_quantiles(NU, k)
    else:
        cdf, u = _poisson(k, NU, 25)
        Q = tdbk.visit_quantiles(_t(cdf), _t(u))
    vm = torch.from_numpy(((W > 0) if W is not None else (R != 0))
                          .astype(np.float32))
    for s in range(NU):
        q = Q[s]
        Mu = tdbk.rank_masks(_t(Lu[s]), q)
        Mi = tdbk.rank_masks(_t(Li), q)
        cnt_u, cnt_i = (vm[s] @ Mi) * Mu, (vm[s].T @ Mu) * Mi
        for d in range(k):
            above = torch.nonzero(q > d)
            if not len(above):
                assert float(cnt_u[:, d].abs().sum()) == 0.0
                continue
            j = int(above[0])
            assert torch.equal(cnt_u[:, d], hist_u[s, :, j].float()
                               * Mu[:, d])
            assert torch.equal(cnt_i[:, d], hist_i[s, :, j].float()
                               * Mi[:, d])


def _masked_tiles(R, W, k, ranks, cdf=None):
    return tdrk.StripeTiles(_t(R), _t(W), None, k, U_REG, I_REG, True, True,
                            ranks=ranks, pois_cdf=None if cdf is None
                            else _t(cdf))


def test_masked_cpu_route_is_the_plain_version_and_checks_ranks():
    """rows_epoch with rank masks on CPU tensors runs dense_sweep_rows with
    the visits' Q drawn from the staged CDF table (no launch); ranks out of
    [1, k], or not int32, are refused when the object is built."""
    u3, i_tab, R, W, _, orders = _stripes("float_w_int8", seed=26)
    NU, bu, k = u3.shape
    Lu, Li = _lambdas(np.random.default_rng(27), NU, bu, i_tab.shape[0], k)
    cdf, u = _poisson(k, NU, 28)
    Q = tdbk.visit_quantiles(_t(cdf), _t(u))
    before = tdrk.StripeTiles.launches
    tiles = _masked_tiles(R, W, k, (_t(Lu), _t(Li)), cdf)
    got = tiles.rows_epoch(_t(u3), _t(i_tab), _t(orders[0]), LR, _t(u))
    want = tdbk.dense_sweep_rows(_t(u3), _t(i_tab), _t(orders[0]), LR, _t(R),
                                 _t(W), U_REG, I_REG, True, True, Lu3=_t(Lu),
                                 Li=_t(Li), Q=Q)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tdrk.StripeTiles.launches == before
    for bad in ((_t(Lu) * 0, _t(Li)), (_t(Lu), _t(Li) + k),
                (_t(Lu).long(), _t(Li))):
        with pytest.raises(ValueError, match="ranks"):
            _masked_tiles(R, W, k, bad, cdf)


@pytest.mark.parametrize("bad,match", [
    ("lu_below_1", "lie in"), ("li_above_k", "lie in"),
    ("cdf_column_rises", "do not increase"), ("cdf_shape", "pois_cdf"),
    ("cdf_without_ranks", "rank masks take"), ("rank_shape", "ranks must"),
    ("w_shape", "W tiles must"), ("cell_count", "cell tiles must"),
    ("ranks_on_cells", "rank masks take")])
def test_construction_rejects_ranks_and_tiles_that_do_not_fit(bad, match):
    """Everything an epoch of the stripe kernel reads besides the tables
    and the order is checked once, when the object is built: rank tables
    in [1, k] (a Q row's lookup index), a CDF table whose columns do not
    increase down its rows (every visit's rank row then nondecreasing),
    rank tables, weights and cell counts that fit the tiles."""
    _, i_tab, R, W, _, _ = _stripes("float_w_int8", seed=29)
    NU, bu, ni = R.shape
    k = 6
    Lu, Li = _lambdas(np.random.default_rng(30), NU, bu, ni, k)
    cdf, _ = _poisson(k, NU, 31)
    if bad == "lu_below_1":
        Lu[1, 2] = 0
    elif bad == "li_above_k":
        Li[3] = k + 1
    elif bad == "cdf_column_rises":
        cdf[2, 1] = cdf[1, 1] + 1e-3   # row lam = 3 above lam = 2
    kw = dict(ranks=(_t(Lu), _t(Li)), pois_cdf=_t(cdf))
    tiles, w = _t(R), _t(W)
    if bad == "cdf_shape":
        kw["pois_cdf"] = _t(cdf[:-1])
    elif bad == "cdf_without_ranks":
        kw["ranks"] = None
    elif bad == "rank_shape":
        kw["ranks"] = (_t(Lu[:, :-1].copy()), _t(Li))
    elif bad == "w_shape":
        w = w[:, :, :-1].contiguous()
    elif bad == "cell_count":   # NU * NI + 1 cells: 5 tiles are not for NI 3
        kw = dict(NI=3)
    elif bad == "ranks_on_cells":
        tiles, w = tiles[:4].contiguous(), w[:4].contiguous()
        kw["NI"] = 3
    with pytest.raises(ValueError, match=match):
        tdrk.StripeTiles(tiles, w, None, k, U_REG, I_REG, True, True, **kw)


def test_an_epoch_refuses_a_non_permutation_order_and_leaves_the_tables():
    """Each stripe once an epoch: an order that repeats a stripe or leaves
    the range is refused before anything moves; the same object then runs
    a permutation as the plain version does."""
    u3, i_tab, R, W, _, orders = _stripes("float_w_int8", seed=32)
    NU, _, k = u3.shape
    tiles = tdrk.StripeTiles(_t(R), _t(W), None, k, U_REG, I_REG, True, True)
    ut, it = _t(u3), _t(i_tab)
    for bad in (torch.tensor([0, 0, 1, 2, 3]), torch.arange(1, NU + 1),
                torch.arange(NU - 1), torch.arange(NU).view(1, NU),
                torch.arange(NU, dtype=torch.float32)):
        with pytest.raises(ValueError, match="row_order"):
            tiles.rows_epoch(ut, it, bad, LR)
        assert torch.equal(ut, _t(u3)) and torch.equal(it, _t(i_tab))
    got = tiles.rows_epoch(ut, it, _t(orders[0]), LR)
    want = tdbk.dense_sweep_rows(_t(u3), _t(i_tab), _t(orders[0]), LR, _t(R),
                                 _t(W), U_REG, I_REG, True, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
