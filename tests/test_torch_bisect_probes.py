"""The port's toolchain probes (matfac_tpu_torch.ops.bisect_probes, on the
CPU their plain versions) against the Pallas constructs of
scripts/tpu_pallas_bisect.py, run here in interpret mode on the same numpy
inputs. The script builds its kernels inside ``main()``; each is restated
below as written there (stages 1-5). Every input makes the result exact in
f32, so the two agree exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from matfac_tpu_torch.ops import bisect_probes as bp


def _k1(x_ref, o_ref):
    o_ref[:, :] = x_ref[:, :] + 1.0


def _k2(a_ref, b_ref, o_ref):
    o_ref[:, :] = jnp.dot(a_ref[:, :], b_ref[:, :],
                          preferred_element_type=jnp.float32)


def _k3(bs, rows):
    def kernel(u_ref, g_ref, tab_ref, o_ref):
        iota = jax.lax.broadcasted_iota(jnp.int32, (bs, rows), 1)
        oh = (u_ref[0, :][:, None] == iota).astype(jnp.bfloat16)
        upd = jnp.dot(oh.T, g_ref[:, :].astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
        o_ref[:, :] = tab_ref[:, :] + upd
    return kernel


def _k4(sel_ref, x_ref, o_ref):
    o_ref[:, :] = x_ref[:, :] * 2.0


def _k5(n_slices, rows):
    def kernel(x_ref, o_ref):
        o_ref[:, :] = x_ref[:, :]

        def body(j, carry):
            blk = o_ref[pl.ds(j * rows, rows), :]
            o_ref[pl.ds(j * rows, rows), :] = blk + 1.0
            return carry

        jax.lax.fori_loop(0, n_slices, body, 0)
    return kernel


def _pallas(stage, args):
    """The JAX probe of ``stage`` on numpy ``args``, interpret mode."""
    a = [jnp.asarray(x) for x in args if isinstance(x, np.ndarray)]
    f32 = jnp.float32
    if stage == "1 elementwise":
        return pl.pallas_call(_k1, out_shape=jax.ShapeDtypeStruct(
            a[0].shape, f32), interpret=True)(*a)
    if stage == "2 grid matmul":
        return pl.pallas_call(
            _k2, grid=(2,),
            in_specs=[pl.BlockSpec((128, 256), lambda i: (i, 0)),
                      pl.BlockSpec((256, 256), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((128, 256), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((256, 256), f32),
            interpret=True)(*a)
    if stage == "3 batch update":
        ids, g, tab = a
        return pl.pallas_call(
            _k3(ids.shape[0], tab.shape[0]),
            out_shape=jax.ShapeDtypeStruct(tab.shape, f32),
            interpret=True)(ids[None, :], g, tab)
    if stage == "4 scalar prefetch":
        gs = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(4,),
            in_specs=[pl.BlockSpec((1, 128, 128), lambda t, s: (s[t], 0, 0))],
            out_specs=pl.BlockSpec((1, 128, 128),
                                   lambda t, s: (s[t], 0, 0)))
        return pl.pallas_call(_k4, grid_spec=gs, out_shape=jax.ShapeDtypeStruct(
            a[1].shape, f32), interpret=True)(*a)
    n_slices = args[1]
    return pl.pallas_call(
        _k5(n_slices, a[0].shape[0] // n_slices),
        out_shape=jax.ShapeDtypeStruct(a[0].shape, f32),
        interpret=True)(a[0])


@pytest.mark.parametrize("stage", ["1 elementwise", "2 grid matmul",
                                   "3 batch update", "4 scalar prefetch",
                                   "5 slice loop"])
def test_probe_plain_route_matches_pallas_interpret(stage):
    """Each probe on CPU tensors runs its plain version, launches nothing,
    and equals the Pallas probe exactly."""
    fn, plain, args = bp.stage_inputs(torch.Generator().manual_seed(0),
                                      "cpu")[stage]
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before
    assert torch.equal(got, plain(*args))
    want = _pallas(stage, [a.numpy() if torch.is_tensor(a) else a
                           for a in args])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_probes_refuse_what_they_cannot_take():
    x = torch.zeros((4, 8, 8))
    with pytest.raises(ValueError, match="permutation"):
        bp.prefetch_double(torch.tensor([0, 0, 1, 2], dtype=torch.int32), x)
    with pytest.raises(ValueError, match="float32"):
        bp.add_one(x.double())
    with pytest.raises(ValueError, match="ids must lie"):
        bp.batch_update(torch.tensor([9], dtype=torch.int32),
                        torch.zeros((1, 8)), torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="equal slices"):
        bp.slice_loop(torch.zeros((10, 4)), 3)
