"""``fused_cell_update`` (matfac_tpu_torch.ops.sgd_kernel) against the JAX
Pallas kernel in interpret mode: one DSGD cell's whole stream applied in
minibatches to its two resident factor blocks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matfac_tpu.ops.sgd_kernel import fused_cell_update as j_fused
from matfac_tpu_torch.ops import sgd_kernel as tsk


def _case(BU, BI, k, S, seed):
    """The inputs of the JAX package's interpret-mode test: ~20% padding
    slots (w = 0), ids drawn with repeats."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BU, k)).astype(np.float32) * 0.1,
            rng.standard_normal((BI, k)).astype(np.float32) * 0.1,
            rng.integers(0, BU, S).astype(np.int32),
            rng.integers(0, BI, S).astype(np.int32),
            rng.standard_normal(S).astype(np.float32),
            (rng.random(S) > 0.2).astype(np.float32))


@pytest.mark.parametrize("BU,BI,k,S,bs", [(32, 24, 8, 64, 16),
                                          (8, 8, 32, 96, 32),
                                          (64, 48, 16, 256, 256)])
def test_fused_cell_update_matches_jax_interpret(BU, BI, k, S, bs):
    """atol 1e-5, the tolerance of the JAX package's own test of this
    kernel against plain jnp."""
    args = _case(BU, BI, k, S, seed=S)
    lr, u_reg, i_reg = 0.05, 0.01, 0.02
    ju, ji = j_fused(*(jnp.asarray(a) for a in args), lr, bs=bs,
                     u_reg=u_reg, i_reg=i_reg, interpret=True)
    targs = [torch.from_numpy(a) for a in args]
    before = tsk.fused_cell_update.launches
    tu, ti = tsk.fused_cell_update(*targs, lr, bs, u_reg, i_reg)
    assert tsk.fused_cell_update.launches == before   # the CPU route
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
    # new blocks, as the JAX function returns; the inputs stay
    assert torch.equal(targs[0], torch.from_numpy(args[0]))
    assert not torch.equal(tu, targs[0])


def test_fused_cell_update_checks_its_inputs():
    args = [torch.from_numpy(a) for a in _case(8, 8, 4, 32, seed=0)]
    with pytest.raises(ValueError, match="multiple of bs"):
        tsk.fused_cell_update(*args, 0.05, 5, 0.01, 0.01)
    bad = args[2].clone()
    bad[3] = 8
    with pytest.raises(ValueError, match="outside"):
        tsk.fused_cell_update(args[0], args[1], bad, *args[3:], 0.05, 8,
                              0.01, 0.01)
