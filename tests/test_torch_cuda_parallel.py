"""The port's mesh engines on the card (matfac_tpu_torch.parallel): a
shard-round of each kernel path (the stripe entry of csrc/dense_rows.cu
under DenseBlockDSGDSolver, the diag entry of csrc/block_sgd.cu under
BlockDSGDSolver) against its plain version on the same CUDA tensors, the
scatter DSGD and the sharded top-N against the CPU, and a 2-process gloo
run with both processes' shards on the one card equal to a 1-process run
bit for bit (the dense path, whose kernel is deterministic, the scatter
DSGD, whose sums take a fixed order, and ALS, iALS++ and dense ALS under
train_model(mesh=...)). Every test
here is marked ``cuda`` and skips without a CUDA device. This file imports
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from matfac_tpu_torch import Params
from matfac_tpu_torch.data.synthetic import synthetic_data
from matfac_tpu_torch.eval.ranking import CatalogScorer
from matfac_tpu_torch.models.base import ModelMF, init_state
from matfac_tpu_torch.ops import block_sgd_kernel as bsk
from matfac_tpu_torch.ops import dense_row_kernel as drk
from matfac_tpu_torch.ops.dense_block_kernel import dense_sweep_rows
from matfac_tpu_torch.parallel.block_dsgd import (BlockDSGDSolver,
                                                  DenseBlockDSGDSolver)
from matfac_tpu_torch.parallel.dsgd import DSGDShardedSolver
from matfac_tpu_torch.parallel.mesh import make_mesh
from matfac_tpu_torch.utils import freq

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_mesh_worker import (COORD_MODES, problem, small_batches,  # noqa: E402,E501
                               train, train_coord)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card's "
                    "shard-rounds against their plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _setup(n_shards=4):
    dev = _cuda()
    data, _, _ = synthetic_data(n_users=600, n_items=400, k=4, density=0.2,
                                seed=9, noise=0.05, nonneg=True)
    p = Params(fac_dim=32, u_reg=0.01, i_reg=0.01, learn_rate=0.05, seed=5)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    mesh = make_mesh((n_shards,), ("u",), devices=[dev] * n_shards)
    return dev, data, p, ModelMF(p, data.n_users, data.n_items), iu, ii, mesh


def _close(got, want, rtol, atol):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("codes", [False, True])
def test_dense_shard_round_kernel_vs_plain(mm_bf16, codes):
    """One shard-round of the stripe entry (its SU stripes against the held
    item block) against dense_sweep_rows on the same tensors: rtol 1e-3 /
    atol 1e-5; launches 2 a stripe (+1 bf16 copy of U)."""
    dev, data, p, model, iu, ii, mesh = _setup()
    mat = data.train_mat
    if codes:
        mat = mat.copy()
        mat.values[:] = (np.clip(np.round(mat.values / 0.5), 1, 10)
                         * 0.5).astype(np.float32)
    s = DenseBlockDSGDSolver(model, p, mat, iu, ii, mesh, sub_bu=32,
                             mm_bf16=mm_bf16,
                             dense_codes="codes" if codes else "off")
    assert (s.W_tiles is None) == codes
    u_blk, i_blk = s.stage_factors(init_state(p, data.n_users, data.n_items,
                                              device=dev))
    order = torch.randperm(s.SU, generator=torch.Generator().manual_seed(1))
    for j, t in ((0, 0), (3, 2)):
        tiles = s.stripes[j][t]
        R, W = tiles.R, tiles.W
        assert R.data_ptr() == s.R_tiles[j][t].data_ptr()   # views, staged
        U = u_blk[j].view(s.SU, s.sub_bu, -1)
        drk.StripeTiles.launches = 0
        got = tiles.rows_epoch(U.clone(), i_blk[j].clone(), order, 0.05)
        assert drk.StripeTiles.launches == drk.epoch_launches(
            s.SU, p.fac_dim, mm_bf16)
        want = dense_sweep_rows(U.clone(), i_blk[j].clone(), order, 0.05, R,
                                W, p.u_reg, p.i_reg, s.collision_norm,
                                mm_bf16, r_scale=s.r_scale)
        _close(got, want, 1e-3, 1e-5)


@pytest.mark.cuda
def test_block_shard_round_kernel_vs_plain():
    """One shard-round of the diag entry (one launch; a dummy user
    sub-block's lanes skipped) against block_sweep_diag: rtol 1e-3 /
    atol 1e-5 (bf16 operands)."""
    dev, data, p, model, iu, ii, mesh = _setup()
    s = BlockDSGDSolver(model, p, data.train_mat, iu, ii, mesh, sub_bu=64,
                        sub_bi=32, batch_size=64)
    u_blk, i_blk = s.stage_factors(init_state(p, data.n_users, data.n_items,
                                              device=dev))
    sched = bsk.diag_schedule(torch.Generator().manual_seed(2), s.SU, s.SI,
                              s.S // s.bs)
    assert int((sched[0] == s.SU).sum()) > 0       # dummy lanes present
    args = (*sched, 0.05, *s.streams(1, 3))
    bsk.reset_counts(bsk.block_sgd_diag_epoch)
    got = bsk.block_sgd_diag_epoch(u_blk[1].clone(), i_blk[1].clone(), *args,
                                   **s.sweep_kwargs(), slices=s.slices[1][3])
    assert bsk.block_sgd_diag_epoch.launches == 1
    want = bsk.block_sweep_diag(u_blk[1].clone(), i_blk[1].clone(), *args,
                                **s.sweep_kwargs())
    _close(got, want, 1e-3, 1e-5)


@pytest.mark.cuda
def test_dsgd_epoch_on_card_matches_cpu():
    """The scatter DSGD epoch (plain PyTorch) on the card against the CPU on
    one schedule: rtol 1e-4 / atol 1e-6 (the card's products and
    reductions round in another order)."""
    dev, data, p, model, iu, ii, mesh = _setup()
    cpu_mesh = make_mesh((4,), ("u",), devices=[torch.device("cpu")] * 4)
    s_card = DSGDShardedSolver(model, p, data.train_mat, iu, ii, mesh,
                               batch_size=256)
    s_cpu = DSGDShardedSolver(model, p, data.train_mat, iu, ii, cpu_mesh,
                              batch_size=256)
    sched = s_cpu.draw_schedule()
    st = init_state(p, data.n_users, data.n_items, device="cpu")
    got = s_card.epoch_with(type(st)(*(t.to(dev) for t in st)), 0.005,
                            sched)
    want = s_cpu.epoch_with(st, 0.005, sched)
    assert bool(torch.isfinite(want.u_fac).all())
    _close((got.u_fac.cpu(), got.i_fac.cpu()), (want.u_fac, want.i_fac),
           1e-4, 1e-6)


@pytest.mark.cuda
def test_sharded_topk_on_card_equals_one_device():
    """CatalogScorer(mesh=) through csrc/topk.cu on 4 shards of the card:
    the ids, HR@10 and ARHR@10 of one device exactly."""
    dev, data, p, model, iu, ii, mesh = _setup()
    st = init_state(p, data.n_users, data.n_items, device=dev)
    view = model.eval_view(st)
    sc1 = CatalogScorer(data.train_mat, iu, ii, data.n_users, data.n_items,
                        user_block=64, mesh=mesh)
    sc0 = CatalogScorer(data.train_mat, iu, ii, data.n_users, data.n_items,
                        user_block=64, device=dev)
    assert torch.equal(sc1._topk_dev(view, 10)[1], sc0._topk_dev(view, 10)[1])
    assert sc1.hit_rate(view, data.val_mat, 10) == \
        sc0.hit_rate(view, data.val_mat, 10)
    assert sc1.arhr(view, data.test_mat, 10) == \
        sc0.arhr(view, data.test_mat, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense_float", "dense_codes", "dsgd",
                                  "tmfdropout", "als", "ialspp",
                                  "alsdense"])
def test_two_process_run_on_one_card(tmp_path, monkeypatch, mode):
    """Two gloo processes, 4 of the 8 shards each, all on the one card (the
    item blocks, or the coordinate solvers' solved rows, exchanged through
    host memory): the factors one process trains on the card, bit for
    bit."""
    dev = _cuda()
    worker = os.path.join(HERE, "torch_mesh_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + env.get("PYTHONPATH", "").split(os.pathsep))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, worker, port, str(i), str(tmp_path), mode, "cuda"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i}:\n{outs[i]}"
    multi = np.load(str(tmp_path / f"multi_{mode}.npz"))
    data, params, model_fn, solver_fn = problem(mode)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    mesh = make_mesh((8,), ("u",), devices=[dev] * 8)
    if mode in COORD_MODES:
        small_batches(monkeypatch.setattr)
        rep = train_coord(data, params, mode, mesh)
        assert np.array_equal(rep.state.u_fac.cpu().numpy(), multi["u_fac"])
        assert np.array_equal(rep.state.i_fac.cpu().numpy(), multi["i_fac"])
        return
    solver = solver_fn(model_fn(), data.train_mat, iu, ii, mesh)
    state = train(solver, params, data.n_users, data.n_items, dev=dev)
    assert np.array_equal(state.u_fac.cpu().numpy(), multi["u_fac"])
    assert np.array_equal(state.i_fac.cpu().numpy(), multi["i_fac"])
