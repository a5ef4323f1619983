"""One process of a 2-process gloo run of the port's mesh solvers.

Both processes build an 8-shard CPU mesh (4 shards each), load only their
host-local rating rows (``distributed.host_local_ratings``), build the
solver of ``mode`` (which stages only its own shards' cells) and train two
epochs; rank 0 writes the gathered factors to ``<out_dir>/multi_<mode>.npz``
for comparison with one process running the same problem. Mode "block"
also round-trips the trained state through ``save_sharded`` /
``restore_sharded`` with both processes taking part.

The coordinate modes (als, ialspp, alsdense) train through
``train_model(mesh=...)`` from the host-local rows instead: each process
gathers the whole train matrix, solves its share of each half-sweep's rows
and all-gathers the rest (``small_batches`` cuts the dense solver's row
blocks small enough that both processes solve rows of every side).

Usage: python torch_mesh_worker.py <port> <rank> <out_dir> <mode> [dev]
(mode: dsgd, tmfdropout, block, dense_float, dense_codes, als, ialspp,
alsdense; dev: cpu, the default, or cuda: both processes' shards on the
one card, the tables and tiles on it, the exchange through host memory)
"""

import copy
import os
import sys

COORD_MODES = ("als", "ialspp", "alsdense")


def small_batches(setattr_):
    """Cut the dense ALS solver's row blocks to 16 rows, so that both
    processes solve some (the bucketed solvers' batches, a bucket each
    here, already fall to both); ``setattr_`` is ``setattr`` or pytest's
    ``monkeypatch.setattr``."""
    from matfac_tpu_torch.solvers import als
    from matfac_tpu_torch.train import loop

    class Dense16(als.DenseALSSolver):
        def __init__(self, *a, **kw):
            super().__init__(*a, row_block=16, **kw)
    setattr_(loop, "DenseALSSolver", Dense16)


def solved_per_process(solver):
    """How many user rows (bucketed) or user row blocks (dense) each
    process solves a sweep."""
    if hasattr(solver, "_runs"):
        return [len(r) for r in solver._runs[0]]
    return [len(i) for i in solver._solved[0]]


def train_coord(data, params, mode, mesh):
    """train_model(algo="mf", mf_method=mode, mesh=mesh) for 2 epochs;
    returns the report."""
    from matfac_tpu_torch.train.loop import train_model
    rep, *_ = train_model(data, params.replace(max_iter=2), algo="mf",
                          mf_method=mode, mesh=mesh, log_fn=lambda s: None)
    return rep


def problem(mode):
    """(data, params, model_fn, solver_fn): the worker's problem, shared
    with the single-process reference in tests/test_torch_parallel.py."""
    import numpy as np

    from matfac_tpu_torch.config import Params
    from matfac_tpu_torch.data.synthetic import synthetic_data
    from matfac_tpu_torch.models.base import ModelMF
    from matfac_tpu_torch.models.longtail import ModelPoissonDropout
    from matfac_tpu_torch.parallel.block_dsgd import (BlockDSGDSolver,
                                                      DenseBlockDSGDSolver)
    from matfac_tpu_torch.parallel.dsgd import DSGDShardedSolver
    from matfac_tpu_torch.utils import freq as ufreq

    data, _, _ = synthetic_data(n_users=64, n_items=48, k=3, density=0.3,
                                seed=11, noise=0.05, nonneg=True)
    if mode == "dense_codes":
        m = data.train_mat
        m.values[:] = (np.clip(np.round(m.values / 0.5), 1, 10)
                       * 0.5).astype(np.float32)
    params = Params(fac_dim=3, u_reg=0.02, i_reg=0.02, learn_rate=0.03,
                    batch_size=16 if mode == "block" else 32, seed=3)
    n, m = data.n_users, data.n_items

    def model_fn():
        if mode == "tmfdropout":
            uf, itf = ufreq.row_col_freq(data.train_mat)
            return ModelPoissonDropout(
                params.replace(rho_rms=1.0, alpha=0.0), n, m,
                np.pad(uf, (0, n - len(uf))), np.pad(itf, (0, m - len(itf))))
        return ModelMF(params, n, m)

    def solver_fn(model, mat, iu, ii, mesh):
        if mode in ("dsgd", "tmfdropout"):
            return DSGDShardedSolver(model, params, mat, iu, ii, mesh)
        if mode == "block":
            return BlockDSGDSolver(model, params, mat, iu, ii, mesh,
                                   sub_bu=8, sub_bi=4, batch_size=16)
        return DenseBlockDSGDSolver(
            model, params, mat, iu, ii, mesh, sub_bu=8, mm_bf16=False,
            dense_codes="codes" if mode == "dense_codes" else "off")

    return data, params, model_fn, solver_fn


def train(solver, params, n_users, n_items, epochs=2, dev="cpu"):
    import torch

    from matfac_tpu_torch.models.base import init_state
    state = init_state(params, n_users, n_items,
                       generator=torch.Generator().manual_seed(7),
                       device=dev)
    for _ in range(epochs):
        state = solver.epoch(state, params.learn_rate)
    return state


def main():
    port, rank, out_dir, mode = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                                 sys.argv[4])
    dev = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from matfac_tpu_torch.data.csr import RatingMatrix
    from matfac_tpu_torch.parallel import distributed
    from matfac_tpu_torch.parallel.mesh import make_mesh
    from matfac_tpu_torch.train import checkpoint as ck
    from matfac_tpu_torch.utils import freq as ufreq

    distributed.initialize(f"tcp://127.0.0.1:{port}", world_size=2,
                           rank=rank, backend="gloo")
    data, params, model_fn, solver_fn = problem(mode)
    n_users, n_items = data.n_users, data.n_items
    iu, ii = ufreq.invalid_users_items(data.train_mat, n_users, n_items)
    # this process keeps ONLY the rows of its 4 user blocks
    r, c, v = distributed.host_local_ratings(data.train_mat, n_users, 2,
                                             rank)
    local_mat = RatingMatrix.from_coo(r, c, v, n_users, n_items)
    mesh = make_mesh((8,), ("u",), devices=[torch.device(dev)] * 4)
    if mode in COORD_MODES:
        small_batches(setattr)
        local = copy.copy(data)
        local.train_mat = local_mat
        rep = train_coord(local, params, mode, mesh)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"multi_{mode}.npz"),
                     u_fac=rep.state.u_fac.cpu().numpy(),
                     i_fac=rep.state.i_fac.cpu().numpy(),
                     solved=solved_per_process(rep.solver))
        distributed.barrier()
        torch.distributed.destroy_process_group()
        print("WORKER_OK", rank)
        return
    solver = solver_fn(model_fn(), local_mat, iu, ii, mesh)
    assert solver.local_blocks == list(range(4 * rank, 4 * rank + 4)), \
        solver.local_blocks
    state = train(solver, params, n_users, n_items, dev=dev)
    if rank == 0:
        np.savez(os.path.join(out_dir, f"multi_{mode}.npz"),
                 u_fac=state.u_fac.cpu().numpy(),
                 i_fac=state.i_fac.cpu().numpy())
    if mode == "block":
        path = os.path.join(out_dir, "sharded_ckpt")
        ck.save_sharded(path, state, epoch=np.int64(2))
        restored, extra = ck.restore_sharded(path, state)
        assert int(extra["epoch"]) == 2
        for a, b in zip(restored, state):
            assert torch.equal(a, b)
        assert sorted(os.listdir(path)) == ["manifest.pt", "rows_0.pt",
                                            "rows_1.pt"]
        print("CKPT_OK", rank)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank)


if __name__ == "__main__":
    main()
