"""Multi-device DSGD on a mesh, on the port (the counterpart of
examples/multichip_dsgd.py).

The factor tables are cut into N row blocks, one a shard; each epoch runs
N rounds in which shard i updates its user block against item block
(i + t) mod N, then passes its item block to its left neighbour
(``parallel/dsgd.py``, the redesign of trainSGDPar, modelMF.cpp:154-350).
With several cards each shard is one card. Here the mesh holds 8 shards
of the one card (or of the CPU with ``--cpu``), which run their rounds one
after another: the same program and the same numbers.

    python examples/torch_multichip_dsgd.py [--cpu] [--shards 8]

For a run across processes, each process calls
``matfac_tpu_torch.parallel.distributed.initialize(...)`` (or runs under
torchrun) and loads only its own user rows with ``host_local_ratings``:
tests/torch_mesh_worker.py is a complete two-process example in which no
process holds the whole rating stream.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--shards", type=int, default=8)
    a = ap.parse_args()
    if not a.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    dev = torch.device("cpu" if a.cpu else "cuda")

    from matfac_tpu_torch.config import Params
    from matfac_tpu_torch.data.synthetic import low_rank_ratings
    from matfac_tpu_torch.eval.metrics import Evaluator
    from matfac_tpu_torch.models.base import ModelMF, init_state
    from matfac_tpu_torch.parallel.dsgd import DSGDShardedSolver
    from matfac_tpu_torch.parallel.mesh import make_mesh
    from matfac_tpu_torch.utils import freq

    n_users, n_items, k = 4096, 2048, 16
    mat, _, _ = low_rank_ratings(n_users, n_items, k=4, density=0.02,
                                 seed=0, noise=0.05, power_law=0.5,
                                 nonneg=True)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    params = Params(fac_dim=k, u_reg=0.01, i_reg=0.01, learn_rate=0.002,
                    seed=0)
    model = ModelMF(params, n_users, n_items)
    mesh = make_mesh((a.shards,), ("u",), devices=[dev] * a.shards)
    print(f"mesh: {a.shards} shards of "
          f"{'the CPU' if a.cpu else torch.cuda.get_device_name(0)}")
    solver = DSGDShardedSolver(model, params, mat, iu, ii, mesh,
                               balance_items=True)
    state = init_state(params, n_users, n_items, device=dev)

    class _D:     # the Data bundle the Evaluator reads
        train_mat, test_mat, val_mat = mat, None, None

    _D.n_users, _D.n_items = n_users, n_items
    ev = Evaluator(_D, iu, ii, params, dev)
    lr = params.learn_rate
    for epoch in range(12):
        state = solver.epoch(state, lr)
        lr *= 0.95   # the full TrainLoop adds NaN rollback and halving
        r = ev.rmse(model.eval_view(state), "train")
        print(f"epoch {epoch}: train RMSE {r:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
