"""A run with the timed path broken underneath, the harness's look for a
card skipped: ``correct`` has to come out false, once for each fault the
cell can have (one chip: no exchange between chips to leave out)."""

import pytest

from benchmark.tests import _tiny

# a step that returns its state unchanged
UNCHANGED = {
    "ml20m-mf-densesgd": """
from matfac_tpu_torch.solvers import block_sgd
block_sgd.BlockSGDSolver.epoch = lambda self, state, lr: state
""",
    "ml20m-mf-sgd": """
from matfac_tpu_torch.solvers import sgd
sgd.SGDSolver.epoch = lambda self, state, lr: state
""",
    "ml10m-bpr-train": """
from matfac_tpu_torch.solvers import bpr
bpr.BPRSolver.epoch = lambda self, state, lr: state
""",
}
# half of each batch left out, the mean taken over the rest
HALF = {
    "ml20m-mf-densesgd": """
import torch
from matfac_tpu_torch.ops import dense_block_kernel as dbk
real = dbk.cell_dense_update
def half(U, I, R, W, *a, **k):
    keep = torch.arange(U.shape[0]) < U.shape[0] // 2
    R = R * keep[:, None].to(R.dtype)
    if W is not None:
        W = W * keep[:, None].to(W.dtype)
    return real(U, I, R, W, *a, **k)
dbk.cell_dense_update = half
""",
    "ml20m-mf-sgd": """
from matfac_tpu_torch.solvers import sgd
real = sgd.SGDSolver.__init__
def init(self, *a, **k):
    real(self, *a, **k)
    B = self.batch_size
    self.valid = self.valid.reshape(-1, B)
    self.valid[:, B // 2:] = 0
    self.valid = self.valid.reshape(-1)
sgd.SGDSolver.__init__ = init
""",
    "ml10m-bpr-train": """
from matfac_tpu_torch.solvers import bpr
real = bpr.BPRSolver.__init__
def init(self, *a, **k):
    real(self, *a, **k)
    B = self.batch_size
    self.pos_valid = self.pos_valid.reshape(-1, B)
    self.pos_valid[:, B // 2:] = 0
    self.pos_valid = self.pos_valid.reshape(-1)
bpr.BPRSolver.__init__ = init
""",
}
# an answer altered where it is produced
ALTERED = """
from matfac_tpu_torch import serving
real = serving.Recommender.recommend
def recommend(self, users, n=10):
    ids, scores = real(self, users, n)
    ids[:, 0] = (ids[:, 0] + 1) % self._scorer.n_items
    return ids, scores
serving.Recommender.recommend = recommend
"""
FAULTS = ([(c, "unchanged", p) for c, p in UNCHANGED.items()]
          + [(c, "half_batch", p) for c, p in HALF.items()]
          + [(c, "altered", ALTERED) for c in ("ml10m-bpr-serve-1user",
                                               "ml10m-bpr-serve-256users")])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny.tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,fault,patch", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(tiny, cell, fault, patch):
    rc, out, err = _tiny.run(tiny, ["--workload", cell, "--seed", "77",
                                    "--seconds", "0.3"], patch)
    assert rc == 0, err[-3000:]
    res = _tiny.result(out)
    assert res["correct"] is False, res["checks"]
