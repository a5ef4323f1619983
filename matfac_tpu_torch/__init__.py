"""matfac_tpu_torch — the PyTorch / CUDA port of matfac_tpu.

Module paths mirror ``matfac_tpu``: ``matfac_tpu_torch/ops/dense_block_kernel.py``
is the counterpart of ``matfac_tpu/ops/dense_block_kernel.py`` and so on.
The port imports ``torch`` and never ``jax``, and nothing of
``matfac_tpu``: it keeps its own copies of the numpy-only modules it needs
(``config``, ``data``, ``utils.freq``).

Slices covered so far: plain MF, IFWMF, TMF and TMF+Dropout trained by
the row-dense stripe SGD engine (``train.loop.train_model(...,
mf_method="densesgd")``), whose stripe update runs as a hand-written CUDA
kernel on the tensor cores (``csrc/dense_rows.cu``, with a rank-mask
instantiation for the truncated models); the scatter SGD engine, JAX's
default ``mf_method="sgd"`` (``solvers/sgd.py``, plain PyTorch: MF, MF
with biases and the long-tail models), and ``mf_method="auto"``; the
one-hot cell engine (``mf_method="blocksgd"`` for MF, IFWMF and TMF,
``csrc/block_sgd.cu``); and the ranking path, BPR trained with model
selection on val HR@10 (``train_model(algo="bpr")``), ranking eval
(``eval.ranking``) and serving (``serving.Recommender``), whose
full-catalog top-N runs as a hand-written CUDA kernel
(``csrc/topk.cu``); and the coordinate family for plain MF, which JAX
computes with XLA and the port with plain PyTorch: ALS (``solvers/als.py``:
bucketed, iALS++ subspace and dense masked-Gram solvers, ``mf_method``
"als", "ialspp", "alsdense", and "auto" for plain MF) and CCD / CCD++
(``solvers/ccd.py``: "ccd", "ccd++", "ccdpp", "ccd++freqadap"); the rest
of the main-directory trainers (the BPR x TMF+Poisson hybrid, the
dense-stripe BPR engine, "sgdparsvd"); and the othersrc models ("tmf_bias",
"mf_headwt", "mf_loc", "dropoutmf*", the "mf_freq" curriculum and
"increment", ``models/increment.py``) behind the reference's front door,
``python -m matfac_tpu_torch.cli`` in train mode, with its quartile
reports (``eval/quartile.py``). Each kernel runs on a CUDA tensor, its
plain PyTorch version on a CPU tensor.
"""

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.data.dataset import Data
from matfac_tpu_torch.data.io import split_train_test_val
from matfac_tpu_torch.data.synthetic import low_rank_ratings
from matfac_tpu_torch.solvers.als import (ALSSolver, DenseALSSolver,
                                          SubspaceALSSolver)
from matfac_tpu_torch.solvers.ccd import CCDPPSolver, CCDSolver

__all__ = ["Params", "RatingMatrix", "Data", "split_train_test_val",
           "low_rank_ratings", "ALSSolver", "SubspaceALSSolver",
           "DenseALSSolver", "CCDPPSolver", "CCDSolver"]
