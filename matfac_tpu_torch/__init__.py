"""matfac_tpu_torch — the PyTorch / CUDA port of matfac_tpu.

Module paths mirror ``matfac_tpu``: ``matfac_tpu_torch/ops/dense_block_kernel.py``
is the counterpart of ``matfac_tpu/ops/dense_block_kernel.py`` and so on.
The port imports ``torch`` and never ``jax``, and nothing of
``matfac_tpu``: it keeps its own copies of the numpy-only modules it needs
(``config``, ``data``, ``utils.freq``).

Slices covered so far: plain MF and IFWMF trained by the row-dense stripe
SGD engine (``train.loop.train_model(algo="mf" or "ifwmf",
mf_method="densesgd")``), whose stripe update runs as a hand-written CUDA
kernel on the tensor cores (``csrc/dense_rows.cu``); the one-hot cell
engine (``mf_method="blocksgd"`` for MF, IFWMF and TMF,
``csrc/block_sgd.cu``); and the ranking path, BPR trained with model
selection on val HR@10 (``train_model(algo="bpr")``), ranking eval
(``eval.ranking``) and serving (``serving.Recommender``), whose
full-catalog top-N runs as a hand-written CUDA kernel
(``csrc/topk.cu``). Each kernel runs on a CUDA tensor, its plain PyTorch
version on a CPU tensor.
"""

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.data.dataset import Data
from matfac_tpu_torch.data.io import split_train_test_val
from matfac_tpu_torch.data.synthetic import low_rank_ratings

__all__ = ["Params", "RatingMatrix", "Data", "split_train_test_val",
           "low_rank_ratings"]
