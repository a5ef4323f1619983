"""matfac_tpu_torch — the PyTorch / CUDA port of matfac_tpu.

Module paths mirror ``matfac_tpu``: ``matfac_tpu_torch/ops/dense_block_kernel.py``
is the counterpart of ``matfac_tpu/ops/dense_block_kernel.py`` and so on.
The port imports ``torch`` and never ``jax``. The numpy-only parts of the
JAX package (``config``, ``data``, ``utils.freq``) are imported, not
copied.

Slices covered so far: plain MF trained by the row-dense stripe SGD engine
(``train.loop.train_model(algo="mf", mf_method="densesgd")``), whose stripe
update runs as a hand-written CUDA kernel (``csrc/dense_rows.cu``); and the
ranking path, BPR trained with model selection on val HR@10
(``train_model(algo="bpr")``), ranking eval (``eval.ranking``) and serving
(``serving.Recommender``), whose full-catalog top-N runs as a hand-written
CUDA kernel (``csrc/topk.cu``). Each kernel runs on a CUDA tensor, its
plain PyTorch version on a CPU tensor.
"""

from matfac_tpu.config import Params
from matfac_tpu.data.csr import RatingMatrix
from matfac_tpu.data.dataset import Data
from matfac_tpu.data.io import split_train_test_val
from matfac_tpu.data.synthetic import low_rank_ratings

__all__ = ["Params", "RatingMatrix", "Data", "split_train_test_val",
           "low_rank_ratings"]
