"""Hyperparameter configuration (the port's own copy of
matfac_tpu/config.py, field for field and default for default;
tests/test_torch_data.py holds the two together).

Analog of the reference's ``Params`` bag (datastruct.h:12-69) plus the
knobs a batched implementation needs (batch size, eval block sizes,
dtype, mesh shape).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Params:
    """All run hyperparameters.

    Mirrors the reference's datastruct.h:12-69 field-for-field where the
    field is algorithmic; file paths and TPU-execution knobs are extras.
    """

    # --- core dimensions (filled by Data if -1) ---
    n_users: int = -1
    n_items: int = -1
    fac_dim: int = 10          # latent rank k
    max_iter: int = 1000       # max epochs
    svd_fac_dim: int = 10      # rank for SVD-based init / analysis
    seed: int = 1

    # --- regularization / step size ---
    u_reg: float = 0.01
    i_reg: float = 0.01
    # frequency-scaled regularization exponent: effective per-entity
    # lambda = reg * freq^reg_exponent (ALS: exact per-row lambda;
    # SGD: per-occurrence multiplier (freq/mean_freq)^exponent). 0 =
    # the reference's flat lambda. Covers the othersrc
    # marginal-weighted-reg experiments (modelMFWtReg/WtRegArb) and
    # the iALS scaled-lambda family.
    reg_exponent: float = 0.0
    learn_rate: float = 0.005

    # --- long-tail model knobs (WWW'19) ---
    rho_rms: float = 1.0       # sigmoid steepness (TMF) / weight scale (IFWMF)
    alpha: float = 0.0         # sigmoid center (TMF)

    # --- sgdparsvd singular-value regularization (modelMF.cpp:371) ---
    # per-dim reg = (sing_a + 1) / (sing_b + sigma_k); None falls back
    # to u_reg/i_reg (the round-1 proxy, kept as the default)
    sing_a: Optional[float] = None
    sing_b: Optional[float] = None

    # --- file paths (GKlib text CSR format unless noted) ---
    train_mat_file: Optional[str] = None
    test_mat_file: Optional[str] = None
    val_mat_file: Optional[str] = None
    graph_mat_file: Optional[str] = None
    orig_u_fac_file: Optional[str] = None
    orig_i_fac_file: Optional[str] = None
    init_u_fac_file: Optional[str] = None
    init_i_fac_file: Optional[str] = None
    prefix: str = "mf"

    # --- TPU execution knobs (new; no reference analog) ---
    batch_size: int = 16384        # SGD minibatch (COO examples per step)
    # scale colliding same-entity gradients within a batch to their
    # mean (stability on power-law data; solvers/sgd.py docstring)
    sgd_collision_norm: bool = True
    eval_user_block: int = 1024    # users per block in full-catalog scoring
    eval_item_block: int = 32768   # items per block in full-catalog
    # scoring (one block = the rated-exclusion scatter issues once;
    # blocks beyond ~32k trade scores-array HBM for scatter re-issues)
    dtype: str = "float32"         # factor dtype ("float32" or "bfloat16")
    mesh_shape: Tuple[int, ...] = ()   # () = single device
    mesh_axes: Tuple[str, ...] = ()
    n_negatives: int = 2           # BPR: sampler tries per positive
    # (first-try acceptance >90%; failures drop the pair — the
    # reference's own 100-try failure handling, modelMFBPR.cpp:227-241)
    bpr_sampler: str = "rankgap"   # "rankgap" (1 gather/try; PERF.md)
    # or "gap" (literal per-try trainItems rejection)
    bpr_engine: str = "stream"     # "stream" (per-pair scatter engine)
    # or "dense" (stripe score panels, 4 index streams/pair —
    # solvers/bpr_dense.py; plain BPR only, rank-masked hybrids fall
    # back to stream with a log line)
    ccd_group_dims: int = 1        # CCD++: rank-g block sweeps
    # (g dims solved jointly per sweep — README deviation #14;
    # per-dim index streams drop ~g-fold, solvers/ccd.py)

    # --- training-loop constants (reference const.h:4-8) ---
    obj_iter: int = 1      # OBJ_ITER: check objective every N epochs
    disp_iter: int = 50    # DISP_ITER: log every N epochs
    save_iter: int = 50    # SAVE_ITER: checkpoint every N epochs
    chance_iter: int = 500  # CHANCE_ITER: give up after N stagnant epochs
    eps: float = 1e-5      # EPS: objective-convergence threshold

    def display(self) -> str:
        """Reference parity: Params::display (datastruct.h:52-69)."""
        lines = ["*** PARAMETERS ***"]
        for f in dataclasses.fields(self):
            lines.append(f"{f.name}: {getattr(self, f.name)}")
        return "\n".join(lines)

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)
