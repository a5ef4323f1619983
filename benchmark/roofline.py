"""The yardstick's peaks and the least time of the work each cell's model
needs, whatever implements it.

The least time of some work is max(FLOPs / PEAK_FLOPS, bytes / PEAK_BYTES):
NVIDIA's published dense bf16 rate and HBM3 bandwidth of one H100 SXM
(989 TFLOP/s, 3.35 TB/s), at its full 700 W; the run prints the card's
power limit beside them. A roofline share or an ``mfu`` is this least time
over a measured time, so it cannot pass 100% unless the work is counted
too high or the time leaves part of it out.

The work is the model's, not an engine's: ``chip_smoke.py``'s ``bound_ms``
counts the dense engine's whole padded user x item grid, so a kernel that
skipped empty slots would read over 100% of it; here each rating is read
once and each factor row read and written once, so no implementation can.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12     # H100 SXM, dense bf16, FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM, HBM3, bytes/s
F32 = 4
# a rating (or positive) as the benchmark hands it to the program: an int32
# column and an f32 value of the host CSR
ENTRY_BYTES = 8
INDPTR_BYTES = 8        # an int64 row pointer a user


def least_time(flops: float, nbytes: float) -> float:
    """Seconds one H100 needs at least for this work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def bound_by(flops: float, nbytes: float) -> str:
    """Which peak bounds the work: "operations" or "bytes"."""
    return "operations" if flops / PEAK_FLOPS >= nbytes / PEAK_BYTES \
        else "bytes"


def mf_epoch_work(n_ratings: int, n_users: int, n_items: int, k: int):
    """(FLOPs, bytes) of one epoch of plain MF SGD over n_ratings ratings.
    A rating: the prediction <p_u, q_i> (2k), then on each side the data
    gradient e q_i (2k: multiply and sum into the row) and the regularized
    step p - lr (g + reg p) (2k): 10k. Each rating read once, each factor
    row read and written once in f32."""
    flops = 10.0 * k * n_ratings
    nbytes = (ENTRY_BYTES * n_ratings + INDPTR_BYTES * (n_users + 1)
              + 2 * F32 * k * (n_users + n_items))
    return flops, nbytes


def bpr_epoch_work(n_pairs: int, n_users: int, n_items: int, k: int):
    """(FLOPs, bytes) of one epoch of BPR SGD over n_pairs sampled pairs.
    A pair: r = <p_u, q_p - q_n> (3k), then for the user, the positive and
    the negative a data gradient (2k) and a regularized step (2k): 15k.
    Each positive read once as handed over (the negative is drawn, not
    read), each factor row read and written once in f32."""
    flops = 15.0 * k * n_pairs
    nbytes = (ENTRY_BYTES * n_pairs + INDPTR_BYTES * (n_users + 1)
              + 2 * F32 * k * (n_users + n_items))
    return flops, nbytes


def topn_work(n_req_users: int, n_items: int, k: int, n_excluded: int,
              n: int):
    """(FLOPs, bytes) of one top-n request over the full catalog: every
    score (2k each); the request's user rows and the item table read once,
    its users' exclusion lists read once (an int32 id an entry and the
    row's two int64 bounds), the n ids and scores written once."""
    flops = 2.0 * k * n_req_users * n_items
    nbytes = (F32 * k * (n_req_users + n_items) + 4 * n_excluded
              + 2 * INDPTR_BYTES * n_req_users + 8 * n * n_req_users)
    return flops, nbytes
