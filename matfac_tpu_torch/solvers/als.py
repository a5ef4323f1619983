"""ALS: batched normal-equation solves (port of matfac_tpu/solvers/als.py).

ModelMF::trainALS (modelMF.cpp:709-928): per user u, accumulate the Gram
YTY = sum_i q_i q_i^T and b = sum_i r_ui q_i over the rated items with
rating > 0 (the reference's explicit rating>0 gate, modelMF.cpp:820/:862),
add reg to the diagonal and solve the k x k system; then symmetrically for
the items over the column view.

Three solvers, as in JAX:
  * ``ALSSolver``: rows grouped into power-of-two degree buckets
    (``data.batching.bucketed_rows``); a bucket's Grams are one batched
    product of its gathered [nb, cap, k] rows, then one batched Cholesky
    (or warm-started CG, ``solve_spd_cg``);
  * ``SubspaceALSSolver``: the same layout, iALS++ block-coordinate sweeps
    (d x d solves over a shuffled partition of the k coordinates);
  * ``DenseALSSolver``: the gather-free form over the dense rating matrix,
    G = M @ QQ and b = Wv @ Q per row block (packed upper-triangle QQ,
    optional int8 Gram product).

Plain PyTorch on the tables' device: JAX computes ALS with XLA (einsum
Grams, batched ``cholesky`` / ``triangular_solve``, CG by ``lax.scan``),
not a Pallas kernel. ``torch.linalg.cholesky`` raises on a matrix that is
not positive definite where JAX's returns NaN; ``cholesky_ex`` is used and
a failed factor becomes NaN, so the bf16 ridge retry and the train loop's
NaN rollback see what they see in JAX. The port updates its own copies of
the factor tables in place; the state it is given is left as it was.

``split=True`` (``train_model(mesh=...)``; JAX row-shards the tables and
lets SPMD split the solve): each process solves a contiguous run of each
half-sweep's batches, balanced by work, and all-gathers the solved rows
(``parallel.distributed``). The batches stay those of one device (the
bucket chunks; the dense solver's row blocks): on the card a batched
product or factorization may sum in another order at another batch count,
so only batches of the same rows and shape give every process count the
bits of one device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.batching import RowBucket, bucketed_rows
from matfac_tpu_torch.models.base import MFState
from matfac_tpu_torch.parallel import distributed
from matfac_tpu_torch.train.profiler import count, span


def solve_spd_cg(gram: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                 iters: int, eps: float = 1e-12) -> torch.Tensor:
    """Warm-started batched conjugate gradient for SPD systems: gram
    [n, k, k], b / x0 [n, k]. With the previous factors as x0 a handful of
    iterations reaches ALS-quality solves (the iALS warm-start trick)."""
    mv = lambda x: torch.bmm(gram, x[:, :, None])[:, :, 0]
    x = x0
    r = b - mv(x0)
    p = r
    rs = (r * r).sum(dim=1)
    for _ in range(iters):
        ap = mv(p)
        alpha = rs / ((p * ap).sum(dim=1) + eps)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        rs_new = (r * r).sum(dim=1)
        beta = rs_new / (rs + eps)
        p = r + beta[:, None] * p
        rs = rs_new
    return x


def cholesky_nan(gram: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor of [n, k, k]; a matrix that is not
    positive definite gets NaN in its factor's lower triangle, as JAX's
    ``cholesky`` gives (``torch.linalg.cholesky`` would raise)."""
    chol, info = torch.linalg.cholesky_ex(gram)
    k = gram.shape[-1]
    lower = torch.ones(k, k, dtype=torch.bool, device=gram.device).tril()
    return chol.masked_fill((info > 0)[:, None, None] & lower, float("nan"))


def chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of (L L^T) x = b for [n, k, k] L and [n, k] b: two triangular
    solves, as JAX's ``triangular_solve`` pair."""
    y = torch.linalg.solve_triangular(chol, b[:, :, None], upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)[:, :, 0]


def _eye(k: int, device) -> torch.Tensor:
    return torch.eye(k, dtype=torch.float32, device=device)[None]


def _solve_bucket(target: torch.Tensor, source: torch.Tensor, ids, cols,
                  vals, mask, sel, real_ids, reg: float, cg_iters: int = 0,
                  reg_exp: float = 0.0) -> None:
    """Solve rows ``ids`` of ``target`` (in place) from their padded rated
    lists: cols / vals / mask [nb, cap]; ``sel`` indexes the bucket's real
    rows and ``real_ids`` are their ids (dummy rows' writes are dropped).
    ``reg_exp``: per-row lambda = reg * max(count, 1) ** reg_exp over the
    row's valid rated entries (iALS's scaled lambda); 0 is the reference's
    flat lambda, exactly. Spans ``als.gram`` (gather, Gram, right-hand
    side) and ``als.solve`` (factorization, solves, write-back)."""
    k = target.shape[1]
    with span("als.gram"):
        q = source[cols].float()                           # [nb, cap, k]
        w = mask * (vals > 0).to(mask.dtype)               # rating>0 gate
        # Gram: sum_c w q q^T (w is 0/1, so one-sided masking suffices)
        yty = torch.bmm((q * w[:, :, None]).mT, q)
        b = torch.bmm((vals * w)[:, None, :], q)[:, 0]
    with span("als.solve"):
        if reg_exp:
            cnt = torch.clamp_min(w.sum(dim=1), 1.0)
            yty = yty + (reg * cnt ** reg_exp)[:, None, None] \
                * _eye(k, q.device)
        else:
            yty = yty + reg * _eye(k, q.device)
        if cg_iters > 0:
            sol = solve_spd_cg(yty, b, target[ids].float(), cg_iters)
        else:
            sol = chol_solve(cholesky_nan(yty), b)
        target[real_ids] = sol[sel].to(target.dtype)


# chunk large buckets so that the gathered [nb, cap, k] block and the
# [nb, k, k] Grams stay ~<= 1 GiB each: JAX's budget in f32 elements, set
# for the TPU v5e's 16 GiB
CHUNK_ELEMS = 1 << 28


class ALSSolver:
    """Owns the bucketed row / column layouts and runs one ALS sweep per
    epoch (user pass then item pass, like modelMF.cpp:795-880).
    ``cg_iters`` > 0: warm-started CG solves; 0: exact Cholesky solves.
    ``split``: solve this process's share of the rows and all-gather the
    rest (a mesh run across processes; the module docstring says how).

    An epoch is the span ``als.epoch``; each chunk adds, to the counters
    ``als.rows`` (real rows solved), ``als.slots`` (nb x cap gathered) and
    ``als.ratings`` (rated slots), sizes fixed when it was staged."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 cg_iters: int = 0, device="cuda", split: bool = False,
                 **_):
        self.model = model
        self.params = params
        self.cg_iters = cg_iters
        self.split = split
        self.device = torch.device(device)
        self.reg_exp = float(getattr(params, "reg_exponent", 0.0))
        self.u_buckets: List[RowBucket] = bucketed_rows(
            train_mat, invalid=invalid_users)
        self.i_buckets: List[RowBucket] = bucketed_rows(
            train_mat.transpose(), invalid=invalid_items)
        k = max(model.k, 1)

        def chunks(b: RowBucket):
            max_rows = max(CHUNK_ELEMS // max(b.cap * k, k * k), 256)
            max_rows -= max_rows % 8
            for s0 in range(0, len(b.row_ids), max_rows):
                e0 = min(s0 + max_rows, len(b.row_ids))
                yield b.row_ids[s0:e0], b.cols[s0:e0], b.vals[s0:e0], \
                    b.mask[s0:e0]

        idx = lambda a: torch.from_numpy(
            np.asarray(a, np.int64)).to(self.device)

        def stage(ids, cols, vals, mask):
            # a real row has a rated entry; dummy rows are all-masked
            sel = np.nonzero(mask.sum(axis=1) > 0)[0]
            f32 = lambda a: torch.from_numpy(a).to(self.device)
            return (idx(ids), idx(cols), f32(vals), f32(mask), idx(sel),
                    idx(ids[sel]))

        def sizes(ids, cols, vals, mask):
            # (real rows, gathered slots, rated slots) of a chunk
            return (int((mask.sum(axis=1) > 0).sum()), int(mask.size),
                    int(np.count_nonzero(mask)))

        me, procs = ((distributed.process_index(),
                      distributed.process_count()) if split else (0, 1))
        self._stage, self._sizes, self._solved = [], [], []
        for bs in (self.u_buckets, self.i_buckets):
            cs = [c for b in bs for c in chunks(b)]
            # work a batch: its Gram (rows x cap x k^2) and its solve
            # (rows x k^3 / 3)
            runs = distributed.balanced_split(
                [c[1].size + len(c[0]) * k / 3 for c in cs], procs)
            self._stage.append([stage(*cs[j]) for j in runs[me]])
            self._sizes.append([sizes(*cs[j]) for j in runs[me]])
            # each process's solved rows, for the all-gather
            real = lambda c: c[0][c[3].sum(axis=1) > 0]
            self._solved.append([idx(np.concatenate(
                [real(cs[j]) for j in run] + [np.zeros(0, np.int64)]))
                for run in runs])

    def _share(self, side: int, table: torch.Tensor) -> None:
        """All-gather the rows the processes solved on ``side`` (0: users,
        1: items) into ``table``, under ``split``."""
        if self.split:
            distributed.allgather_rows(table, self._solved[side])

    def _pass(self, side: int, target: torch.Tensor, source: torch.Tensor,
              reg: float) -> None:
        """Solve ``side``'s rows of ``target`` (0: users, 1: items) from
        ``source``, chunk by chunk, then share them."""
        for chunk, (rows, slots, rated) in zip(self._stage[side],
                                               self._sizes[side]):
            _solve_bucket(target, source, *chunk, reg,
                          cg_iters=self.cg_iters, reg_exp=self.reg_exp)
            count("als.rows", rows)
            count("als.slots", slots)
            count("als.ratings", rated)
        self._share(side, target)

    def epoch(self, state: MFState, lr: float) -> MFState:
        del lr   # ALS has no step size and draws nothing
        with span("als.epoch"):
            u_fac, i_fac = state.u_fac.clone(), state.i_fac.clone()
            self._pass(0, u_fac, i_fac, float(self.params.u_reg))
            self._pass(1, i_fac, u_fac, float(self.params.i_reg))
            return state._replace(u_fac=u_fac, i_fac=i_fac)


def _subspace_solve_bucket(target: torch.Tensor, source: torch.Tensor, ids,
                           cols, vals, mask, sel, real_ids,
                           blocks: torch.Tensor, reg: float,
                           d: int) -> None:
    """One iALS++ sweep over a bucket (in place): for each coordinate
    block S (|S| = d), solve the d x d normal equations of the block with
    the other coordinates fixed (arXiv:2110.14044, explicit-feedback
    form), keeping the predictions up to date incrementally. ``blocks``
    [n_blocks, d]: the coordinates of each block, in sweep order."""
    q = source[cols].float()                               # [nb, cap, k]
    w = mask * (vals > 0).to(mask.dtype)                   # rating>0 gate
    p = target[ids]
    pred = torch.bmm(q, p.float()[:, :, None])[:, :, 0]    # [nb, cap]
    eye = reg * _eye(d, q.device)
    for S in blocks:
        qS = q[:, :, S]                                    # [nb, cap, d]
        H = torch.bmm((qS * w[:, :, None]).mT, qS) + eye
        e = (vals - pred) * w
        g = torch.bmm(e[:, None, :], qS)[:, 0] - reg * p[:, S].float()
        delta = chol_solve(cholesky_nan(H), g)
        p[:, S] = p[:, S] + delta.to(p.dtype)
        pred = pred + torch.bmm(qS, delta[:, :, None])[:, :, 0]
    target[real_ids] = p[sel]


class SubspaceALSSolver(ALSSolver):
    """iALS++-style block-coordinate ALS: the bucketed layout, but each
    sweep solves k/d subspace systems of size d instead of one k x k
    system. Draws one permutation of the blocks an epoch from its own
    generator (``draw``); ``epoch_with`` takes one, e.g. JAX's."""

    def __init__(self, model, params: Params, train_mat, invalid_users,
                 invalid_items, block_dim: int = 16, device="cuda",
                 split: bool = False, **_):
        super().__init__(model, params, train_mat, invalid_users,
                         invalid_items, device=device, split=split)
        if self.reg_exp:
            raise ValueError(
                "reg_exponent (per-row lambda) is implemented in the "
                "bucketed ALSSolver and the SGD engine; "
                "SubspaceALSSolver would silently train flat lambda")
        k = params.fac_dim
        self.d = min(block_dim, k)
        if k % self.d != 0:
            # wrap the block list (a coordinate may repeat across blocks
            # within a sweep; harmless for coordinate descent)
            n_blocks = -(-k // self.d)
            idx = np.resize(np.arange(k), n_blocks * self.d)
        else:
            idx = np.arange(k)
        self._block_idx = idx.reshape(-1, self.d).astype(np.int64)
        self._gen = torch.Generator().manual_seed(params.seed + 53)

    def draw(self) -> torch.Tensor:
        """This epoch's order of the blocks, a permutation of
        range(n_blocks) from the solver's generator."""
        return torch.randperm(self._block_idx.shape[0], generator=self._gen)

    def internal_state(self) -> dict:
        return {"gen": self._gen.get_state().numpy()}

    def set_internal_state(self, st: dict) -> None:
        if "gen" in st:
            self._gen.set_state(torch.from_numpy(np.asarray(st["gen"],
                                                            np.uint8)))

    def epoch(self, state: MFState, lr: float) -> MFState:
        return self.epoch_with(state, lr, self.draw())

    def epoch_with(self, state: MFState, lr: float,
                   perm: Sequence[int]) -> MFState:
        """One sweep with the blocks in the order ``perm``."""
        del lr
        blocks = torch.from_numpy(
            self._block_idx[np.asarray(perm, np.int64)]).to(self.device)
        u_fac, i_fac = state.u_fac.clone(), state.i_fac.clone()
        for chunk in self._stage[0]:
            _subspace_solve_bucket(u_fac, i_fac, *chunk, blocks,
                                   float(self.params.u_reg), self.d)
        self._share(0, u_fac)
        for chunk in self._stage[1]:
            _subspace_solve_bucket(i_fac, u_fac, *chunk, blocks,
                                   float(self.params.i_reg), self.d)
        self._share(1, i_fac)
        return state._replace(u_fac=u_fac, i_fac=i_fac)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 products summed in f32 (JAX's
    ``preferred_element_type=float32``): bf16 operands stay bf16 on the
    card (``out_dtype``); the CPU has no such product, and its f32 product
    of the same bf16 values is the same arithmetic (bf16 x bf16 is exact
    in f32)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def quantize_columns(qq: torch.Tensor):
    """(scales [W], int8 values [n, W]): symmetric per-column int8
    quantization, scale = max |column| / 127 (+1e-30), round half to even
    (JAX's gram_int8 rule; its compiled sweep divides by the constant as a
    product with 1 / 127, and so does this)."""
    scale = qq.abs().amax(dim=0) * (1.0 / 127.0) + 1e-30
    return scale, torch.round(qq / scale).to(torch.int8)


def default_dense_dtype(nu_pad: int, ni_pad: int) -> torch.dtype:
    """JAX's dense_dtype=None rule: f32 while the padded dense matrix takes
    at most 2 GiB in f32, else bf16."""
    return (torch.float32 if nu_pad * ni_pad * 4 <= 2 * 1024 ** 3
            else torch.bfloat16)


def dense_als_sweep(target: torch.Tensor, source: torch.Tensor,
                    dense_vals: torch.Tensor, reg: float, blk: int,
                    transposed: bool = False, cg_iters: int = 0,
                    packed: bool = True, gram_int8: bool = False,
                    mask8: Optional[torch.Tensor] = None,
                    blocks: Optional[range] = None) -> torch.Tensor:
    """Dense masked-Gram ALS sweep (JAX's ``_dense_als_sweep``): for each
    block of ``blk`` target rows,

        G[u] = sum_i 1[r_ui > 0] q_i q_i^T  =  M @ QQ
        b[u] = sum_i r_ui q_i               =  Wv @ Q

    with QQ[i, (a, b)] = q_ia q_ib: the normal equations of
    ``_solve_bucket`` with no gathers. ``dense_vals`` [n_rows, n_src], or
    [n_src, n_rows] with ``transposed`` (the item sweep reads column
    slices of the one dense copy). Products take bf16 operands when the
    values are bf16, f32 otherwise, and sum in f32; the k x k solves are
    f32. ``packed``: QQ holds the k(k+1)/2 upper-triangle products and the
    full Gram is rebuilt by an index map (the same f32 sums). ``gram_int8``:
    the Gram product in int8 x int8 -> int32 (the 0/1 mask is exact; QQ is
    quantized with symmetric per-column scales) from ``mask8``, the int8
    mask pre-staged in this sweep's own orientation; it needs
    ``cg_iters`` > 0. Returns the new [n_rows, k] table, or with ``blocks``
    the new rows of those row blocks only."""
    if gram_int8 and cg_iters <= 0:
        raise ValueError("gram_int8 requires cg_iters > 0 "
                         "(see DenseALSSolver)")
    n_rows, k = target.shape
    dev = target.device
    mm_dtype = (torch.bfloat16 if dense_vals.dtype == torch.bfloat16
                else torch.float32)
    qf = source.float()
    q = qf.to(mm_dtype)
    if packed:
        iu, il = np.triu_indices(k)
        qq = qf[:, torch.from_numpy(iu).to(dev)] * \
            qf[:, torch.from_numpy(il).to(dev)]          # [n_src, P] f32
        # full index map: (a, b) -> packed slot of (min, max)
        pos = np.zeros((k, k), np.int64)
        pos[iu, il] = np.arange(iu.size)
        pos[il, iu] = pos[iu, il]
        unpack_idx = torch.from_numpy(pos.reshape(-1)).to(dev)
    else:
        qq = (qf[:, :, None] * qf[:, None, :]).reshape(qf.shape[0], k * k)
    width = qq.shape[1]
    if gram_int8:
        qq_scale, qq = quantize_columns(qq)
        # the int8 product takes an outer size that is a multiple of 8, and
        # runs 7x faster on the card with QQ column-major (0.19 against
        # 1.40 ms for one user block at 100k x 20k, k = 64; H100 80GB
        # HBM3, 700 W)
        qq = torch.nn.functional.pad(qq, (0, (-width) % 8))
        qq = qq.t().contiguous().t()
    else:
        qq = qq.to(mm_dtype)
    eye = _eye(k, dev)
    sols = []
    for s in (range(n_rows // blk) if blocks is None else blocks):
        rows = slice(s * blk, (s + 1) * blk)
        if transposed:
            wv = dense_vals[:, rows]                       # [n_src, blk]
            b = mm_f32(wv.to(mm_dtype).t(), q)
        else:
            wv = dense_vals[rows]                          # [blk, n_src]
            b = mm_f32(wv.to(mm_dtype), q)
        if gram_int8:
            # int8 x int8 -> int32, exact; on the card it raises on shapes
            # it does not take (m <= 16; inner or outer size not a multiple
            # of 8)
            gram = torch._int_mm(mask8[rows], qq)[:, :width].float() \
                * qq_scale[None]
        else:
            m = (wv > 0).to(mm_dtype)
            gram = mm_f32(m.t() if transposed else m, qq)
        if packed:
            gram = gram.index_select(1, unpack_idx)
        gram = gram.reshape(blk, k, k) + reg * eye
        if cg_iters > 0:
            sols.append(solve_spd_cg(gram, b, target[rows].float(),
                                     cg_iters))
            continue
        chol = cholesky_nan(gram)
        if mm_dtype == torch.bfloat16:
            # bf16 Grams carry ~2^-8 relative error: once the factors grow
            # a masked Gram can turn (slightly) indefinite and its factor
            # NaN. Retry those with a diagonal ridge scaled to the trace.
            bad = ~torch.isfinite(chol).all(dim=2).all(dim=1)
            ridge = 8e-3 * torch.diagonal(gram, dim1=1, dim2=2).sum(
                dim=1) / k + 1e-6
            gram_j = gram + torch.where(bad, ridge, 0.0)[:, None, None] * eye
            chol = torch.where(bad[:, None, None], cholesky_nan(gram_j), chol)
        sols.append(chol_solve(chol, b))
    if not sols:
        return target[:0].clone()
    return torch.cat(sols).to(target.dtype)


class DenseALSSolver:
    """ALS over dense masked Grams, the gather-free formulation. Stages
    the dense rating matrix once (padded to ``row_block`` multiples), on
    the solver's device, with the rating>0 gate applied, so that
    (dense > 0) is the Gram mask and dense the masked values."""

    # JAX's guard, set for the TPU v5e's 16 GiB (values + int8 masks)
    MAX_DENSE_BYTES = 10 * 1024 ** 3

    def __init__(self, model, params: Params, train_mat,
                 invalid_users, invalid_items, row_block: int = 1024,
                 dense_dtype=None, cg_iters: int = 0,
                 packed: bool = True, gram_int8: bool = False,
                 device="cuda", split: bool = False, **_):
        """cg_iters > 0: warm-started CG solves instead of Cholesky; 0
        (default) = exact solves, the reference's ldlt
        (modelMF.cpp:836,874).

        dense_dtype (``torch.float32`` / ``torch.bfloat16``), None = f32
        when the padded dense matrix takes at most 2 GiB in f32, else bf16.

        gram_int8 needs cg_iters > 0: the quantization error is absolute
        per column, so a low-count row's Gram can go indefinite past the
        ridge retry; warm CG degrades gracefully instead.

        split: each process solves a contiguous run of the row blocks of
        each sweep and all-gathers the rest (every process stages the
        whole dense matrix: the item sweep reads every user row)."""
        self.model = model
        self.params = params
        self.cg_iters = cg_iters
        self.packed = packed
        self.gram_int8 = gram_int8
        self.device = torch.device(device)
        if gram_int8 and cg_iters <= 0:
            raise ValueError("gram_int8 requires cg_iters > 0 — the "
                             "quantized Gram of a low-count row can go "
                             "indefinite and Cholesky NaNs; warm CG is "
                             "the int8 perf path (dense_als_sweep)")
        if float(getattr(params, "reg_exponent", 0.0)):
            raise ValueError(
                "reg_exponent (per-row lambda) is implemented in the "
                "bucketed ALSSolver and the SGD engine; DenseALSSolver "
                "would silently train flat lambda")
        n_users, n_items = model.n_users, model.n_items
        self.row_block = row_block
        self.split = split
        # the guard counts the padded allocation
        self.nu_pad = -(-n_users // row_block) * row_block
        self.ni_pad = -(-n_items // row_block) * row_block
        if dense_dtype is None:
            dense_dtype = default_dense_dtype(self.nu_pad, self.ni_pad)
        need = (self.nu_pad * self.ni_pad
                * (dense_dtype.itemsize + (2 if gram_int8 else 0)))
        if need > self.MAX_DENSE_BYTES:
            raise ValueError(
                f"DenseALSSolver needs {need/2**30:.1f} GiB dense storage "
                "(padded to row_block multiples); use ALSSolver for this "
                "shape")
        r, c, v = train_mat.to_coo()
        # the rating>0 gate (modelMF.cpp:820/:862) applied at staging
        keep = (v > 0) & ~invalid_users[r] & ~invalid_items[c]
        idx = lambda a: torch.from_numpy(a[keep].astype(np.int64)).to(
            self.device)
        self.dense = torch.zeros((self.nu_pad, self.ni_pad),
                                 dtype=dense_dtype, device=self.device)
        self.dense[idx(r), idx(c)] = torch.from_numpy(v[keep]).to(
            self.device).to(dense_dtype)
        if gram_int8:
            # int8 masks in each sweep's row orientation (+2 bytes a slot,
            # counted in the guard)
            self.mask_rows = (self.dense > 0).to(torch.int8)
            self.mask_cols = self.mask_rows.t().contiguous()
        else:
            self.mask_rows = self.mask_cols = None
        # each process's run of row blocks a sweep (all of them unsplit)
        procs = distributed.process_count() if split else 1
        self._runs = [distributed.balanced_split([1] * (n // row_block),
                                                 procs)
                      for n in (self.nu_pad, self.ni_pad)]

    def _sweep(self, side: int, target, source, reg, **kw) -> torch.Tensor:
        """One sweep of ``side`` (0: users, 1: items): under ``split``
        this process's row blocks, the rest all-gathered."""
        if not self.split:
            return dense_als_sweep(target, source, self.dense, reg,
                                   self.row_block, **kw)
        runs, blk = self._runs[side], self.row_block
        own = runs[distributed.process_index()]
        out = target.clone()
        out[own.start * blk: own.stop * blk] = dense_als_sweep(
            target, source, self.dense, reg, blk, blocks=own, **kw)
        distributed.allgather_rows(out, [torch.arange(
            r.start * blk, r.stop * blk, device=out.device) for r in runs])
        return out

    def epoch(self, state: MFState, lr: float) -> MFState:
        del lr   # no step size, no draws
        n_users, n_items = self.model.n_users, self.model.n_items
        pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n))
        # padded rows / columns of the dense matrix are zero: they add
        # nothing to any Gram
        u_fac = pad(state.u_fac, self.nu_pad - n_users)
        i_fac = pad(state.i_fac, self.ni_pad - n_items)
        kw = dict(cg_iters=self.cg_iters, packed=self.packed,
                  gram_int8=self.gram_int8)
        u_fac = self._sweep(0, u_fac, i_fac, float(self.params.u_reg),
                            mask8=self.mask_rows, **kw)
        i_fac = self._sweep(1, i_fac, u_fac, float(self.params.i_reg),
                            transposed=True, mask8=self.mask_cols, **kw)
        return state._replace(u_fac=u_fac[:n_users], i_fac=i_fac[:n_items])
