"""Block-DSGD: the single-device engines nested inside the mesh's DSGD
rotation (port of matfac_tpu/parallel/block_dsgd.py).

Both solvers keep ``DSGDShardedSolver``'s outer structure (contiguous user
ownership, N rounds, the item-block rotation, ``dsgd.ShardedTables``) and
replace each shard-round's inner sweep:

  * ``BlockDSGDSolver``: the one-hot cell engine's diag schedule. A
    shard-round is ONE ``block_sgd_diag_epoch`` call (the diag entry of
    ``csrc/block_sgd.cu`` on the card, ``block_sweep_diag`` on the CPU)
    on the shard's SU user sub-blocks and the held item block's SI
    sub-blocks, with a ``diag_schedule`` draw whose item lanes are the
    identity and whose dummy user sub-block SU is skipped. The streams are
    staged cell-major, [N, SU*SI + 1, S] a local shard with an all-invalid
    dummy row a shard-round, each cell's entries ordered by ``_pair_hash``
    of the global (user, item) pair, so any process staging any subset
    orders a cell as one process does.
  * ``DenseBlockDSGDSolver``: the row-dense stripes. A shard-round runs
    the shard's SU user stripes one after another against the one held
    item block, which is exactly a stripe epoch on the [SU, sub_bu, bi]
    sub-grid: ONE ``StripeTiles.rows_epoch`` call (the stripe entry of
    ``csrc/dense_rows.cu`` on the card, ``dense_sweep_rows`` on the CPU)
    on ``stripes[shard][t]``, staged once on R_tiles[shard, t] (and
    W_tiles), contiguous views of the [N, SU, sub_bu, bi] tiles of each
    local shard.

Layout, as in JAX: users keep their contiguous shard but are
frequency-interleaved over the shard's sub-blocks (rank r in the shard ->
sub-block r % SU, slot r // SU); items are snake-balanced over the shard
blocks and (one-hot engine) interleaved within each block the same way.

Multi-process staging: each process stages only its own shards' rows, and
what must agree across processes is agreed through
``distributed.allgather``: the summed frequencies behind both
permutations, the max cell size S, the staging ladder's choice (uniform
0/1 weights) and the min rating-code scale. Each shard-round's draws come
from a generator keyed by the epoch's draw, the round and the global
shard id (``dsgd.shard_generator``), so every shard sees the same calls
on the same bytes however the shards are spread over processes.

Not carried over: ``pad_k`` (zero columns that only filled the TPU's
matrix lanes) and the JAX tables' dummy user sub-block (its lanes are
skipped).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import ModelMF
from matfac_tpu_torch.ops.block_sgd_kernel import (block_sgd_diag_epoch,
                                                   diag_schedule, plan,
                                                   stage_slices)
from matfac_tpu_torch.ops.dense_block_kernel import densify_rows
from matfac_tpu_torch.ops.dense_row_kernel import StripeTiles
from matfac_tpu_torch.parallel import distributed
from matfac_tpu_torch.parallel.dsgd import (ShardedTables, hook,
                                            shard_generator)
from matfac_tpu_torch.parallel.mesh import Mesh
from matfac_tpu_torch.solvers.block_sgd import (auto_batch_size,
                                                rating_code_scale,
                                                stage_batch_collision_counts)


def _cdiv(a, b):
    return -(-a // b)


def _interleave_local(rank: np.ndarray, n_sub: int, sub: int
                      ) -> np.ndarray:
    """rank within a block (0 = most frequent) -> local id that
    round-robins frequency over the n_sub sub-blocks."""
    return (rank % n_sub) * sub + rank // n_sub


_MASK64 = (1 << 64) - 1


def _pair_hash(r: np.ndarray, c: np.ndarray, seed: int) -> np.ndarray:
    """splitmix64-style hash of the global (user, item) pair id: the
    within-cell order key. It depends on the pair (and the seed) alone,
    never on how many entries this process staged."""
    x = (r.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + c.astype(np.uint64)
         + np.uint64((seed * 0x2545F4914F6CDD1D + 0x1234567) & _MASK64))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def snake_item_order(i_freq: np.ndarray, N: int):
    """Items by descending frequency, dealt over the N shard blocks in snake
    order: (order, block, position in block) of each rank."""
    n_items = len(i_freq)
    order = np.argsort(-i_freq, kind="stable")
    blk = np.arange(n_items) % N
    pos = np.arange(n_items) // N
    return order, np.where(pos % 2 == 1, N - 1 - blk, blk), pos


def user_perm(u_freq: np.ndarray, N: int, bu: int, SU: int,
              sub_bu: int) -> np.ndarray:
    """Contiguous shard ownership (old id // ceil(n_users / N)), frequency
    interleaved over the shard's SU sub-blocks."""
    n_users = len(u_freq)
    own = np.minimum(np.arange(n_users) // _cdiv(n_users, N), N - 1)
    perm = np.empty(n_users, np.int64)
    for sh in range(N):
        ids = np.nonzero(own == sh)[0]
        rank = np.empty(len(ids), np.int64)
        rank[np.argsort(-u_freq[ids], kind="stable")] = np.arange(len(ids))
        perm[ids] = sh * bu + _interleave_local(rank, SU, sub_bu)
    return perm


def _global_freqs(r, c, n_users, n_items):
    """Entity frequencies summed over the processes, so every process
    derives the same permutations from its host-local rows."""
    u_freq = np.bincount(r, minlength=n_users).astype(np.int64)
    i_freq = np.bincount(c, minlength=n_items).astype(np.int64)
    if distributed.multiprocess():
        u_freq = distributed.allgather(u_freq).sum(axis=0)
        i_freq = distributed.allgather(i_freq).sum(axis=0)
    return u_freq, i_freq


class BlockDSGDSolver(ShardedTables):
    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 mesh: Mesh, axis: str = "u", sub_bu: int = 384,
                 sub_bi: int = 384, batch_size: Optional[int] = None,
                 collision_norm: Optional[bool] = None,
                 mm_bf16: bool = True):
        """``batch_size=None``: sized so one step of a shard's diag sweep
        carries ~64k ratings over its SI lanes (``auto_batch_size``),
        fitted to the cell size S, which every process agrees on."""
        if model.use_bias or not model.use_factors:
            raise ValueError("BlockDSGDSolver is factor-only")
        if hasattr(model, "pair_lambda"):
            raise ValueError(
                "block engines stage static per-pair ranks; "
                f"{model.name} needs Poisson-sampled ranks — use "
                "DSGDShardedSolver")
        if type(model).update_side_masks is not ModelMF.update_side_masks:
            raise ValueError("per-side update gates need SGDSolver")
        self.model = model
        self.params = params
        self.mm_bf16 = mm_bf16
        self.collision_norm = (params.sgd_collision_norm
                               if collision_norm is None else collision_norm)
        self._init_tables(mesh, axis, params)
        N = self.n_shards
        n_users, n_items = model.n_users, model.n_items
        # shard blocks rounded so the sub-blocks tile them exactly
        self.bu = _cdiv(_cdiv(n_users, N), sub_bu) * sub_bu
        self.bi = _cdiv(_cdiv(n_items, N), sub_bi) * sub_bi
        self.SU = self.bu // sub_bu
        self.SI = self.bi // sub_bi
        self.sub_bu, self.sub_bi = sub_bu, sub_bi

        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        u_freq, i_freq = _global_freqs(r, c, n_users, n_items)
        self.u_perm = user_perm(u_freq, N, self.bu, self.SU, sub_bu)
        order, snake_blk, pos = snake_item_order(i_freq, N)
        self.i_perm = np.empty(n_items, np.int64)
        self.i_perm[order] = snake_blk * self.bi + _interleave_local(
            pos, self.SI, sub_bi)
        self._init_perms(n_users, n_items)

        nb = len(self.local_blocks)
        r2 = self.u_perm[r]
        c2 = self.i_perm[c]
        sh = r2 // self.bu
        local = np.isin(sh, self.local_blocks)
        r, c, v = r[local], c[local], v[local]
        r2, c2, sh = r2[local], c2[local], sh[local]
        self.nnz = len(r)          # local nnz in multi-process runs

        # model hooks before relabeling
        w = hook(model.example_weight, r, c).astype(np.float32)
        self.use_mask = hasattr(model, "pair_rank")
        lam = (hook(model.pair_rank, r, c).astype(np.int32) if self.use_mask
               else np.full(len(r), model.k, np.int32))

        t = (c2 // self.bi - sh) % N
        su = (r2 % self.bu) // sub_bu
        si = (c2 % self.bi) // sub_bi
        blk_pos = np.full(N, -1, np.int64)
        blk_pos[self.local_blocks] = np.arange(nb)
        cell = ((blk_pos[sh] * N + t) * self.SU + su) * self.SI + si
        n_cells = nb * N * self.SU * self.SI
        counts = np.bincount(cell, minlength=n_cells)
        S = self.allgather_max(max(int(counts.max()), 1))
        if batch_size is None:
            batch_size = auto_batch_size(S, self.SI)
        S = _cdiv(S, batch_size) * batch_size
        self.S = S
        self.bs = min(batch_size, S)
        self.pad_frac = n_cells * S / max(self.nnz, 1)

        u_loc = np.zeros((n_cells, S), np.int32)
        i_loc = np.zeros((n_cells, S), np.int32)
        vals = np.zeros((n_cells, S), np.float32)
        wts = np.zeros((n_cells, S), np.float32)
        lams = np.ones((n_cells, S), np.int32)
        # the within-cell order: one lexsort keyed by the global pair hash
        order = np.lexsort((_pair_hash(r2, c2, params.seed), cell))
        r2, c2, v, w, lam = (r2[order], c2[order], v[order], w[order],
                             lam[order])
        cell = cell[order]
        pos = np.arange(len(r2)) - np.searchsorted(cell, cell, "left")
        u_loc[cell, pos] = (r2 % sub_bu).astype(np.int32)
        i_loc[cell, pos] = (c2 % sub_bi).astype(np.int32)
        vals[cell, pos] = v
        wts[cell, pos] = w
        lams[cell, pos] = lam
        cnu = cni = None
        if self.collision_norm:
            cnu = stage_batch_collision_counts(wts, u_loc, self.bs, sub_bu)
            cni = stage_batch_collision_counts(wts, i_loc, self.bs, sub_bi)

        # cell-major [N, SU*SI + 1, S] per local shard, the dummy row last
        nc_sr = self.SU * self.SI

        def put(a, fill):
            if a is None:
                return [None] * nb
            a = a.reshape(nb, N, nc_sr, S)
            a = np.concatenate([a, np.full((nb, N, 1, S), fill, a.dtype)],
                               axis=2)
            return [torch.from_numpy(np.ascontiguousarray(a[j])).to(d)
                    for j, d in enumerate(self.devices)]

        self.u_loc, self.i_loc = put(u_loc, 0), put(i_loc, 0)
        self.vals, self.wts = put(vals, 0), put(wts, 0)
        self.lams = put(lams, 1)
        self.cnu, self.cni = put(cnu, 1.0), put(cni, 1.0)
        # the kernel's view of each shard-round's streams, staged once
        self.slices = None
        if self.home.type == "cuda":
            self.slices = []
            for j, d in enumerate(self.devices):
                with torch.cuda.device(d):
                    rng_size = plan(self.SI, self.bs, sub_bu, sub_bi,
                                    model.k)["range"]
                self.slices.append([
                    stage_slices(self.streams(j, tt), self.bs, sub_bu,
                                 sub_bi, self.collision_norm, self.use_mask,
                                 rng_size) for tt in range(N)])

    def streams(self, j: int, t: int):
        """Local shard j's staged streams of round t, [SU*SI + 1, S] each,
        in the kernel's order."""
        pick = lambda x: None if x[j] is None else x[j][t]
        return (pick(self.u_loc), pick(self.i_loc), pick(self.vals),
                pick(self.wts), pick(self.cnu), pick(self.cni),
                pick(self.lams) if self.use_mask else None)

    def sweep_kwargs(self) -> dict:
        return dict(bs=self.bs, bu=self.sub_bu, bi=self.sub_bi, NI=self.SI,
                    u_reg=float(self.params.u_reg),
                    i_reg=float(self.params.i_reg),
                    collision_norm=self.collision_norm,
                    use_mask=self.use_mask, mm_bf16=self.mm_bf16)

    def draw_schedule(self):
        """{(t, shard): (ub_idx, ib_idx, boff)}: each shard-round's diag
        rounds over its SU user sub-blocks (dummy SU) and SI identity item
        lanes, from ``shard_generator(seed, t, shard)`` on the CPU, for
        this process's shards."""
        seed = self.draw_seed()
        n_steps = self.S // self.bs
        return {(t, b): diag_schedule(shard_generator(seed, t, b, "cpu"),
                                      self.SU, self.SI, n_steps)
                for t in range(self.n_shards) for b in self.local_blocks}

    def shard_round(self, j, b, t, U, I, lr, schedule):
        ub_idx, ib_idx, boff = schedule[(t, b)]
        block_sgd_diag_epoch(U, I, ub_idx, ib_idx, boff, lr,
                             *self.streams(j, t), **self.sweep_kwargs(),
                             slices=None if self.slices is None
                             else self.slices[j][t])


class DenseBlockDSGDSolver(ShardedTables):
    """Row-dense stripes inside the DSGD rotation: the multi-device form of
    the dense engine. Update math is BlockSGDSolver(engine="dense")'s at
    batch = stripe cell (README deviation #1). Tiles [N, SU, sub_bu, bi]
    per local shard (round, stripe): bf16 ratings with int8 validity (0/1
    weights) or bf16 weights, or int8 rating codes with no W; the padded
    dense matrix in all, split over the shards. Rank-masked models are
    refused, as in JAX."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 mesh: Mesh, axis: str = "u",
                 sub_bu: Optional[int] = None,
                 collision_norm: Optional[bool] = None,
                 mm_bf16: bool = True,
                 dense_budget_bytes: int = 8 << 30,
                 dense_codes: str = "auto"):
        if model.use_bias or not model.use_factors:
            raise ValueError("DenseBlockDSGDSolver is factor-only")
        if dense_codes not in ("auto", "codes", "off"):
            raise ValueError(f"unknown dense_codes {dense_codes!r}")
        if hasattr(model, "pair_lambda") or hasattr(model, "pair_rank"):
            raise ValueError(
                "dense engines do not support rank-masked/sampled "
                f"models; {model.name} -> BlockDSGDSolver or DSGD")
        if type(model).update_side_masks is not ModelMF.update_side_masks:
            raise ValueError("per-side update gates need SGDSolver")
        self.model = model
        self.params = params
        self.mm_bf16 = mm_bf16
        self.collision_norm = (params.sgd_collision_norm
                               if collision_norm is None else collision_norm)
        self._init_tables(mesh, axis, params)
        N = self.n_shards
        n_users, n_items = model.n_users, model.n_items
        if sub_bu is None:
            # >= 8 stripes a shard keeps the epoch SGD-like (batch = stripe
            # cell); an 8-row quantum so tiny shards still get 8 stripes
            sub_bu = min(2560, max(_cdiv(_cdiv(n_users, 8 * N), 8) * 8, 8))
        self.sub_bu = sub_bu
        self.bu = _cdiv(_cdiv(n_users, N), sub_bu) * sub_bu
        self.SU = self.bu // sub_bu
        self.bi = _cdiv(_cdiv(n_items, N), 128) * 128
        slots = self.bu * N * self.bi * N
        if slots > dense_budget_bytes:        # 1 B/slot floor (codes)
            raise ValueError(
                f"dense DSGD tiles need >= {slots/2**30:.1f} GiB > "
                f"budget {dense_budget_bytes/2**30:.1f} GiB; use "
                "BlockDSGDSolver")

        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        u_freq, i_freq = _global_freqs(r, c, n_users, n_items)
        self.u_perm = user_perm(u_freq, N, self.bu, self.SU, sub_bu)
        order, snake_blk, pos = snake_item_order(i_freq, N)
        self.i_perm = np.empty(n_items, np.int64)
        self.i_perm[order] = snake_blk * self.bi + pos
        self._init_perms(n_users, n_items)

        nb = len(self.local_blocks)
        r2 = self.u_perm[r]
        sh = r2 // self.bu
        local = np.isin(sh, self.local_blocks)
        r, c, v = r[local], c[local], v[local]
        r2, sh = r2[local], sh[local]
        self.nnz = len(r)          # local nnz in multi-process runs
        w = hook(model.example_weight, r, c).astype(np.float32)

        c2 = self.i_perm[c]
        t = (c2 // self.bi - sh) % N
        su = (r2 % self.bu) // sub_bu
        ul = (r2 % sub_bu).astype(np.int32)
        il = (c2 % self.bi).astype(np.int32)
        multiproc = self.multiproc
        # the staging ladder's choice must agree across processes
        uniform01 = bool(np.all(distributed.allgather(
            bool(np.all((w == 0.0) | (w == 1.0))))))
        want_codes = uniform01 and dense_codes in ("auto", "codes")
        if want_codes and dense_codes == "auto":
            # codes only for traffic-bound or over-budget grids
            if slots < int(1.5e9) and slots * 3 <= dense_budget_bytes:
                want_codes = False
        self.r_scale = rating_code_scale(v) if want_codes else None
        if dense_codes == "codes" and self.r_scale is None \
                and not multiproc:
            raise ValueError(
                "dense_codes='codes' requires exactly star-grid-"
                "representable ratings with uniform 0/1 weights")
        if multiproc and want_codes:
            # the SCALE must agree: the min of the local candidates,
            # re-verified locally at it
            gs = distributed.allgather(
                np.nan if self.r_scale is None else self.r_scale)
            gmin = float(np.min(gs))
            ok = False
            if np.all(np.isfinite(gs)):
                codes = np.round(v.astype(np.float64) / gmin)
                ok = (len(codes) == 0
                      or (np.abs(codes).max() <= 127
                          and np.abs(codes).min() >= 1
                          and np.array_equal(
                              codes.astype(np.float32) * np.float32(gmin),
                              v)))
            ok = bool(np.all(distributed.allgather(ok)))
            self.r_scale = gmin if ok else None

        blk_pos = np.full(N, -1, np.int64)
        blk_pos[self.local_blocks] = np.arange(nb)
        jloc = blk_pos[sh]

        def tiles(a, dtype):
            """[N, SU, sub_bu, bi] tiles of each local shard (round,
            stripe), on its device."""
            out = []
            for j, d in enumerate(self.devices):
                sel = jloc == j
                out.append(densify_rows(
                    t[sel] * self.SU + su[sel], ul[sel], il[sel], a[sel],
                    n_cells_pad=N * self.SU, bu=sub_bu, bi=self.bi,
                    dtype=dtype, device=d).view(N, self.SU, sub_bu,
                                                self.bi))
            return out

        if self.r_scale is not None:
            codes = np.round(v.astype(np.float64) / self.r_scale)
            self.R_tiles = tiles(codes.astype(np.int8), torch.int8)
            self.W_tiles = None
        else:
            if slots * 3 > dense_budget_bytes:    # bf16 R + int8 W
                raise ValueError(
                    f"dense DSGD tiles need {slots*3/2**30:.1f} GiB > "
                    f"budget {dense_budget_bytes/2**30:.1f} GiB; use "
                    "BlockDSGDSolver")
            wdtype = torch.int8 if uniform01 else torch.bfloat16
            self.R_tiles = tiles(v.astype(np.float32), torch.bfloat16)
            self.W_tiles = tiles(w, wdtype)
        # each shard-round's tiles, [SU, sub_bu, bi] views, staged once
        self.stripes = [[StripeTiles(
            self.R_tiles[j][tt], None if self.W_tiles is None
            else self.W_tiles[j][tt], self.r_scale, model.k, params.u_reg,
            params.i_reg, self.collision_norm, mm_bf16)
            for tt in range(N)] for j in range(nb)]

    def draw_schedule(self):
        """{(t, shard): stripe order}: each shard-round's order of its SU
        stripes, a permutation from ``shard_generator(seed, t, shard)`` on
        the CPU, for this process's shards."""
        seed = self.draw_seed()
        return {(t, b): torch.randperm(
                    self.SU, generator=shard_generator(seed, t, b, "cpu"))
                for t in range(self.n_shards) for b in self.local_blocks}

    def shard_round(self, j, b, t, U, I, lr, schedule):
        self.stripes[j][t].rows_epoch(U.view(self.SU, self.sub_bu, -1), I,
                                      schedule[(t, b)], lr)
