"""Sharded DSGD: block-stratified SGD over a mesh (port of
matfac_tpu/parallel/dsgd.py).

The reference's shared-memory DSGD (ModelMF::trainSGDPar,
modelMF.cpp:154-350, with the Latin-square block schedule
sgdUpdateBlockSeq, util.cpp:1077-1107) on N shards of one mesh axis:

  * uFac and iFac are cut into N contiguous row blocks; shard i owns user
    block i for good;
  * the ratings are staged into the N x N (user block, round) grid: in
    round t shard i updates against item block (i + t) mod N, so the
    shards of a round touch disjoint item blocks;
  * between rounds each shard passes its item block to its left
    neighbour (JAX's ``ppermute``): within a process a relabeling of the
    held blocks, across processes a ring exchange
    (``distributed.ring_exchange``).

A process runs the rounds of its own shards one after another; the
shards of a round share nothing, so this is the result of running them
at once. After the N rounds every item block is back with its owner and
the process gathers the shards' blocks (all processes' on a multi-process
run) into whole tables, so the training loop sees plain tensors.

``DSGDShardedSolver`` updates with the scatter engine, in plain PyTorch
(XLA in JAX, where no Pallas kernel serves it): per-example IFWMF weights
and TMF ranks are staged in the stream; TMF+Dropout's Poisson ranks are
drawn for each (round, shard) from a generator keyed by the epoch's draw,
the round and the global shard id, so a 2-process run draws what a
1-process run draws. Colliding rows are summed in a fixed order
(``ops/scatter.index_add_ordered_``), so two runs are bit-identical on
either device.

Caller contract (multi-process), as in JAX: the model's own statistics
(the frequency tables behind example_weight / pair_rank) must be global;
``train_model`` sums them over the processes before it builds a model.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import MFState
from matfac_tpu_torch.ops.scatter import index_add_ordered_
from matfac_tpu_torch.parallel import distributed
from matfac_tpu_torch.parallel.mesh import Mesh


EPOCH_MODES = ("full", "nopermute", "permuteonly")


def _cdiv(a, b):
    return -(-a // b)


def shard_generator(seed: int, t: int, shard: int,
                    device) -> torch.Generator:
    """The generator of (round t, global shard) in the epoch of draw
    ``seed``, on ``device``: the same on every process."""
    return torch.Generator(device=device).manual_seed(int(
        np.random.SeedSequence([seed, t, shard + 1]).generate_state(1)[0]))


def hook(fn, r: np.ndarray, c: np.ndarray) -> np.ndarray:
    """A model hook (example_weight / pair_rank / pair_lambda) on host ids,
    as a numpy array."""
    return fn(torch.from_numpy(r.astype(np.int64)),
              torch.from_numpy(c.astype(np.int64))).cpu().numpy()


class ShardedTables:
    """What the three mesh solvers share: the shards of one mesh axis and
    the ones this process owns, the factor tables cut into the shards'
    blocks and kept resident across epochs, the item-block rotation, the
    gather back into whole tables, and the epoch draws.

    A subclass sets ``bu`` / ``bi`` (rows a shard block), the relabelings
    ``u_perm`` / ``i_perm`` (old id -> row of the padded, blocked tables;
    None: the identity) and calls ``_init_tables``."""

    def _init_tables(self, mesh: Mesh, axis: str, params: Params):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}")
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        self.local_blocks = mesh.local_blocks(axis)
        nb = len(self.local_blocks)
        if nb == 0:
            raise ValueError(f"this process owns no shard of axis {axis!r}")
        world = distributed.process_count()
        # the ring exchange and the gather assume rank r owns the r-th run
        # of nb shards (make_mesh's layout)
        me = distributed.process_index()
        if self.local_blocks != list(range(me * nb, (me + 1) * nb)) or \
                nb * world != self.n_shards:
            raise ValueError("each process must own one contiguous, "
                             "equal run of the axis's shards")
        devs = mesh.axis_devices(axis)
        self.devices = [devs[b] for b in self.local_blocks]
        self.home = self.devices[0]
        self.multiproc = world > 1
        self._sched_rng = np.random.default_rng(params.seed + 41)
        self._resident = None
        self._last_u_view = None
        self._last_i_view = None

    # -- staging helpers ------------------------------------------------
    def allgather_max(self, x: int) -> int:
        return int(np.max(distributed.allgather(np.asarray(x))))

    def _inverse(self, perm: Optional[np.ndarray], n_pad: int):
        if perm is None:
            return None, None
        inv = np.zeros(n_pad, np.int64)
        inv[perm] = np.arange(len(perm))
        return (torch.from_numpy(np.asarray(perm, np.int64)).to(self.home),
                torch.from_numpy(inv).to(self.home))

    def _init_perms(self, n_users: int, n_items: int):
        self.n_users_pad = self.bu * self.n_shards
        self.n_items_pad = self.bi * self.n_shards
        self._n_users, self._n_items = n_users, n_items
        self.u_perm_dev, self.u_perm_inv_dev = self._inverse(
            self.u_perm, self.n_users_pad)
        self.i_perm_dev, self.i_perm_inv_dev = self._inverse(
            self.i_perm, self.n_items_pad)

    # -- the epoch's draws ----------------------------------------------
    def draw_seed(self) -> int:
        """One draw of the epoch rng (the same on every process)."""
        return int(self._sched_rng.integers(2**31))

    def internal_state(self) -> dict:
        """What an exact resume needs besides the factor tables."""
        return {"sched_rng": np.asarray(json.dumps(
            self._sched_rng.bit_generator.state))}

    def set_internal_state(self, st: dict) -> None:
        if "sched_rng" in st:
            self._sched_rng.bit_generator.state = json.loads(
                str(st["sched_rng"]))

    # -- tables ---------------------------------------------------------
    def _padded(self, x: torch.Tensor, perm_inv, n_pad: int
                ) -> torch.Tensor:
        """Logical rows -> the padded, relabeled f32 table on home."""
        x = x.to(self.home)
        if perm_inv is not None:
            return x[perm_inv].to(torch.float32)
        out = torch.zeros((n_pad, x.shape[1]), dtype=torch.float32,
                          device=self.home)
        out[: x.shape[0]] = x
        return out

    def stage_factors(self, state: MFState) -> Tuple[List, List]:
        """Fresh f32 blocks of this process's shards: (u_blk, i_blk), lists
        over the local shards of [bu, k] / [bi, k] tensors on each shard's
        device; i_blk[j] is the item block shard j holds at round 0 (its
        own)."""
        u = self._padded(state.u_fac, self.u_perm_inv_dev, self.n_users_pad)
        i = self._padded(state.i_fac, self.i_perm_inv_dev, self.n_items_pad)
        cut = lambda x, n, b, d: x[b * n:(b + 1) * n].to(d).contiguous()
        return ([cut(u, self.bu, b, d)
                 for b, d in zip(self.local_blocks, self.devices)],
                [cut(i, self.bi, b, d)
                 for b, d in zip(self.local_blocks, self.devices)])

    def _tables(self, state: MFState):
        if (self._resident is not None
                and state.u_fac is self._last_u_view
                and state.i_fac is self._last_i_view):
            return self._resident
        return self.stage_factors(state)

    def rotate(self, held: List[torch.Tensor]) -> List[torch.Tensor]:
        """The round's item-block pass, shard j -> j - 1: local shards take
        their right neighbour's block; the last local shard receives the
        next process's first (the ring exchange), or in one process the
        first local shard's."""
        first = held[0]
        recv = (distributed.ring_exchange(first) if self.multiproc
                else first)
        nxt = held[1:] + [recv]
        return [x.to(d) for x, d in zip(nxt, self.devices)]

    def _gather(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        local = torch.stack([b.to(self.home) for b in blocks])
        return distributed.allgather_blocks(local).reshape(
            -1, blocks[0].shape[-1])

    def _views(self, state: MFState, u_blk, i_blk) -> MFState:
        """Gather the blocks into whole tables and hand back the logical
        views in the state's dtype, keeping the blocks resident."""
        self._resident = (u_blk, i_blk)
        u_all, i_all = self._gather(u_blk), self._gather(i_blk)
        k = state.u_fac.shape[1]
        u_view = (u_all[self.u_perm_dev] if self.u_perm is not None
                  else u_all[: self._n_users])[:, :k]
        i_view = (i_all[self.i_perm_dev] if self.i_perm is not None
                  else i_all[: self._n_items])[:, :k]
        # POST-cast tensors: the identity check in _tables must see what
        # the state holds
        u_ret = u_view.to(dtype=state.u_fac.dtype).contiguous()
        i_ret = i_view.to(dtype=state.i_fac.dtype).contiguous()
        self._last_u_view, self._last_i_view = u_ret, i_ret
        return state._replace(u_fac=u_ret, i_fac=i_ret)

    def epoch(self, state: MFState, lr: float,
              mode: str = "full") -> MFState:
        return self.epoch_with(state, lr, self.draw_schedule(), mode)

    def epoch_with(self, state: MFState, lr: float, schedule,
                   mode: str = "full") -> MFState:
        """One epoch: N rounds, each shard-round of every local shard then
        the rotation, on ``schedule`` (``draw_schedule``'s form; the tests
        pass the JAX key chain's draws). ``mode`` (JAX's phase-attribution
        variants, for scripts/torch_scaling_curve.py --phase-split): "full"
        trains; "nopermute" runs the same rounds without the rotation, each
        shard keeping its own item block (pure per-shard compute);
        "permuteonly" runs only the rotations (the exchange and the loop).
        The draws are the same in every mode; only "full" trains."""
        if mode not in EPOCH_MODES:
            raise ValueError(f"mode {mode!r} not in {EPOCH_MODES}")
        u_blk, i_blk = self._tables(state)
        for t in range(self.n_shards):
            if mode != "permuteonly":
                for j, b in enumerate(self.local_blocks):
                    self.shard_round(j, b, t, u_blk[j], i_blk[j], lr,
                                     schedule)
            if mode != "nopermute":
                i_blk = self.rotate(i_blk)
        return self._views(state, u_blk, i_blk)


class DSGDShardedSolver(ShardedTables):
    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 mesh: Mesh, axis: str = "u",
                 batch_size: Optional[int] = None,
                 balance_items: bool = False):
        """``balance_items``: relabel items so their frequency spreads
        evenly over the item blocks (round-robin over descending train
        frequency, snake order), the power-law hot-spot mitigation; the
        tables are relabeled on entry and exit of each epoch."""
        self.model = model
        self.params = params
        self._init_tables(mesh, axis, params)
        N = self.n_shards
        n_users, n_items = model.n_users, model.n_items
        self.bu = _cdiv(n_users, N)
        self.bi = _cdiv(n_items, N)

        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        self.u_perm = None
        self.i_perm = self.item_perm = None
        if balance_items:
            freq = np.bincount(c, minlength=n_items)
            order = np.argsort(-freq, kind="stable")
            perm = np.empty(n_items, np.int64)   # old id -> new id
            pos_in_block = np.arange(n_items) // N
            blk = np.arange(n_items) % N
            snake = np.where(pos_in_block % 2 == 1, N - 1 - blk, blk)
            perm[order] = snake * self.bi + pos_in_block
            self.item_perm = perm.astype(np.int32)
            self.i_perm = perm
        self._init_perms(n_users, n_items)
        # static per-example weight / rank from the model hooks, on the
        # ORIGINAL item ids, before any balance relabeling
        w = hook(model.example_weight, r, c).astype(np.float32)
        self.sample_poisson = model.name == "tmf_dropout"
        if (getattr(model, "stochastic_rank", False)
                and not self.sample_poisson):
            raise ValueError(
                f"{model.name} samples non-Poisson update ranks — "
                "train it on the single-device sgd engine")
        if self.sample_poisson:
            lam = hook(model.pair_lambda, r, c).astype(np.int32)
        elif hasattr(model, "pair_rank"):
            lam = hook(model.pair_rank, r, c).astype(np.int32)
        else:
            lam = np.full(len(r), model.k, np.int32)
        if self.item_perm is not None:
            c = self.item_perm[c]

        ub = r // self.bu            # owning shard of the user row
        ib = c // self.bi            # item block
        rnd = (ib - ub) % N          # round in which this entry is live
        # each process stages only the cells of its own shards; the
        # caller may pass the full matrix or its host-local rows
        local = np.isin(ub, self.local_blocks)
        r, c, v, w, lam = r[local], c[local], v[local], w[local], lam[local]
        ub, ib, rnd = ub[local], ib[local], rnd[local]
        self.nnz = len(r)          # local nnz in multi-process runs

        bs = batch_size or params.batch_size
        counts = np.zeros((N, N), np.int64)
        np.add.at(counts, (ub, rnd), 1)
        S = self.allgather_max(max(int(counts.max()), 1))
        S = _cdiv(S, bs) * bs if S > bs else bs
        self.S = S
        self.bs = min(bs, S)
        nb = len(self.local_blocks)
        blk_pos = np.full(N, -1, np.int64)
        blk_pos[self.local_blocks] = np.arange(nb)
        u_loc = np.zeros((nb, N, S), np.int32)
        i_loc = np.zeros((nb, N, S), np.int32)
        vals = np.zeros((nb, N, S), np.float32)
        wts = np.zeros((nb, N, S), np.float32)    # 0 weight = padding
        lams = np.ones((nb, N, S), np.int32)
        order = np.lexsort((rnd, ub))
        r, c, v, w, lam = r[order], c[order], v[order], w[order], lam[order]
        ub, ib, rnd = ub[order], ib[order], rnd[order]
        ub_loc = blk_pos[ub]
        grp = ub * N + rnd
        pos = np.arange(len(r)) - np.searchsorted(grp, grp, side="left")
        u_loc[ub_loc, rnd, pos] = (r - ub * self.bu).astype(np.int32)
        i_loc[ub_loc, rnd, pos] = (c - ib * self.bi).astype(np.int32)
        vals[ub_loc, rnd, pos] = v
        wts[ub_loc, rnd, pos] = w
        lams[ub_loc, rnd, pos] = lam
        # static shuffle within every cell (an unshuffled minibatch holds
        # whole user rows), seeded PER CELL so any process staging any
        # subset builds identical cells
        for j, b in enumerate(self.local_blocks):
            for t_s in range(N):
                cnt = int(counts[b, t_s])
                if cnt > 1:
                    rng = np.random.default_rng(
                        params.seed * 1000003 + b * N + t_s + 17)
                    p = rng.permutation(cnt)
                    for arr in (u_loc, i_loc, vals, wts, lams):
                        arr[j, t_s, :cnt] = arr[j, t_s, :cnt][p]
        put = lambda a, dt: [torch.from_numpy(a[j].astype(dt)).to(d)
                             for j, d in enumerate(self.devices)]
        self.u_loc = put(u_loc, np.int64)
        self.i_loc = put(i_loc, np.int64)
        self.vals = put(vals, np.float32)
        self.wts = put(wts, np.float32)
        self.lams = put(lams, np.int32)
        self._lams_f = ([x.to(torch.float32) for x in self.lams]
                        if self.sample_poisson else None)

    # ------------------------------------------------------------------
    def draw_schedule(self):
        """(seed, boff, ranks): the epoch's draw, its batch offsets [N], one
        a round and the same on every shard (JAX draws them from the
        replicated key), and ranks None: TMF+Dropout's Poisson ranks are
        drawn per (round, shard) from ``shard_generator(seed, t, shard)``
        in the epoch. A caller may give ``ranks`` [N rounds, N shards, S]
        int, each cell's ranks in slot order, in their place."""
        seed = self.draw_seed()
        n_steps = self.S // self.bs
        boff = torch.randint(0, max(n_steps, 1), (self.n_shards,),
                             generator=torch.Generator().manual_seed(seed))
        return seed, boff, None

    def poisson_ranks(self, j: int, b: int, t: int, seed: int
                      ) -> torch.Tensor:
        """TMF+Dropout's ranks of local shard j (global b) in round t: one
        Poisson draw per slot of the cell, clipped to [1, k]."""
        gen = shard_generator(seed, t, b, self.devices[j])
        lam = self._lams_f[j][t]
        return torch.poisson(lam, generator=gen).clamp(1, self.model.k).to(
            torch.int64)

    def shard_round(self, j, b, t, U, I, lr, schedule):
        """The scatter updates of local shard j (global b) in round t, in
        place on its user block U and held item block I."""
        seed, boff, ranks = schedule
        k = self.model.k
        bs, n_steps = self.bs, self.S // self.bs
        u_reg, i_reg = float(self.params.u_reg), float(self.params.i_reg)
        lr = float(lr)
        u_all, i_all = self.u_loc[j][t], self.i_loc[j][t]
        r_all, w_all = self.vals[j][t], self.wts[j][t]
        if ranks is not None:
            lam_all = torch.as_tensor(ranks[t][b]).to(
                device=U.device, dtype=torch.int64)
        elif self.sample_poisson:
            lam_all = self.poisson_ranks(j, b, t, seed)
        else:
            lam_all = self.lams[j][t]
        iota = torch.arange(k, device=U.device)
        bo = int(boff[t])
        for s in range(n_steps):
            a = ((s + bo) % n_steps) * bs
            u, i = u_all[a:a + bs], i_all[a:a + bs]
            r, w = r_all[a:a + bs], w_all[a:a + bs]
            m = (iota[None, :] < lam_all[a:a + bs, None]).to(U.dtype)
            pu, qi = U[u], I[i]
            pred = (pu * m * qi).sum(dim=1)
            wd = w * (r - pred)
            vmask = (w > 0).to(U.dtype)
            gu = (-2.0 * wd[:, None] * qi
                  + 2.0 * u_reg * vmask[:, None] * pu) * m
            gi = (-2.0 * wd[:, None] * pu
                  + 2.0 * i_reg * vmask[:, None] * qi) * m
            index_add_ordered_(U, 0, u, -lr * gu)
            index_add_ordered_(I, 0, i, -lr * gi)
