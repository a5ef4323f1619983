"""The host plans of two kernels of the port, and a step-for-step model of
the radix top-N route's select stage, on the CPU.

* ``dense_row_kernel.cells_plan``: the cell-grid entry's rounds on the
  card, one panel and one step launch a round, each round's live cells
  (dummy lanes dropped) in the order in which the plain
  ``dense_sweep_diag`` visits them, against the JAX package's own rounds
  (``device_diag_schedule``) and its ``dense_sweep_diag``, for which an
  all-dummy round changes nothing.
* ``topk_kernel.radix_plan`` against ``fused_plan``'s radix route.
* ``_select_model``: ``csrc/topk.cu``'s ``radix_select_kernel`` on numpy
  keys (the row's scorable count and key range, 8-bit radix passes from
  the highest differing bit while the candidates would not fit the sort
  buffer, the gather, the tie cut by id, the sort), held exactly to
  ``topk_plain`` on the same scores and to the JAX XLA scorer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matfac_tpu.data.csr import RatingMatrix
from matfac_tpu.eval import ranking as jr
from matfac_tpu.models.base import EvalView as JView
from matfac_tpu.ops import dense_block_kernel as jdbk
from matfac_tpu.ops.block_sgd_kernel import device_diag_schedule
from matfac_tpu_torch.ops import dense_block_kernel as tdbk
from matfac_tpu_torch.ops import dense_row_kernel as tdrk
from matfac_tpu_torch.ops import topk_kernel as tk

# ----------------------------------------------------------------------
# the cell grid's rounds
# ----------------------------------------------------------------------


def _jax_rounds(NU, NI, seed, epochs=1):
    return np.concatenate([np.asarray(device_diag_schedule(
        jax.random.PRNGKey(seed + e), NU, NI, 1)[0]) for e in range(epochs)])


def _visits(monkeypatch, ub_idx, NU, NI):
    """The (lane, user block) cells the plain dense_sweep_diag steps, in
    order: each cell's tile holds its index."""
    seen = []

    def record(U, I, R, W, *args, **kw):
        seen.append(divmod(int(R[0, 0]), NI)[::-1])
        return U, I

    monkeypatch.setattr(tdbk, "cell_dense_update", record)
    R = torch.arange(NU * NI + 1, dtype=torch.float32).view(-1, 1, 1)
    tdbk.dense_sweep_diag(torch.zeros(NU, 1, 2), torch.zeros(NI, 1, 2),
                          torch.from_numpy(ub_idx), 0.1, R, None, 0.0, 0.0,
                          True, True, r_scale=1.0)
    return seen


@pytest.mark.parametrize("NU, NI", [(5, 3), (3, 5), (4, 4), (40, 40)])
def test_cells_plan_keeps_the_cells_the_plain_sweep_visits(monkeypatch, NU,
                                                           NI):
    """The plan's cells are the (lane, user block) pairs the plain version
    steps, in its order; each round's count is its live lanes (dummy
    lanes, user block NU, dropped); an all-dummy round launches nothing;
    2 launches a round with a live cell, + 1 for the bf16 copy of U on
    the tensor-core route."""
    rounds = _jax_rounds(NU, NI, NU * 100 + NI, epochs=2)
    ub_idx = np.concatenate([rounds[:1], np.full((1, NI), NU), rounds[1:]])
    plan = tdrk.cells_plan(torch.from_numpy(ub_idx), NU, 64, True)
    want = _visits(monkeypatch, ub_idx, NU, NI)
    assert [tuple(c) for c in plan["cells"].tolist()] == want
    assert plan["cells"].dtype == torch.int32
    assert plan["counts"].tolist() == (ub_idx < NU).sum(1).tolist()
    assert plan["counts"][1] == 0
    live = int(((ub_idx < NU).sum(1) > 0).sum())
    assert plan["rounds"] == live == ub_idx.shape[0] - 1
    assert plan["launches"] == 1 + 2 * live
    assert tdrk.cells_plan(torch.from_numpy(ub_idx), NU, 160, True)[
        "launches"] == 2 * live
    assert tdrk.cells_plan(torch.from_numpy(ub_idx), NU, 64, False)[
        "launches"] == 2 * live
    if NU == NI == 40:   # (w): an epoch of 40 rounds of 40 cells
        one = tdrk.cells_plan(torch.from_numpy(rounds[:40]), NU, 64, True)
        assert one["launches"] == 81 and one["counts"].tolist() == [40] * 40


def test_an_all_dummy_round_changes_nothing_in_jax():
    """JAX steps a dummy lane on the all-invalid dummy cell with the zero
    dummy block: a round of dummy lanes leaves both tables bit for bit as
    they were, so the port's plan, which launches nothing for it, is
    exact."""
    rng = np.random.default_rng(0)
    NU, NI, bu, bi, k = 3, 4, 6, 5, 4
    R = rng.normal(3.0, 1.0, (NU * NI + 1, bu, bi)).astype(np.float32)
    W = (rng.random(R.shape) < 0.4).astype(np.float32)
    R[-1], W[-1] = 0.0, 0.0
    u3 = rng.normal(size=(NU + 1, bu, k)).astype(np.float32)
    u3[-1] = 0.0
    i3 = rng.normal(size=(NI, bi, k)).astype(np.float32)
    ju, ji = jdbk.dense_sweep_diag(
        jnp.asarray(u3), jnp.asarray(i3), jnp.full((2, NI), NU, jnp.int32),
        jnp.float32(0.05), jnp.asarray(R), jnp.asarray(W), NI, 0.01, 0.02,
        True, True)
    np.testing.assert_array_equal(np.asarray(ju), u3)
    np.testing.assert_array_equal(np.asarray(ji), i3)
    plan = tdrk.cells_plan(torch.full((2, NI), NU), NU, 64, True)
    assert (plan["rounds"], plan["launches"], plan["cells"].numel(),
            plan["counts"].tolist()) == (0, 1, 0, [0, 0])


def test_stripe_epoch_launches():
    """A stripe epoch: a round of one cell a stripe, (lane 0, stripe)."""
    assert [tdrk.epoch_launches(40, k, mm) for k, mm in (
        (64, True), (128, True), (160, True), (64, False))] == \
        [81, 81, 80, 80]
    cells = tdrk.stripe_cells(torch.tensor([2, 0, 1]), "cpu")
    assert cells.tolist() == [[0, 2], [0, 0], [0, 1]]
    assert cells.dtype == torch.int32


# ----------------------------------------------------------------------
# the radix route's launches
# ----------------------------------------------------------------------


@pytest.mark.parametrize("B, n_items, n", [
    (100_000, 20_000, 1000), (100_000, 20_000, 129), (2048, 20_000, 4096),
    (637, 3001, 1000), (1, 200_000, 500), (13_421, 20_000, 1000),
    (13_422, 20_000, 1000)])
def test_radix_plan_matches_fused_plan(B, n_items, n):
    """n > FUSED_MAX_N takes the radix route: a score and a select launch
    for each chunk of chunk_users(n_items) users (8 chunks, 16 launches, a
    top-1000 pass at 100,000 x 20,000)."""
    rp, fp = tk.radix_plan(B, n_items), tk.fused_plan(B, n_items, n)
    assert fp["route"] == "radix" and fp["launches"] == rp["launches"]
    assert rp["chunk"] == tk.chunk_users(n_items)
    assert rp["chunks"] == -(-B // rp["chunk"])
    assert rp["launches"] == tk.KERNELS_PER_CHUNK * rp["chunks"]
    if (B, n_items) == (100_000, 20_000):
        assert (rp["chunk"], rp["launches"]) == (13_421, 16)


# ----------------------------------------------------------------------
# the select stage, modelled
# ----------------------------------------------------------------------

def _ord(scores: np.ndarray) -> np.ndarray:
    """Order-preserving uint32 keys of f32 scores (-0 as +0)."""
    s = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    b = s.view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xffffffff, b | 0x80000000)


MASKED = int(_ord(np.asarray([tk.NEG_INF], np.float32))[0])


def _key_float(keys: np.ndarray) -> np.ndarray:
    k = keys.astype(np.uint64)
    b = np.where(k & 0x80000000, k & 0x7fffffff, ~k & 0xffffffff)
    return b.astype(np.uint32).view(np.float32)


def _select_model(row: np.ndarray, n: int):
    """radix_select_kernel on one row of f32 scores: (scores [n], ids [n],
    stats). The bound starts below every scorable key; while the keys at or
    above it would not fit the sort buffer (ncap, a power of 2 >= n), a
    pass histograms the keys at the bound's prefix in an 8-bit digit, the
    first digit topped by the highest bit where the scorable keys differ,
    and takes the bin where the n-th key falls (counts from the top).
    Where more keys tie at the n-th than fit, the ties go by id."""
    keys = _ord(row)
    ok = keys > MASKED
    m = int(ok.sum())
    target = min(n, m)
    ncap = 1 << (n - 1).bit_length()
    lower, cut, c_gt, passes, first_share = MASKED + 1, False, 0, 0, None
    tie = need_eq = 0
    if m > ncap:
        lo, hi = int(keys[ok].min()), int(keys[ok].max())
        if lo == hi:
            cut, tie, need_eq = True, lo, target
        else:
            top = (lo ^ hi).bit_length() - 1
            mask = 0 if top == 31 else ~((2 << top) - 1) & 0xffffffff
            prefix, rem = hi & mask, target
            while True:
                shift = max(top - 7, 0)
                dmask = (2 << (top - shift)) - 1
                sel = ok & ((keys & mask) == prefix)
                hist = np.bincount(((keys[sel] >> shift) & dmask)
                                   .astype(np.int64), minlength=256)
                passes += 1
                if first_share is None:
                    first_share = hist.max() / m
                incl = np.cumsum(hist[::-1])[::-1]
                above = incl - hist
                b = int(np.flatnonzero((hist > 0) & (above < rem)
                                       & (rem <= incl))[0])
                c_gt += int(above[b])
                rem -= int(above[b])
                prefix |= b << shift
                mask |= dmask << shift
                if c_gt + int(hist[b]) <= ncap:
                    lower = prefix
                    break
                if shift == 0:
                    cut, tie, need_eq = True, prefix, rem
                    break
                top = shift - 1
    ids = np.arange(len(row))
    if cut:
        cand = np.concatenate([ids[ok & (keys > tie)],
                               ids[ok & (keys == tie)][:need_eq]])
    else:
        cand = ids[ok & (keys >= lower)]
    assert len(cand) <= ncap and len(cand) >= target
    full = (keys[cand].astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xffffffff) - cand.astype(np.uint64))
    best = np.sort(full)[::-1][:target]
    out_s = np.full(n, tk.NEG_INF, np.float32)
    out_i = np.full(n, -1, np.int32)
    out_s[:target] = _key_float(best >> np.uint64(32))
    out_i[:target] = (np.uint64(0xffffffff) - (best & np.uint64(0xffffffff))
                      ).astype(np.int32)
    return out_s, out_i, dict(passes=passes, cut=cut, first_share=first_share,
                              candidates=len(cand))


def _scores(u, i, ub, ib, mu, invalid, indptr, indices, users):
    """The scratch the score stage writes (radix_scores on the CPU: the
    plain version's scores, -3e38 on invalid and rated items)."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return tk.radix_scores(t(u), t(i), t(ib), t(ub), t(mu),
                           torch.from_numpy(invalid),
                           torch.from_numpy(indptr),
                           torch.from_numpy(indices),
                           torch.from_numpy(np.asarray(users, np.int64))
                           ).numpy()


def _case(n_users, n_items, k, seed):
    """Random factors; users 0-2 and 9 with rows the selection must get
    right: 0 all-equal scores, 1 three values, 2 every score zero from +0
    / -0 biases, 9 a trained model's scores (one sign, one exponent,
    shifted by its bias); user 3 rated every item but 60, user 4 every
    other item. Every score of those rows is exact in f32."""
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 0.3, (n_users, k)).astype(np.float32)
    i = rng.normal(0, 0.3, (n_items, k)).astype(np.float32)
    i[:, 0] = rng.integers(0, 3, n_items) * 0.5
    i[:, 1] = 1.0 + 0.4 * rng.random(n_items)
    u[[0, 1, 2, 9]] = 0.0
    u[1, 0] = 1.0
    u[9, 1] = 1.0
    ub = rng.normal(0, 0.1, n_users).astype(np.float32)
    ub[[0, 1, 2, 9]] = 1.25, 0.0, 0.0, 1.5
    ib = np.where(rng.random(n_items) < 0.5, 0.0, -0.0).astype(np.float32)
    invalid = rng.random(n_items) < 0.1
    rated = rng.random((n_users, n_items)) < 0.05
    rated[3] = True
    rated[3, rng.choice(n_items, 60, replace=False)] = False
    rated[4] = False
    rated[4, ::2] = True
    indptr = np.concatenate([[0], np.cumsum(rated.sum(1))]).astype(np.int64)
    indices = np.nonzero(rated)[1].astype(np.int32)
    users = np.arange(n_users)
    return (u, i, ub, ib, np.float32(0.0), invalid, indptr, indices, users)


@pytest.mark.parametrize("n", [129, 1000, 4096])
def test_select_model_matches_topk_plain(n):
    """Every row of a 6,000-item catalog through the model equals
    topk_plain bit for bit (scores and ids) on the same scores: the
    all-equal row and the three-value row cut their ties by id, the zero
    row ties +0 with -0, the short rows pad with -1; a trained model's
    scores split in the first pass."""
    case = _case(16, 6_000, 8, n)
    S = _scores(*case)
    u, i, ub, ib = (torch.from_numpy(a) for a in case[:4])
    want_s, want_i = tk.topk_plain(
        u, i, ib, ub, torch.tensor(0.0), torch.from_numpy(case[5]),
        torch.from_numpy(case[6]), torch.from_numpy(case[7]),
        torch.from_numpy(case[8]), n)
    stats = []
    for r in range(S.shape[0]):
        s, i, st = _select_model(S[r], n)
        np.testing.assert_array_equal(s, want_s[r].numpy())
        np.testing.assert_array_equal(i, want_i[r].numpy())
        stats.append(st)
    assert stats[0]["cut"] and stats[0]["passes"] == 0   # all equal
    if n < 2_000:   # more than ncap ties at the top value
        assert stats[1]["cut"] and stats[1]["passes"] >= 1
    assert not bool(np.signbit(want_s[2][want_i[2] >= 0].numpy()).any())
    assert (want_i[3] >= 0).sum() <= 60 and (want_i[3, 60:] == -1).all()
    assert stats[9]["first_share"] < 0.5      # the digit splits them
    # a fixed first digit (bits 24-31) would put them all in one bin
    top = _ord(S[9][S[9] > tk.NEG_INF]) >> 24
    assert len(np.unique(top)) == 1


def test_select_model_passes_at_the_ranking_shape():
    """At (g)'s width (20,000 items, n = 1000) a random model's row and a
    trained-like row each take one or two shared-memory passes before the
    candidates fit the 1,024-key sort buffer; the trained row's first
    digit puts under 1% of its keys in any one bin."""
    case = _case(12, 20_000, 16, 5)
    S = _scores(*case)
    for r in range(5, 12):
        _, _, st = _select_model(S[r], 1000)
        assert 1 <= st["passes"] <= 2 and st["candidates"] <= 1024
    assert _select_model(S[9], 1000)[2]["first_share"] < 0.01


def test_select_model_matches_the_jax_scorer():
    """The model's scores are JAX's XLA CatalogScorer's within rtol 1e-5 /
    atol 1e-6 (another summation order), and its ids JAX's at every slot
    whose score is further than twice that from both neighbours."""
    rng = np.random.default_rng(11)
    n_users, n_items, k, n = 20, 700, 6, 200
    u = rng.normal(0, 1, (n_users, k)).astype(np.float32)
    i = rng.normal(0, 1, (n_items, k)).astype(np.float32)
    ub = rng.normal(0, 0.3, n_users).astype(np.float32)
    ib = rng.normal(0, 0.3, n_items).astype(np.float32)
    mu = np.float32(0.4)
    invalid = rng.random(n_items) < 0.05
    rated = rng.random((n_users, n_items)) < 0.1
    r, c = np.nonzero(rated)
    train = RatingMatrix.from_coo(r, c, np.ones(len(r), np.float32),
                                  n_users, n_items)
    indptr = np.concatenate([[0], np.cumsum(rated.sum(1))]).astype(np.int64)
    S = _scores(u, i, ub, ib, mu, invalid, indptr, c.astype(np.int32),
                np.arange(n_users))
    got = [_select_model(S[row], n)[:2] for row in range(n_users)]
    got_s, got_i = (np.stack(x) for x in zip(*got))
    js, ji = jr.CatalogScorer(train, np.zeros(n_users, bool), invalid,
                              n_users, n_items, user_block=8,
                              item_block=128).topk(
        JView(*(jnp.asarray(a) for a in (u, i, ub, ib, mu))), n)
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(got_s, js, rtol=1e-5, atol=1e-6)
    tol = 2 * (1e-6 + 1e-5 * np.abs(js))
    gap = js[:, :-1] - js[:, 1:]
    inf = np.full((n_users, 1), np.inf)
    held = (np.concatenate([inf, gap], 1) > tol) & (
        np.concatenate([gap, inf], 1) > tol)
    assert held.mean() > 0.9
    np.testing.assert_array_equal(got_i[held], ji[held])
