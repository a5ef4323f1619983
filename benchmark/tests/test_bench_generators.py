"""The device generators' marginals at a small size against the program's
own host generators (matfac_tpu_torch.data.synthetic), which they follow
without matching bit for bit."""

import json

import numpy as np
import torch

from benchmark import harness
from matfac_tpu_torch.data.synthetic import (leave_one_out_data,
                                             low_rank_ratings)


def _config(name, **ch):
    cfg = json.loads((harness.BENCH / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(ch)
    return cfg


def test_explicit_ratings_marginals():
    cfg = _config("ml20m-mf-k64", n_users=3000, n_items=800,
                  n_ratings=120000)
    b = harness.load_file(harness.BENCH / "data" / "explicit_lowrank.py"
                          ).make(cfg, 12345, "cpu")
    parts = [b[s] for s in ("train", "val", "test")]
    rows = torch.cat([p[0] for p in parts]).numpy()
    cols = torch.cat([p[1] for p in parts]).numpy()
    vals = torch.cat([p[2] for p in parts]).numpy()
    assert len(vals) == cfg["n_ratings"]
    assert len(np.unique(rows.astype(np.int64) * 800 + cols)) == len(vals)
    a = cfg["assumed"]
    # the program's recipe, drawn until about as many distinct ratings
    mat, _, _ = low_rank_ratings(3000, 800, k=a["truth_rank"],
                                 density=0.055, seed=0, noise=a["noise"],
                                 power_law=a["item_power_law"], nonneg=True)
    ref = np.clip(np.round(mat.values / 0.5), 1, 10) * 0.5
    grid = np.arange(1, 11) * 0.5
    share = lambda v: np.array([(v == g).mean() for g in grid])
    assert np.abs(share(vals) - share(ref)).max() < 0.03
    # one seed's factors move the mean by about 0.1 (seeds 0-3 of both
    # recipes span 2.85-2.99)
    assert abs(vals.mean() - ref.mean()) < 0.25
    # item popularity: the share of the 10 and the 100 most rated items
    top = lambda c, m: np.sort(np.bincount(c, minlength=800))[::-1][:m].sum() \
        / len(c)
    _, rc, _ = mat.to_coo()
    for m in (10, 100):
        assert abs(top(cols, m) - top(rc, m)) < 0.02
    # the split's shares
    n = len(vals)
    assert abs(len(b["test"][0]) / n - a["test_share"]) < 0.01
    assert abs(len(b["val"][0]) / n - a["val_share"]) < 0.01
    tr = b["train"]
    key = tr[0] * 800 + tr[1]
    assert bool((key[1:] > key[:-1]).all())   # sorted by row, then column


def test_implicit_positives_marginals():
    cfg = _config("ml10m-bpr-k64", n_users=400, n_items=300,
                  positives_per_user=30)
    b = harness.load_file(harness.BENCH / "data" / "implicit_softmax.py"
                          ).make(cfg, 4242, "cpu")
    tr, va, te = b["train"], b["val"], b["test"]
    assert tr[0].numel() == 400 * 28
    assert torch.equal(va[0], torch.arange(400))
    assert torch.equal(te[0], torch.arange(400))
    # every user's 30 items distinct
    items = torch.cat([tr[1].reshape(400, 28), va[1][:, None],
                       te[1][:, None]], 1)
    assert bool((torch.sort(items, 1).values.diff(dim=1) > 0).all())
    data = leave_one_out_data(n_users=400, n_items=300, k=16, per_user=30,
                              seed=6, structured=True, temp=1.0)
    ref_cols = data.train_mat.indices
    # softmax draws at temperature 1 from rank-16 normal factors: how
    # concentrated a user's positives are, measured by the mean preference
    # rank of the held-out items, matches the program's recipe: the share
    # of all positives taken by the 30 most popular items
    top = lambda c: np.sort(np.bincount(c, minlength=300))[::-1][:30].sum() \
        / len(c)
    assert abs(top(tr[1].numpy()) - top(ref_cols)) < 0.03
    # the served factors: the preferences padded to rank k
    U, V = harness.load_file(harness.BENCH / "data" / "implicit_softmax.py"
                             ).serve_factors(cfg, b, "cpu")
    assert U.shape == (400, cfg["fac_dim"]) and V.shape == (300,
                                                           cfg["fac_dim"])
    assert torch.equal(U[:, :16], b["uf"])
    assert float(U[:, 16:].std()) < 0.02


def test_same_seed_same_data():
    cfg = _config("ml10m-bpr-k64", n_users=100, n_items=80,
                  positives_per_user=10)
    gen = harness.load_file(harness.BENCH / "data" / "implicit_softmax.py")
    a, b = gen.make(cfg, 2 ** 31 + 11, "cpu"), gen.make(cfg, 2 ** 31 + 11,
                                                          "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a["train"], b["train"]))
