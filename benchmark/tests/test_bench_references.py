"""Each plain reference against the program on the CPU at a tiny size,
from the same inputs and seed: the reference works out again what the
program derives (stripes, shuffles, batch orders, draws, exclusions)."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from matfac_tpu_torch.config import Params
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.eval.ranking import CatalogScorer
from matfac_tpu_torch.models.base import EvalView, ModelMF
from matfac_tpu_torch.models.bpr import ModelMFBPR
from matfac_tpu_torch.serving import Recommender
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
from matfac_tpu_torch.solvers.bpr import BPRSolver
from matfac_tpu_torch.solvers.sgd import SGDSolver
from matfac_tpu_torch.utils import freq as ufreq

SEED = 2 ** 31 + 5


def ref(name):
    return harness.load_file(harness.BENCH / "reference" / f"{name}.py")


def bundle(config, **ch):
    cfg = json.loads((harness.BENCH / "configs" / f"{config}.json")
                     .read_text())
    cfg.update(ch)
    return harness.load_file(harness.BENCH / "data" /
                             f"{cfg['generator']}.py").make(cfg, SEED,
                                                            "cpu"), cfg


@pytest.fixture(scope="module")
def explicit():
    b, _ = bundle("ml20m-mf-k64", n_users=700, n_items=260,
                  n_ratings=25000)
    return b, harness.port_data(b)


@pytest.fixture(scope="module")
def implicit():
    b, cfg = bundle("ml10m-bpr-k64", n_users=300, n_items=150,
                    positives_per_user=25)
    return b, harness.port_data(b), cfg


def inputs(b, skip=1, k=8):
    u0, i0 = harness.job_factors(b["n_users"], b["n_items"], k, SEED, 0,
                                 "cpu")
    return dict(train=b["train"], val=b["val"], n_users=b["n_users"],
                n_items=b["n_items"], u0=u0, i0=i0, seed=SEED, skip=skip)


def program_epochs(solver, inp, lr, epochs, skip, decay=1.0):
    st = harness.job_state(inp["n_users"], inp["n_items"], 8, SEED, 0,
                           "cpu")
    for _ in range(skip):      # the warm-up's draws
        solver.epoch(harness.job_state(inp["n_users"], inp["n_items"], 8,
                                       SEED, -1, "cpu"), lr)
    out = []
    for _ in range(epochs):
        st = solver.epoch(st, lr)
        out.append((st.u_fac.clone(), st.i_fac.clone()))
        lr *= decay
    return out


def close(states, ref_states, tol):
    for (pu, pi), (ru, ri) in zip(states, ref_states):
        assert torch.allclose(pu, ru, atol=tol, rtol=tol)
        assert torch.allclose(pi, ri, atol=tol, rtol=tol)


def iu_ii(data):
    return ufreq.invalid_users_items(data.train_mat, data.n_users,
                                     data.n_items)


def test_stripes_follow_the_dense_engine(explicit):
    b, data = explicit
    p = Params(fac_dim=8, u_reg=0.002, i_reg=0.002, seed=SEED)
    iu, ii = iu_ii(data)
    # f32 products, so the two follow the same arithmetic
    solver = BlockSGDSolver(ModelMF(p, data.n_users, data.n_items), p,
                            data.train_mat, iu, ii, engine="dense", bu=None,
                            bi=None, mm_bf16=False, device="cpu")
    inp = inputs(b)
    hp = dict(lr=0.05, u_reg=0.002, i_reg=0.002)
    r = ref("mf_stripes").follow(inp, hp, 3)
    close(program_epochs(solver, inp, 0.05, 3, 1), r["states"], 1e-5)
    assert ref("mf_stripes").stripe_height(data.n_users, data.n_items) \
        == solver.bu


def test_batches_follow_the_scatter_engine(explicit):
    b, data = explicit
    p = Params(fac_dim=8, u_reg=0.002, i_reg=0.002, seed=SEED,
               batch_size=1024)
    iu, ii = iu_ii(data)
    solver = SGDSolver(ModelMF(p, data.n_users, data.n_items), p,
                       data.train_mat, iu, ii, device="cpu")
    inp = inputs(b, skip=2)
    hp = dict(lr=0.01, u_reg=0.002, i_reg=0.002, batch_size=1024)
    r = ref("mf_batches").follow(inp, hp, 3)
    close(program_epochs(solver, inp, 0.01, 3, 2), r["states"], 1e-6)


def test_bpr_follows_the_stream_engine(implicit):
    b, data, _ = implicit
    p = Params(fac_dim=8, u_reg=0.001, i_reg=0.001, seed=SEED,
               batch_size=512)
    iu, ii = iu_ii(data)
    solver = BPRSolver(ModelMFBPR(p, data.n_users, data.n_items), p,
                       data.train_mat, iu, ii, n_tries=2, device="cpu")
    inp = inputs(b, skip=1)
    hp = dict(lr=0.1, u_reg=0.001, i_reg=0.001, batch_size=512, n_tries=2)
    r = ref("bpr_stream").follow(inp, hp, 3)
    st = harness.job_state(data.n_users, data.n_items, 8, SEED, 0, "cpu")
    solver.epoch(harness.job_state(data.n_users, data.n_items, 8, SEED, -1,
                                   "cpu"), 0.1)
    lr, losses, states = 0.1, [], []
    for _ in range(3):
        st = solver.epoch(st, lr)
        states.append((st.u_fac.clone(), st.i_fac.clone()))
        losses.append(float(solver.last_loss))
        lr *= 0.9
    close(states, r["states"], 1e-6)
    assert np.allclose(losses, r["losses"], rtol=1e-5)


def test_checks_follow_the_evaluator(explicit, implicit):
    b, data = explicit
    p = Params(fac_dim=8, u_reg=0.002, i_reg=0.002)
    iu, ii = iu_ii(data)
    ev = Evaluator(data, iu, ii, p, "cpu")
    st = harness.job_state(data.n_users, data.n_items, 8, SEED, 3, "cpu")
    view = ModelMF(p, data.n_users, data.n_items).eval_view(st)
    e = ref("_eval")
    vu, vi = e.valid(b["train"], data.n_users, data.n_items)
    assert e.rmse(st.u_fac, st.i_fac, b["val"], vu, vi) == pytest.approx(
        ev.rmse(view, "val"), rel=1e-6)
    assert e.objective(st.u_fac, st.i_fac, b["train"], vu, vi, 0.002,
                       0.002) == pytest.approx(ev.objective(view, st),
                                               rel=1e-6)
    b, data, _ = implicit
    iu, ii = iu_ii(data)
    U, V = harness.load_file(harness.BENCH / "data" /
                             "implicit_softmax.py").serve_factors(
        dict(fac_dim=16), b, "cpu")
    z = lambda n: torch.zeros(n)
    view = EvalView(U, V, z(data.n_users), z(data.n_items), z(()))
    scorer = CatalogScorer(data.train_mat, iu, ii, data.n_users,
                           data.n_items, device="cpu")
    vu, vi = e.valid(b["train"], data.n_users, data.n_items)
    assert e.hr10(U, V, b["val"], b["train"], vu, vi) == pytest.approx(
        scorer.hit_rate(view, data.val_mat, 10))


def test_topn_follows_the_recommender(implicit):
    b, data, cfg = implicit
    U, V = harness.load_file(harness.BENCH / "data" /
                             "implicit_softmax.py").serve_factors(
        dict(fac_dim=16), b, "cpu")
    z = lambda n: torch.zeros(n)
    rec = Recommender(EvalView(U, V, z(data.n_users), z(data.n_items),
                               z(())), data.train_mat, data.n_users,
                      data.n_items)
    users = np.array([5, 0, 299, 17, 42])
    ids, sc = rec.recommend(users, 10)
    inp = dict(U=U, V=V, train=b["train"], n_users=data.n_users,
               n_items=data.n_items)
    rs, ri = ref("topn").serve(inp, torch.from_numpy(users), 10)
    assert np.array_equal(ids, ri.numpy())
    assert np.allclose(sc, rs.numpy(), rtol=1e-6, atol=1e-6)
    best, at = ref("topn").follow(inp, torch.from_numpy(users),
                                  torch.from_numpy(ids), 10)
    assert torch.allclose(best, at)
