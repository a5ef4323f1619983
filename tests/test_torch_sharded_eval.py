"""The port's mesh-sharded eval against its single-device eval and JAX's
sharded eval on the CPU (case for case tests/test_sharded_eval.py): user
blocks cut over the shards give the single-device top-N exactly (HR and
ARHR equal), COO slices give RMSE and the objective to f32 summation
order; a 2-D mesh shards over all of its shards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matfac_tpu.config import Params as JParams
from matfac_tpu.eval.metrics import Evaluator as JEvaluator
from matfac_tpu.eval.ranking import CatalogScorer as JCatalogScorer
from matfac_tpu.models.base import ModelMF as JModelMF
from matfac_tpu.models.base import init_state as j_init_state
from matfac_tpu.parallel.mesh import make_mesh as j_make_mesh

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.eval.ranking import CatalogScorer
from matfac_tpu_torch.models.base import ModelMF, state_from_numpy
from matfac_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")


class _Bundle:
    def __init__(self, train, test, val, n_users, n_items):
        self.train_mat, self.test_mat, self.val_mat = train, test, val
        self.n_users, self.n_items = n_users, n_items


def _split(n_users, n_items, seed):
    rng = np.random.default_rng(seed)
    nnz = n_users * 12
    r = rng.integers(0, n_users, nnz)
    c = rng.integers(0, n_items, nnz)
    v = rng.uniform(1, 5, nnz).astype(np.float32)
    key = r * n_items + c
    _, idx = np.unique(key, return_index=True)
    r, c, v = r[idx], c[idx], v[idx]
    n = len(r)
    cut, cut2 = int(n * 0.8), int(n * 0.9)
    perm = rng.permutation(n)

    def mat(sl):
        return RatingMatrix.from_coo(r[sl], c[sl], v[sl], n_users, n_items)

    return mat(perm[:cut]), mat(perm[cut:cut2]), mat(perm[cut2:])


@pytest.fixture(scope="module")
def setup():
    n_users, n_items, seed = 600, 300, 3
    train, test, _ = _split(n_users, n_items, seed)
    inval_u = np.zeros(n_users, bool)
    inval_i = np.zeros(n_items, bool)
    inval_u[::97] = True
    inval_i[::83] = True
    jparams = JParams(fac_dim=8, seed=seed)
    jstate = j_init_state(jparams, n_users, n_items)
    jview = JModelMF(jparams, n_users, n_items).eval_view(jstate)
    params = Params(fac_dim=8, seed=seed)
    state = state_from_numpy(*(np.asarray(a) for a in jstate), device="cpu")
    view = ModelMF(params, n_users, n_items).eval_view(state)
    return dict(train=train, test=test, iu=inval_u, ii=inval_i,
                params=params, jparams=jparams, state=state, view=view,
                jview=jview)


def _mesh8():
    return make_mesh(devices=[CPU] * 8)


def _scorers(S, mesh, jmesh=None):
    kw = dict(user_block=64, item_block=128)
    sc0 = CatalogScorer(S["train"], S["iu"], S["ii"], 600, 300,
                        device="cpu", **kw)
    sc1 = CatalogScorer(S["train"], S["iu"], S["ii"], 600, 300, mesh=mesh,
                        **kw)
    jsc = JCatalogScorer(S["train"], S["iu"], S["ii"], 600, 300,
                         mesh=jmesh or j_make_mesh(), **kw)
    return sc0, sc1, jsc


def test_sharded_topk_matches_single(setup):
    sc0, sc1, jsc = _scorers(setup, _mesh8())
    s0, i0 = sc0.topk(setup["view"], 10)
    s1, i1 = sc1.topk(setup["view"], 10)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)
    js, ji = jsc.topk(setup["jview"], 10)
    np.testing.assert_array_equal(i1, ji)


def test_sharded_hr_arhr_match(setup):
    S = setup
    sc0, sc1, jsc = _scorers(S, _mesh8())
    hr = sc1.hit_rate(S["view"], S["test"], 10)
    assert sc0.hit_rate(S["view"], S["test"], 10) == hr
    assert hr == pytest.approx(jsc.hit_rate(S["jview"], S["test"], 10),
                               abs=1e-6)
    ar = sc1.arhr(S["view"], S["test"], 50)
    assert sc0.arhr(S["view"], S["test"], 50) == ar
    assert abs(ar - jsc.arhr(S["jview"], S["test"], 50)) < 1e-6


def test_sharded_padded_row_fallback(setup):
    """JAX's padded-row exclusion path (forced by its skew guard): the
    port, which excludes from the CSR rows on every path, gives its top-N
    and HR on the mesh."""
    S = setup
    sc0, sc1, jsc = _scorers(S, _mesh8())
    jsc._use_coo = False
    s1, i1 = sc1.topk(S["view"], 10)
    js, ji = jsc.topk(S["jview"], 10)
    np.testing.assert_array_equal(i1, ji)
    assert sc1.hit_rate(S["view"], S["test"], 10) == pytest.approx(
        jsc.hit_rate(S["jview"], S["test"], 10), abs=1e-6)


def test_sharded_rmse_objective_match(setup):
    S = setup
    data = _Bundle(S["train"], S["test"], None, 600, 300)
    ev0 = Evaluator(data, S["iu"], S["ii"], S["params"], "cpu")
    ev1 = Evaluator(data, S["iu"], S["ii"], S["params"], mesh=_mesh8())
    jev = JEvaluator(data, S["iu"], S["ii"], S["jparams"], mesh=j_make_mesh())
    assert [ev1._shard_coo(ev1.train_coo)[j][2] for j in range(8)][-1] == \
        ev1.train_coo.rows.shape[0]
    for which in ("train", "test"):
        r0 = ev0.rmse(S["view"], which)
        r1 = ev1.rmse(S["view"], which)
        assert abs(r0 - r1) < 1e-6 * max(1.0, abs(r0))
        assert abs(r1 - jev.rmse(S["jview"], which)) < 1e-6 * max(1.0, r1)
    mview = ModelMF(S["params"], 600, 300).eval_view(S["state"])
    o0 = ev0.objective(mview, S["state"])
    o1 = ev1.objective(mview, S["state"])
    assert abs(o0 - o1) < 1e-5 * max(1.0, abs(o0))


def test_sharded_weighted_objective_match(setup):
    S = setup
    data = _Bundle(S["train"], S["test"], None, 600, 300)
    ev0 = Evaluator(data, S["iu"], S["ii"], S["params"], "cpu")
    ev1 = Evaluator(data, S["iu"], S["ii"], S["params"], mesh=_mesh8())
    w0 = 1.0 / (1.0 + ev0.train_coo.rows.to(torch.float32) % 7)
    w1 = 1.0 / (1.0 + ev1.train_coo.rows.to(torch.float32) % 7)
    o0 = ev0.objective(S["view"], S["state"], weights=w0)
    o1 = ev1.objective(S["view"], S["state"], weights=w1)
    assert abs(o0 - o1) < 1e-5 * max(1.0, abs(o0))
    jev = JEvaluator(data, S["iu"], S["ii"], S["jparams"], mesh=j_make_mesh())
    jw = 1.0 / (1.0 + jev.train_coo.rows.astype(jnp.float32) % 7)
    jst = j_init_state(S["jparams"], 600, 300)
    oj = jev.objective(S["jview"], jst, weights=jw)
    assert abs(o1 - oj) < 1e-5 * max(1.0, abs(oj))


def test_sharded_2d_mesh(setup):
    """A 2-D (4, 2) training mesh shards eval over all 8 shards."""
    S = setup
    mesh = make_mesh((4, 2), ("u", "i"), devices=[CPU] * 8)
    sc0, sc1, jsc = _scorers(S, mesh, j_make_mesh((4, 2), ("u", "i")))
    assert sc1.n_shards == 8
    hr = sc1.hit_rate(S["view"], S["test"], 10)
    assert sc0.hit_rate(S["view"], S["test"], 10) == hr
    assert hr == pytest.approx(jsc.hit_rate(S["jview"], S["test"], 10),
                               abs=1e-6)
    data = _Bundle(S["train"], S["test"], None, 600, 300)
    ev1 = Evaluator(data, S["iu"], S["ii"], S["params"], mesh=mesh)
    ev0 = Evaluator(data, S["iu"], S["ii"], S["params"], "cpu")
    assert len(ev1._shard_coo(ev1.test_coo)) == 8
    assert abs(ev0.rmse(S["view"], "test")
               - ev1.rmse(S["view"], "test")) < 1e-6
