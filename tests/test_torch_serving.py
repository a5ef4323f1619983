"""The port's Recommender (matfac_tpu_torch.serving) against the JAX
Recommender's XLA path on the same view, and on a text checkpoint written
by the JAX package. Scores at rtol 1e-5 / atol 1e-6 (f32 dot products
summed in another order); ids exactly, on data without near-ties."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import leave_one_out_data
from matfac_tpu.models.base import EvalView as JView
from matfac_tpu.models.base import MFState as JState
from matfac_tpu.serving import Recommender as JRecommender
from matfac_tpu.train import checkpoint as jckpt
from matfac_tpu_torch.models.base import EvalView
from matfac_tpu_torch.serving import Recommender

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(seed=3):
    data = leave_one_out_data(n_users=50, n_items=40, per_user=10,
                              seed=seed, structured=True)
    rng = np.random.default_rng(seed)
    leaves = tuple(np.asarray(a, np.float32) for a in (
        rng.normal(0, 1, (50, 6)), rng.normal(0, 1, (40, 6)),
        rng.normal(0, 0.3, 50), rng.normal(0, 0.3, 40), np.asarray(-0.2)))
    return data, leaves


def test_recommend_matches_jax_xla_path():
    data, leaves = _case()
    jrec = JRecommender(JView(*(jnp.asarray(a) for a in leaves)),
                        data.train_mat, data.n_users, data.n_items,
                        user_block=16, item_block=16, use_pallas=False)
    trec = Recommender(EvalView(*(torch.from_numpy(a.copy())
                                  for a in leaves)),
                       data.train_mat, data.n_users, data.n_items,
                       user_block=16, item_block=16, use_pallas=False)
    users = [0, 7, 33, 7, 49]
    for n in (1, 5, 35):   # 35: past every user's scorable items
        ji, js = jrec.recommend(users, n=n)
        ti, ts = trec.recommend(users, n=n)
        assert ti.dtype == np.int64 and ti.shape == (len(users), n)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    for j, u in enumerate(users):
        assert not set(data.train_mat.row(u)[0]) & set(ti[j])
    for bad in ([data.n_users], [-1]):
        with pytest.raises(ValueError, match="out of range"):
            trec.recommend(bad)


def test_from_checkpoint_reads_a_jax_text_checkpoint(tmp_path):
    data, leaves = _case(seed=4)
    p = Params(fac_dim=6, u_reg=0.02, i_reg=0.03, learn_rate=0.01, seed=1)
    sig = jckpt.model_signature(p, data.n_users, data.n_items)
    prefix = str(tmp_path / "jax")
    jckpt.save_facs(JState(*(jnp.asarray(a) for a in leaves)), prefix, sig)
    jrec = JRecommender.from_checkpoint(prefix, p, data, user_block=16,
                                        item_block=16, use_pallas=False)
    trec = Recommender.from_checkpoint(prefix, p, data, device="cpu",
                                       user_block=16, item_block=16)
    users = list(range(0, data.n_users, 3))
    ji, js = jrec.recommend(users, n=8)
    ti, ts = trec.recommend(users, n=8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    with pytest.raises(FileNotFoundError):
        Recommender.from_checkpoint(str(tmp_path / "nope"), p, data,
                                    device="cpu")


def test_replacing_the_view_serves_the_new_factors():
    """The prepared copy is keyed on the view's identity."""
    data, leaves = _case()
    view = EvalView(*(torch.from_numpy(a.copy()) for a in leaves))
    rec = Recommender(view, data.train_mat, data.n_users, data.n_items)
    first = rec.recommend([3, 4], n=6)
    other = view._replace(i_fac=-view.i_fac)
    rec.view = other
    got = rec.recommend([3, 4], n=6)
    want = Recommender(other, data.train_mat, data.n_users,
                       data.n_items).recommend([3, 4], n=6)
    np.testing.assert_array_equal(got[0], want[0])
    assert not np.array_equal(got[0], first[0])
