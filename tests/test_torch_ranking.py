"""The port's serving path against the JAX package's on the CPU: top-k
recommendation with train-item exclusion and item bias, the exclusion
indices, and both ranking metrics.  Scores are random float32 factors,
free of ties, so the two packages' top-k orders compare item for item."""

import importlib

import numpy as np
import pytest
import torch

from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu_torch.data.coo import build_ratings as t_build_ratings
from pmf_tpu_torch.eval import ranking as trank
from pmf_tpu_torch.eval import recommend as trec

torch.set_num_threads(1)

# pmf_tpu.eval's package namespace rebinds these names to functions.
jrank = importlib.import_module("pmf_tpu.eval.ranking")
jrec = importlib.import_module("pmf_tpu.eval.recommend")


def _factors(n_users, n_items, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_users, k)).astype(np.float32),
            rng.standard_normal((n_items, k)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("batch", [16, 1024])
@pytest.mark.parametrize("with_bias", [False, True], ids=["dot", "bias"])
def test_recommend_matches_jax(small_splits, batch, with_bias):
    (tu, ti, _), _, _ = small_splits
    n_users, n_items = int(tu.max()) + 1, int(ti.max()) + 1
    theta, beta = _factors(n_users, n_items, 6, seed=3)
    rng = np.random.default_rng(4)
    kw = {}
    if with_bias:
        kw = dict(item_bias=rng.standard_normal(n_items).astype(np.float32),
                  user_bias=rng.standard_normal(n_users).astype(np.float32),
                  mean=3.25)
    users = rng.choice(n_users, size=57, replace=False)
    j_items, j_scores = jrec.recommend(theta, beta, users, k=7, train_u=tu,
                                       train_i=ti, batch=batch, **kw)
    t_kw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    t_items, t_scores = trec.recommend(_t(theta), _t(beta), users, k=7, train_u=tu,
                                       train_i=ti, batch=batch, **t_kw)
    np.testing.assert_array_equal(t_items, j_items)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5, atol=1e-5)
    assert t_items.dtype == np.int64 and t_scores.dtype == np.float32
    for row, u in enumerate(users):
        assert not set(t_items[row]) & set(ti[tu == u])


def test_gaussian_model_recommend_ranks_with_item_bias(small_splits):
    """The Gaussian model's serving score (``_score_offsets``) adds the
    item bias to the ranking and the mean and user bias to the scores."""
    from pmf_tpu.models.gaussian_mf import GaussianMF as JG, GaussianMFConfig as JC
    from pmf_tpu_torch.models.gaussian_mf import GaussianMF as TG
    from pmf_tpu_torch.models.gaussian_mf import GaussianMFConfig as TC

    (tu, ti, tx), _, _ = small_splits
    mean = float(tx.mean())
    train = (tu, ti, tx - mean)
    jm = JG(JC(n_factors=4, max_iter=3, tol=None, verbose=False)).fit(
        train, global_mean=mean)
    tm = TG(TC(n_factors=4, max_iter=3, tol=None, verbose=False))
    tm.n_users, tm.n_items, tm.global_mean = jm.n_users, jm.n_items, mean
    tm.state = {k: _t(np.asarray(v)) for k, v in jm.state.items()}
    users = np.arange(0, jm.n_users, 5)
    j_items, j_scores = jm.recommend(users, k=6, train=train)
    t_items, t_scores = tm.recommend(users, k=6, train=train)
    np.testing.assert_array_equal(t_items, j_items)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5, atol=1e-5)
    # The reported score is predict()'s.
    np.testing.assert_allclose(
        t_scores[:, 0], tm.predict(users, t_items[:, 0], global_mean=mean),
        rtol=1e-5)


def test_recommend_without_train_and_with_a_prebuilt_index(small_splits):
    (tu, ti, _), _, _ = small_splits
    n_users, n_items = int(tu.max()) + 1, int(ti.max()) + 1
    theta, beta = _factors(n_users, n_items, 5, seed=8)
    users = np.arange(n_users)
    j_items, _ = jrec.recommend(theta, beta, users, k=4)
    t_items, _ = trec.recommend(_t(theta), _t(beta), users, k=4)
    np.testing.assert_array_equal(t_items, j_items)
    idx = trec.build_exclusion_index(tu, ti, n_users=n_users, device="cpu")
    got = trec.recommend(_t(theta), _t(beta), users, k=4, train_index=idx, batch=33)
    want = jrec.recommend(theta, beta, users, k=4, train_u=tu, train_i=ti)
    np.testing.assert_array_equal(got[0], want[0])


def test_recommend_cold_user_above_trained_range():
    theta, beta = _factors(12, 9, 3, seed=7)
    tu = np.array([0, 0, 1, 2, 2, 5])  # max trained user 5 < 12 rows
    ti = np.array([1, 3, 0, 4, 5, 2])
    t_idx = trec.build_exclusion_index(tu, ti, device="cpu")  # n_users 6
    j_idx = jrec.build_exclusion_index(tu, ti)
    t_items, t_scores = trec.recommend(_t(theta), _t(beta), [5, 11], k=4,
                                       train_index=t_idx)
    j_items, j_scores = jrec.recommend(theta, beta, [5, 11], k=4, train_index=j_idx)
    np.testing.assert_array_equal(t_items, j_items)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-6)
    assert 2 not in t_items[0]


def test_out_of_range_users_and_train_ids_raise():
    theta, beta = _factors(10, 8, 3, seed=1)
    for users in ([3, 11], [-1]):
        with pytest.raises(ValueError, match="user ids out of range"):
            trec.recommend(_t(theta), _t(beta), users, k=2)
    with pytest.raises(ValueError, match="train user ids out of range"):
        trec.build_exclusion_index(np.array([0, 3, 7]), np.array([1, 2, 3]),
                                   n_users=5, device="cpu")
    with pytest.raises(ValueError, match="train user ids out of range"):
        trec.build_exclusion_index(np.array([-1, 0]), np.array([0, 1]), n_users=5,
                                   device="cpu")
    # Item ids past the catalogue: the JAX scatter drops them silently;
    # the port refuses them.
    with pytest.raises(ValueError, match="train item ids out of range"):
        trec.recommend(_t(theta), _t(beta), [0], k=2, train_u=np.array([0]),
                       train_i=np.array([8]))


def test_exclusion_index_from_coo_equals_the_built_one(small_ratings):
    u, i, x = small_ratings
    t_coo = t_build_ratings(u, i, x, device="cpu")
    rp_coo, ti_coo = trec.exclusion_index_from_coo(t_coo)
    rp, ti_built = trec.build_exclusion_index(u, i, n_users=t_coo.n_users,
                                              device="cpu")
    np.testing.assert_array_equal(rp_coo, rp)
    np.testing.assert_array_equal(ti_coo[: len(u)].numpy(), ti_built.numpy())
    j_rp, j_ti = jrec.exclusion_index_from_coo(j_build_ratings(u, i, x))
    np.testing.assert_array_equal(rp_coo, j_rp)
    np.testing.assert_array_equal(ti_coo.numpy(), np.asarray(j_ti))
    j_rp2, j_ti2 = jrec.build_exclusion_index(u, i, n_users=t_coo.n_users)
    np.testing.assert_array_equal(rp, j_rp2)
    np.testing.assert_array_equal(ti_built.numpy(), np.asarray(j_ti2))


@pytest.mark.parametrize("counts", [[3, 0, 5, 1], [0, 0, 0, 0], [200, 56]])
def test_device_mask_equals_jax(counts):
    rng = np.random.default_rng(len(counts))
    cnt = np.asarray(counts, np.int32)
    lo = rng.integers(0, 50, len(cnt)).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
    ti = rng.integers(0, 99, 300).astype(np.int32)
    total = int(cnt.sum())
    cap = trec._round_pow2(max(total, 1))
    j_u, j_i = jrec._device_mask(lo, off, cnt, ti, cap, len(cnt))
    t_u, t_i = trec._device_mask(_t(lo).long(), _t(off).long(), _t(cnt).long(),
                                 _t(ti), cap, len(cnt), total)
    np.testing.assert_array_equal(t_u.numpy(), np.asarray(j_u))
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))


def test_sort_key_orders_as_float_compare():
    vals = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, 7.5, np.inf],
                    dtype=np.float32)
    u = np.array([0, 1, 2])
    uu, vv = np.meshgrid(u, vals, indexing="ij")
    uu, vv = uu.ravel(), vv.ravel()
    keys = trank._sort_key(_t(uu), _t(vv)).numpy()
    for a in range(len(keys)):
        for b in range(len(keys)):
            want = (uu[a], vv[a]) > (uu[b], vv[b]) if uu[a] != uu[b] else vv[a] > vv[b]
            assert (keys[a] > keys[b]) == want, (uu[a], vv[a], uu[b], vv[b])


def _pairs(n_users, n_items, seed, per_user=12, n_train=8):
    rng = np.random.default_rng(seed)
    train_u, train_i, test_u, test_i = [], [], [], []
    for u in range(n_users):
        items = rng.choice(n_items, size=per_user, replace=False)
        train_u += [u] * n_train
        train_i += list(items[:n_train])
        n_test = 1 + (u % 3)
        test_u += [u] * n_test
        test_i += list(items[n_train : n_train + n_test])
    return (np.array(train_u), np.array(train_i), np.array(test_u),
            np.array(test_i))


@pytest.mark.parametrize("edge_chunk", [96, 4 << 20])
def test_ranking_metrics_equal_jax(edge_chunk):
    theta, beta = _factors(40, 60, 5, seed=0)
    train_u, train_i, test_u, test_i = _pairs(40, 60, seed=1)
    want = jrank.ranking_metrics(theta, beta, train_u, train_i, test_u, test_i,
                                 ks=(1, 10, 50), batch=7, edge_chunk=96)
    got = trank.ranking_metrics(_t(theta), _t(beta), train_u, train_i, test_u,
                                test_i, ks=(1, 10, 50), batch=7, edge_chunk=edge_chunk)
    assert got == want


def test_held_out_pair_also_in_train_ranks_at_least_one():
    """Its train copy may score an ulp above its threshold (another
    summation order) and subtract itself: the rank clamps to 1."""
    theta, beta = _factors(20, 30, 4, seed=6)
    train_u, train_i, test_u, test_i = _pairs(20, 30, seed=7)
    got = trank.ranking_metrics(_t(theta), _t(beta), np.append(train_u, test_u),
                                np.append(train_i, test_i), test_u, test_i,
                                ks=(1,))
    assert got["mean_rank"] >= 1.0 and got["n_pairs"] == len(test_u)


def test_ranking_metrics_empty_and_perfect():
    theta, beta = _factors(10, 30, 4, seed=2)
    empty = np.array([], np.int64)
    got = trank.ranking_metrics(_t(theta), _t(beta), empty, empty, empty, empty,
                                ks=(10,))
    assert got["n_pairs"] == 0 and np.isnan(got["mean_rank"])
    theta = np.eye(10, 4, dtype=np.float32)
    beta = np.zeros((30, 4), np.float32)
    beta[:10] = theta * 10
    got = trank.ranking_metrics(_t(theta), _t(beta), np.array([0]), np.array([29]),
                                np.arange(10), np.arange(10), ks=(1,))
    assert got["recall@1"] == 1.0 and got["ndcg@1"] == 1.0


@pytest.mark.parametrize("n_items,seed", [(60, 0), (12, 5)], ids=["sparse", "dense"])
def test_sampled_ranking_metrics_equal_jax(n_items, seed):
    theta, beta = _factors(30, n_items, 4, seed=seed)
    train_u, train_i, test_u, test_i = _pairs(30, n_items, seed=seed + 1,
                                              per_user=n_items - 2,
                                              n_train=n_items - 5)
    kw = dict(n_negatives=20, seed=3, ks=(5, 10), batch=13)
    want = jrank.sampled_ranking_metrics(theta, beta, train_u, train_i, test_u,
                                         test_i, **kw)
    got = trank.sampled_ranking_metrics(_t(theta), _t(beta), train_u, train_i,
                                        test_u, test_i, **kw)
    assert got == want
    assert trank.sampled_ranking_metrics(_t(theta), _t(beta), train_u, train_i,
                                         test_u[:0], test_i[:0]) == {"n_pairs": 0}
