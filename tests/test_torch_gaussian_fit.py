"""The port's Gaussian-MF CAVI slice as a whole against the JAX package:
init state, flat sweeps (float64, 1e-10) in every covariance / bias mode,
blocked sweeps over the hybrid layout (tail + dense head, kernels' plain
versions; float64 against the JAX flat sweep at 1e-8), evaluation, and
``GaussianMF.fit`` with its validation history and early stop.

The float64 cases centre the ratings by a mean rounded to 1/8, so the
head's bf16 ``x_hi`` + ``x_lo`` planes hold every cell sum exactly."""

import numpy as np
import pytest
import torch

from pmf_tpu.data.coo import build_eval_set as j_build_eval_set
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.models import gaussian_mf as jg
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.data.coo import build_eval_set as t_build_eval_set
from pmf_tpu_torch.data.coo import build_ratings as t_build_ratings
from pmf_tpu_torch.models import gaussian_mf as tg

torch.set_num_threads(1)

N_USERS, N_ITEMS = 120, 80
HYPER = dict(sigma2=0.5, eta_theta2=0.4, eta_beta2=0.4, eta_bias2=0.7)


def _cfgs(**kw):
    kw = dict(n_factors=5, verbose=False, **HYPER, **kw)
    return jg.GaussianMFConfig(**kw), tg.GaussianMFConfig(**kw)


def _hyper():
    return (HYPER["sigma2"], HYPER["eta_theta2"], HYPER["eta_beta2"],
            HYPER["eta_bias2"])


def _centred64(small_ratings):
    u, i, x = small_ratings
    return u, i, x - np.round(x.mean() * 8) / 8


@pytest.mark.parametrize("covariance", ["full", "diag"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_state_matches_jax_bitwise(covariance, dtype):
    jcfg, tcfg = _cfgs(covariance=covariance, dtype=dtype)
    js = jg.init_state(30, 20, jcfg)
    ts = tg.init_state(30, 20, tcfg, device="cpu")
    assert set(ts) == set(js) == set(tg.STATE_KEYS)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
    back = tg.state_to_numpy(tg.state_from_numpy(
        {k: np.asarray(v) for k, v in js.items()}, device="cpu"))
    for k in js:
        np.testing.assert_array_equal(back[k], np.asarray(js[k]))


CASES = [(cov, bias, upd) for cov in ("full", "diag") for bias in (True, False)
         for upd in ("exact", "lagged")]


@pytest.mark.parametrize("covariance,use_bias,bias_update", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_flat_sweep_matches_jax_float64(small_ratings, covariance, use_bias,
                                        bias_update):
    u, i, x = _centred64(small_ratings)
    jcfg, tcfg = _cfgs(covariance=covariance, use_bias=use_bias,
                       bias_update=bias_update, dtype="float64")
    jflat = j_build_ratings(u, i, x, n_users=N_USERS, n_items=N_ITEMS,
                            dtype=np.float64)
    tflat = t_build_ratings(u, i, x, n_users=N_USERS, n_items=N_ITEMS,
                            dtype=np.float64, device="cpu")
    js = jg.init_state(N_USERS, N_ITEMS, jcfg)
    ts = tg.init_state(N_USERS, N_ITEMS, tcfg, device="cpu")
    for _ in range(3):
        js = jg.sweep(js, jflat, *_hyper(), 5, use_bias, covariance, bias_update)
        ts = tg.sweep(ts, tflat, *_hyper(), use_bias, covariance, bias_update)
    for k in js:
        assert ts[k].dtype == torch.float64
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-10,
                                   atol=1e-12, err_msg=k)


BLOCKED = [("full", "exact"), ("full", "lagged"), ("diag", "exact")]


@pytest.mark.parametrize("head", [(16, 24), [(0, 8, 40), (8, 24, 12)]],
                         ids=["one_tier", "staircase"])
@pytest.mark.parametrize("covariance,bias_update", BLOCKED,
                         ids=["exact", "lagged", "diag"])
def test_sweep_blocked_float64_matches_jax_flat(small_ratings, head, covariance,
                                                bias_update):
    u, i, x = _centred64(small_ratings)
    jcfg, tcfg = _cfgs(covariance=covariance, bias_update=bias_update,
                       dtype="float64")
    jflat = j_build_ratings(u, i, x, n_users=N_USERS, n_items=N_ITEMS,
                            dtype=np.float64)
    tflat = t_build_ratings(u, i, x, n_users=N_USERS, n_items=N_ITEMS,
                            dtype=np.float64, device="cpu")
    tb = t_build_blocked(u, i, x, n_users=N_USERS, n_items=N_ITEMS,
                         dtype=np.float64, reorder=True, head=head, head_r0=4,
                         device="cpu")
    assert tb.head is not None
    js = jg.init_state(N_USERS, N_ITEMS, jcfg)
    ts = tg.init_state(N_USERS, N_ITEMS, tcfg, device="cpu")
    for _ in range(3):
        js = jg.sweep(js, jflat, *_hyper(), 5, True, covariance, bias_update)
        ts = tg.sweep_blocked(ts, tb, tflat.user_counts, tflat.item_counts,
                              *_hyper(), True, covariance, bias_update)
    for k in js:
        assert ts[k].dtype == torch.float64
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-8,
                                   atol=1e-10, err_msg=k)


def test_blocked_lagged_diag_is_refused(small_ratings):
    u, i, x = small_ratings
    tflat = t_build_ratings(u, i, x, device="cpu")
    tb = t_build_blocked(u, i, x, reorder=True, device="cpu")
    _, tcfg = _cfgs(covariance="diag")
    ts = tg.init_state(tflat.n_users, tflat.n_items, tcfg, device="cpu")
    with pytest.raises(ValueError, match="lagged"):
        tg.sweep_blocked(ts, tb, tflat.user_counts, tflat.item_counts, *_hyper(),
                         True, "diag", "lagged")


@pytest.mark.parametrize("use_bias", [True, False])
def test_eval_metrics_match_jax(small_splits, use_bias):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    jcfg, tcfg = _cfgs(dtype="float64")
    n_u, n_i = int(tu.max()) + 1, int(ti.max()) + 1
    rng = np.random.default_rng(5)
    js = {k: np.asarray(v) for k, v in jg.init_state(n_u, n_i, jcfg).items()}
    js["b_user"] = rng.standard_normal(n_u)
    js["b_item"] = rng.standard_normal(n_i)
    # Include out-of-range rows: they are masked out of both metrics.
    vu = np.concatenate([vu, [n_u + 3]])
    vi = np.concatenate([vi, [0]])
    vx = np.concatenate([vx, [2.0]])
    jev = j_build_eval_set(vu, vi, vx, n_u, n_i, dtype=np.float64)
    tev = t_build_eval_set(vu, vi, vx, n_u, n_i, dtype=np.float64, device="cpu")
    ref = jg.eval_metrics(js, jev, use_bias)
    got = tg.eval_metrics(tg.state_from_numpy(js, device="cpu"), tev, use_bias)
    for g, r in zip(got, ref):
        assert float(g) == pytest.approx(float(r), rel=1e-12)


def _splits(small_splits):
    (tu, ti, tx), (vu, vi, vx), (su, si, sx) = small_splits
    mean = float(tx.mean())
    return (tu, ti, tx - mean), (vu, vi, vx - mean), (su, si, sx - mean), mean


@pytest.mark.parametrize("engine", ["blocked_high", "flat"])
def test_fit_history_matches_jax(small_splits, engine):
    train, val, test, mean = _splits(small_splits)
    jcfg, tcfg = _cfgs(max_iter=30, tol=1e-4, engine=engine)
    jm = jg.GaussianMF(jcfg).fit(train, val, global_mean=mean)
    tm = tg.GaussianMF(tcfg).fit(train, val, global_mean=mean, device="cpu")
    assert tm.engine_used == engine
    # Same stop iteration (the Gaussian rule stops on 0 <= improvement < tol).
    assert len(tm.fit_history) == len(jm.fit_history) < 30
    for t_rec, j_rec in zip(tm.fit_history, jm.fit_history):
        assert t_rec["iteration"] == j_rec["iteration"]
        assert abs(t_rec["val_rmse"] - j_rec["val_rmse"]) < 1e-4
        assert abs(t_rec["val_macro_mae"] - j_rec["val_macro_mae"]) < 1e-4
        assert t_rec["updates_per_sec"] > 0
    np.testing.assert_allclose(tm.predict(test[0], test[1], mean),
                               jm.predict(test[0], test[1], mean), rtol=1e-3,
                               atol=1e-4)
    assert tm.evaluate_rmse(test, mean) == pytest.approx(
        jm.evaluate_rmse(test, mean), abs=1e-4)
    assert tm.evaluate_macro_mae(test, mean) == pytest.approx(
        jm.evaluate_macro_mae(test, mean), abs=1e-4)


def test_fit_without_val_runs_max_iter_and_predicts_global_mean_out_of_range(
        small_splits):
    train, _, _, mean = _splits(small_splits)
    _, tcfg = _cfgs(max_iter=3, engine="blocked_high")
    m = tg.GaussianMF(tcfg).fit(train, global_mean=mean, device="cpu")
    assert [r["iteration"] for r in m.fit_history] == [1, 2, 3]
    assert m.n_sweeps == 3 and m.global_mean == mean
    assert all(np.all(np.isfinite(v)) for v in tg.state_to_numpy(m.state).values())
    pred = m.predict([0, 10_000, -1], [0, 0, 3], global_mean=mean)
    assert pred[0] != mean and pred[1] == mean and pred[2] == mean
    assert np.isnan(m.evaluate_rmse(([10_000], [0], [1.0]), mean))
