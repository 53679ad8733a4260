"""The port's Gaussian ELBO against the JAX package's in float64 on a
state carried through JAX sweeps (rtol 1e-10), ``GaussianMF.fit``'s
``elbo_every`` history against the JAX fit's (rtol 1e-6), and the
monotone gate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.eval import elbo as jelbo
from pmf_tpu.models import gaussian_mf as jgmf
from pmf_tpu_torch.eval import elbo as telbo
from pmf_tpu_torch.eval.metrics import gaussian_log_predictive_likelihood
from pmf_tpu_torch.models import gaussian_mf as tgmf

torch.set_num_threads(1)

MODES = pytest.mark.parametrize("covariance", ["full", "diag"])
BIAS = pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "nobias"])


def _centred(u, i, x):
    return u, i, x - x.mean()


@MODES
@BIAS
@pytest.mark.parametrize("n_chunks", [8, 5])
def test_gaussian_elbo_matches_jax_float64(small_ratings, covariance, use_bias,
                                           n_chunks):
    u, i, x = _centred(*small_ratings)
    cfg = jgmf.GaussianMFConfig(n_factors=5, dtype="float64", verbose=False,
                                use_bias=use_bias, covariance=covariance)
    data = j_build_ratings(u, i, x, dtype=np.float64)
    state = jgmf.init_state(data.n_users, data.n_items, cfg)
    for _ in range(2):
        state = jgmf.sweep(state, data, cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2,
                           cfg.eta_bias2, cfg.n_factors, use_bias, covariance)
    hyper = (cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2, cfg.eta_bias2)
    want = float(jelbo.gaussian_elbo(
        state, jnp.asarray(u, jnp.int32), jnp.asarray(i, jnp.int32), jnp.asarray(x),
        *hyper, use_bias=use_bias, covariance=covariance, n_chunks=n_chunks))
    ts = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    got = telbo.gaussian_elbo(ts, torch.from_numpy(u), torch.from_numpy(i),
                              torch.from_numpy(x), *hyper, use_bias=use_bias,
                              covariance=covariance, n_chunks=n_chunks)
    assert got.dtype == torch.float64 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-10)


def test_kl_terms_match_jax():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((7, 4))
    a = rng.standard_normal((7, 4, 4))
    V = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(4)
    v = rng.uniform(0.1, 2.0, (7, 4))
    assert float(telbo._kl_gaussian_full(torch.from_numpy(m), torch.from_numpy(V), 0.7)) \
        == pytest.approx(float(jelbo._kl_gaussian_full(m, V, 0.7)), rel=1e-12)
    assert float(telbo._kl_gaussian_diag(torch.from_numpy(m), torch.from_numpy(v), 0.7)) \
        == pytest.approx(float(jelbo._kl_gaussian_diag(m, v, 0.7)), rel=1e-12)


@MODES
def test_fit_elbo_history_matches_jax(small_splits, covariance):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    mean = tx.mean()
    train, val = (tu, ti, tx - mean), (vu, vi, vx - mean)
    kw = dict(n_factors=4, max_iter=5, tol=None, verbose=False, dtype="float64",
              engine="flat", covariance=covariance)
    jm = jgmf.GaussianMF(jgmf.GaussianMFConfig(**kw)).fit(train, val, elbo_every=1)
    tm = tgmf.GaussianMF(tgmf.GaussianMFConfig(**kw)).fit(train, val, device="cpu",
                                                         elbo_every=1)
    got = [r["elbo"] for r in tm.fit_history]
    want = [r["elbo"] for r in jm.fit_history]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert all(b >= a for a, b in zip(got, got[1:]))
    assert tm.elbo(train) == pytest.approx(got[-1], rel=1e-12)


def test_fit_elbo_every_two_on_the_blocked_engine(small_splits):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    mean = tx.mean()
    kw = dict(n_factors=4, max_iter=4, tol=None, verbose=False, engine="blocked_high")
    tm = tgmf.GaussianMF(tgmf.GaussianMFConfig(**kw)).fit(
        (tu, ti, tx - mean), (vu, vi, vx - mean), device="cpu", elbo_every=2)
    assert ["elbo" in r for r in tm.fit_history] == [False, True, False, True]
    assert np.isfinite(tm.fit_history[-1]["elbo"])


def test_the_gate_raises_on_a_corrupted_sweep(small_splits, monkeypatch):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    mean = tx.mean()
    real_sweep = tgmf.sweep
    calls = []

    def corrupted(state, *args, **kw):
        calls.append(1)
        out = real_sweep(state, *args, **kw)
        if len(calls) == 3:  # sweep 3 scrambles the item means
            out = dict(out, m_beta=out["m_beta"].flip(0) * 3.0)
        return out

    monkeypatch.setattr(tgmf, "sweep", corrupted)
    cfg = tgmf.GaussianMFConfig(n_factors=4, max_iter=5, tol=None, verbose=False,
                                engine="flat")
    with pytest.raises(RuntimeError, match="ELBO decreased at iteration 3"):
        tgmf.GaussianMF(cfg).fit((tu, ti, tx - mean), (vu, vi, vx - mean),
                                 device="cpu", elbo_every=1)
    # Lagged biases are not gated: the same corruption passes.
    calls.clear()
    lagged = tgmf.GaussianMFConfig(n_factors=4, max_iter=5, tol=None, verbose=False,
                                   engine="flat", bias_update="lagged")
    tgmf.GaussianMF(lagged).fit((tu, ti, tx - mean), (vu, vi, vx - mean),
                                device="cpu", elbo_every=1)


def test_gaussian_log_predictive_likelihood_matches_jax():
    from pmf_tpu.eval.metrics import gaussian_log_predictive_likelihood as jglpl

    rng = np.random.default_rng(0)
    y, p = rng.standard_normal(50), rng.standard_normal(50)
    assert gaussian_log_predictive_likelihood(y, p, 0.8) == jglpl(y, p, 0.8)
