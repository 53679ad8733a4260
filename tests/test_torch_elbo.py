"""Port ELBOs of the Poisson families against the JAX package in float64
on a carried-across state (rtol 1e-9), and the fit loop's ``elbo_every``
recording against the JAX fit's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.eval import elbo as jelbo
from pmf_tpu.models import hpf as jhpf
from pmf_tpu.models import poisson_mf as jpmf
from pmf_tpu_torch.eval import elbo as telbo
from pmf_tpu_torch.models import hpf as thpf
from pmf_tpu_torch.models import poisson_mf as tpmf
from pmf_tpu_torch.models.base import FitLoop, poisson_stop_rule

torch.set_num_threads(1)

VARIANTS = pytest.mark.parametrize("extended", [False, True],
                                   ids=["plain", "extended"])


def _edges(u, i, x):
    j = (jnp.asarray(u, jnp.int32), jnp.asarray(i, jnp.int32), jnp.asarray(x))
    t = (torch.from_numpy(u), torch.from_numpy(i), torch.from_numpy(x))
    return j, t


@VARIANTS
@pytest.mark.parametrize("n_chunks", [8, 3])
def test_poisson_elbo_matches_jax_float64(small_ratings, extended, n_chunks):
    u, i, x = small_ratings
    cfg = jpmf.PoissonMFConfig(n_factors=6, dtype="float64", verbose=False,
                               extended=extended)
    jd = j_build_ratings(u, i, x, dtype=np.float64)
    js = jpmf.init_state(jd.n_users, jd.n_items, cfg)
    for _ in range(2):
        js = jpmf.sweep(js, jd, cfg.a0, cfg.b0, extended)
    ts = tpmf.state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                               device="cpu")
    je, te = _edges(u, i, x)
    ref = float(jelbo.poisson_elbo(js, *je, cfg.a0, cfg.b0, extended=extended,
                                   n_chunks=n_chunks))
    got = telbo.poisson_elbo(ts, *te, cfg.a0, cfg.b0, extended=extended,
                             n_chunks=n_chunks)
    assert got.dtype == torch.float64 and np.isfinite(ref)
    np.testing.assert_allclose(float(got), ref, rtol=1e-9)


def test_hpf_elbo_matches_jax_float64(small_ratings):
    u, i, x = small_ratings
    x = x + 1.0
    cfg = jhpf.HPFConfig(n_factors=6, dtype="float64", verbose=False,
                         a=0.4, c=0.2, b_prime=1.5, d_prime=0.8)
    hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    jd = j_build_ratings(u, i, x, dtype=np.float64)
    js = jhpf.init_state(jd.n_users, jd.n_items, cfg)
    for _ in range(2):
        js = jhpf.sweep(js, jd, *hyper)
    ts = thpf.state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                               device="cpu")
    je, te = _edges(u, i, x)
    ref = float(jelbo.hpf_elbo(js, *je, *hyper))
    got = telbo.hpf_elbo(ts, *te, *hyper)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), ref, rtol=1e-9)


def test_kl_gamma_and_auto_chunks_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.gamma(2.0, 1.0, size=(9, 4)), rng.gamma(2.0, 1.0, size=(9, 4))
    ref = float(jelbo._kl_gamma(jnp.asarray(a), jnp.asarray(b), 0.3, 1.7))
    got = float(telbo._kl_gamma(torch.from_numpy(a), torch.from_numpy(b), 0.3, 1.7))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert float(telbo._kl_gamma(torch.full((3,), 0.3, dtype=torch.float64),
                                 torch.full((3,), 1.7, dtype=torch.float64),
                                 0.3, 1.7)) == pytest.approx(0.0, abs=1e-12)
    for nnz, w in ((10, 20), (25_000_000, 20), (5_000_000, 1), (1 << 20, 400)):
        assert telbo._auto_chunks(nnz, w) == jelbo._auto_chunks(nnz, w)


@VARIANTS
def test_fit_records_elbo_on_the_jax_fits_iterations(small_splits, extended):
    train, val, _ = small_splits
    kw = dict(n_factors=6, max_iter=7, tol=None, verbose=False, engine="flat",
              extended=extended, dtype="float64")
    jm = jpmf.PoissonMF(jpmf.PoissonMFConfig(**kw)).fit(train, val, elbo_every=2)
    tm = tpmf.PoissonMF(tpmf.PoissonMFConfig(**kw)).fit(train, val, device="cpu",
                                                        elbo_every=2)
    j_its = [r["iteration"] for r in jm.fit_history if "elbo" in r]
    t_its = [r["iteration"] for r in tm.fit_history if "elbo" in r]
    assert t_its == j_its == [2, 4, 6]
    for t_rec, j_rec in zip(tm.fit_history, jm.fit_history):
        if "elbo" in j_rec:
            np.testing.assert_allclose(t_rec["elbo"], j_rec["elbo"], rtol=1e-9)
    np.testing.assert_allclose(tm.elbo(train), jm.elbo(train), rtol=1e-9)


def test_hpf_fit_records_elbo(small_splits):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    train, val = (tu, ti, tx + 1.0), (vu, vi, vx + 1.0)
    kw = dict(n_factors=5, max_iter=4, tol=None, verbose=False, engine="flat",
              dtype="float64")
    jm = jhpf.HPF(jhpf.HPFConfig(**kw)).fit(train, val, elbo_every=3)
    tm = thpf.HPF(thpf.HPFConfig(**kw)).fit(train, val, device="cpu", elbo_every=3)
    assert [("elbo" in r) for r in tm.fit_history] == [False, False, True, False]
    np.testing.assert_allclose(tm.fit_history[2]["elbo"], jm.fit_history[2]["elbo"],
                               rtol=1e-9)
    np.testing.assert_allclose(tm.elbo(train), jm.elbo(train), rtol=1e-9)
    # Without a validation set the loop records it too.
    tm2 = thpf.HPF(thpf.HPFConfig(**kw)).fit(train, device="cpu", elbo_every=2)
    assert [r["iteration"] for r in tm2.fit_history if "elbo" in r] == [2, 4]


def test_elbo_every_zero_leaves_the_loop_as_it_was(small_splits):
    train, val, _ = small_splits
    kw = dict(n_factors=4, max_iter=3, tol=None, verbose=False, engine="flat")
    a = tpmf.PoissonMF(tpmf.PoissonMFConfig(**kw)).fit(train, val, device="cpu")
    b = tpmf.PoissonMF(tpmf.PoissonMFConfig(**kw)).fit(train, val, device="cpu",
                                                       elbo_every=1)
    assert all("elbo" not in r for r in a.fit_history)
    assert all("elbo" in r for r in b.fit_history)
    assert [r["val_rmse"] for r in a.fit_history] == [r["val_rmse"] for r in b.fit_history]
    for k in a.state:
        torch.testing.assert_close(a.state[k], b.state[k], rtol=0, atol=0)


def test_elbo_monotone_gate_raises_on_a_decrease():
    values = iter([1.0, 2.0, 1.5])
    loop = FitLoop(lambda s, d: {"v": s["v"] + 1}, None, 3, None, poisson_stop_rule,
                   elbo_fn=lambda s: next(values), elbo_every=1, elbo_monotone=1e-6)
    with pytest.raises(RuntimeError, match="ELBO decreased at iteration 3"):
        loop.run({"v": torch.zeros(())}, None, None)
    assert [r["elbo"] for r in loop.history] == [1.0, 2.0]
    # Without the gate the same values are only recorded.
    values = iter([1.0, 2.0, 1.5])
    loop = FitLoop(lambda s, d: {"v": s["v"] + 1}, None, 3, None, poisson_stop_rule,
                   elbo_fn=lambda s: next(values), elbo_every=1)
    loop.run({"v": torch.zeros(())}, None, None)
    assert [r["elbo"] for r in loop.history] == [1.0, 2.0, 1.5]


def test_gaussian_model_has_no_elbo_yet(small_ratings):
    """The Gaussian ELBO is ported (tests/test_torch_gaussian_elbo.py);
    a model without one (HPF-MAP) still raises."""
    from pmf_tpu_torch.models.gaussian_mf import GaussianMF, GaussianMFConfig
    from pmf_tpu_torch.models.hpf_map import HPFMap, HPFMapConfig

    with pytest.raises(NotImplementedError, match="HPFMap has no ELBO"):
        HPFMap(HPFMapConfig(n_factors=2)).elbo(
            (np.zeros(1, int), np.zeros(1, int), np.ones(1)))
    u, i, x = small_ratings
    m = GaussianMF(GaussianMFConfig(n_factors=2, max_iter=1, verbose=False)).fit(
        (u, i, x - x.mean()), device="cpu")
    assert np.isfinite(m.elbo((u, i, x - x.mean())))
