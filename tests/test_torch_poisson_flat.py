"""Port flat Poisson-MF CAVI (plain and extended) against the JAX package:
the initial state bit for bit, three flat sweeps in float64 at 1e-10 from
a carried-across state, the row-by-row oracle, the validation metrics,
the state's numpy round trip and the host metrics."""

import numpy as np
import pytest
import torch

from pmf_tpu.data.coo import build_eval_set as j_build_eval_set
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.eval import metrics as jmetrics
from pmf_tpu.models import poisson_mf as jpmf
from pmf_tpu_torch.data.coo import build_eval_set as t_build_eval_set
from pmf_tpu_torch.data.coo import build_ratings as t_build_ratings
from pmf_tpu_torch.eval import metrics as tmetrics
from pmf_tpu_torch.models import poisson_mf as tpmf
from tests import oracles

torch.set_num_threads(1)

VARIANTS = pytest.mark.parametrize("extended", [False, True],
                                   ids=["plain", "extended"])


def _cfgs(dtype, extended, K=6, **kw):
    kw = dict(n_factors=K, dtype=dtype, verbose=False, extended=extended, **kw)
    return jpmf.PoissonMFConfig(**kw), tpmf.PoissonMFConfig(**kw)


@VARIANTS
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_state_matches_jax_bitwise(dtype, extended):
    jcfg, tcfg = _cfgs(dtype, extended)
    js = jpmf.init_state(120, 80, jcfg)
    ts = tpmf.init_state(120, 80, tcfg, device="cpu")
    assert set(js) == set(ts) and len(ts) == (8 if extended else 4)
    for k in js:
        ref = np.asarray(js[k])
        got = ts[k].numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        np.testing.assert_array_equal(got, ref, err_msg=k)


@VARIANTS
def test_flat_sweep_matches_jax_float64(small_ratings, extended):
    u, i, x = small_ratings
    jcfg, tcfg = _cfgs("float64", extended)
    jd = j_build_ratings(u, i, x, dtype=np.float64)
    td = t_build_ratings(u, i, x, dtype=np.float64, device="cpu")
    js = jpmf.init_state(jd.n_users, jd.n_items, jcfg)
    # The state is carried across, not drawn again.
    ts = tpmf.state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                               device="cpu")
    for _ in range(3):
        js = jpmf.sweep(js, jd, jcfg.a0, jcfg.b0, extended)
        ts = tpmf.sweep(ts, td, tcfg.a0, tcfg.b0, extended)
    assert set(js) == set(ts)
    for k in js:
        assert ts[k].dtype == torch.float64, k
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-10,
                                   err_msg=k)


@VARIANTS
def test_flat_fit_matches_row_by_row_oracle(small_ratings, extended):
    u, i, x = small_ratings
    K, n_iter, seed, a0, b0 = 5, 3, 9, 0.6, 1.0
    oracle = oracles.poisson_extended_cavi if extended else oracles.poisson_cavi
    ref = oracle(u, i, x, K, a0, b0, n_iter, seed)
    cfg = tpmf.PoissonMFConfig(n_factors=K, a0=a0, b0=b0, max_iter=n_iter, tol=None,
                               random_state=seed, verbose=False, extended=extended,
                               dtype="float64", engine="flat")
    model = tpmf.PoissonMF(cfg).fit((u, i, x), device="cpu")
    state = tpmf.state_to_numpy(model.state)
    assert len(state) == (8 if extended else 4)
    for k, got in state.items():
        np.testing.assert_allclose(got, ref[k], rtol=1e-8, atol=1e-10, err_msg=k)
    expect = np.sum(ref["E_theta"][u[:50]] * ref["E_beta"][i[:50]], axis=1)
    if extended:
        expect = expect * ref["E_phi"][u[:50]] * ref["E_psi"][i[:50]]
    np.testing.assert_allclose(model.predict(u[:50], i[:50]), expect, rtol=1e-8)


def test_empty_rows_reset_to_the_prior():
    """Users and items without ratings hold (a0, b0) after a sweep, in the
    factor rows and in the extended scalars."""
    u = np.array([0, 0, 2, 2]); i = np.array([0, 2, 0, 2]); x = np.array([1., 2, 3, 1])
    td = t_build_ratings(u, i, x, n_users=4, n_items=3, dtype=np.float64, device="cpu")
    cfg = tpmf.PoissonMFConfig(n_factors=3, extended=True, dtype="float64")
    s = tpmf.sweep(tpmf.init_state(4, 3, cfg, device="cpu"), td, cfg.a0, cfg.b0, True)
    for row in (1, 3):
        assert torch.all(s["a_theta"][row] == cfg.a0) and torch.all(s["b_theta"][row] == cfg.b0)
        assert s["a_phi"][row] == cfg.a0 and s["b_phi"][row] == cfg.b0
    assert torch.all(s["a_beta"][1] == cfg.a0) and s["b_psi"][1] == cfg.b0
    assert s["a_phi"][0] == cfg.a0 + 3.0 and s["a_psi"][2] == cfg.a0 + 3.0


@VARIANTS
def test_eval_metrics_match_jax(small_splits, extended):
    (tu, ti, _), (vu, vi, vx), _ = small_splits
    jcfg, tcfg = _cfgs("float64", extended)
    n_users, n_items = int(tu.max()) + 1, int(ti.max()) + 1
    js = jpmf.init_state(n_users, n_items, jcfg)
    ts = tpmf.init_state(n_users, n_items, tcfg, device="cpu")
    jev = j_build_eval_set(vu, vi, vx, n_users, n_items, dtype=np.float64)
    tev = t_build_eval_set(vu, vi, vx, n_users, n_items, dtype=np.float64, device="cpu")
    for got, ref in zip(tpmf.eval_metrics(ts, tev, extended),
                        jpmf.eval_metrics(js, jev, extended)):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)


@VARIANTS
def test_state_numpy_round_trip(extended):
    jcfg, _ = _cfgs("float32", extended, K=5)
    js = {k: np.asarray(v) for k, v in jpmf.init_state(30, 20, jcfg).items()}
    ts = tpmf.state_from_numpy(js, device="cpu")
    assert len(ts) == (8 if extended else 4)
    assert all(ts[k].dtype == torch.float32 for k in ts)
    back = tpmf.state_to_numpy(ts)
    assert set(back) == set(js)
    for k in js:
        np.testing.assert_array_equal(back[k], js[k])
    if extended:
        assert back["a_phi"].shape == (30,) and back["b_psi"].shape == (20,)
    t64 = tpmf.state_from_numpy(js, device="cpu", dtype=torch.float64)
    assert all(t64[k].dtype == torch.float64 for k in t64)
    ts["a_theta"][0, 0] = -1.0  # the tensors own their memory
    assert js["a_theta"][0, 0] != -1.0


def test_host_metrics_match_jax():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 6, size=200).astype(np.float64)
    lam = np.abs(y + rng.standard_normal(200))
    lam[:3] = 0.0  # floored
    assert tmetrics.mae(y, lam) == pytest.approx(jmetrics.mae(y, lam), rel=1e-12)
    assert tmetrics.poisson_log_predictive_likelihood(y, lam) == pytest.approx(
        jmetrics.poisson_log_predictive_likelihood(y, lam), rel=1e-12)
    assert tmetrics.poisson_log_predictive_likelihood(y, lam, epsilon=1e-3) == \
        pytest.approx(jmetrics.poisson_log_predictive_likelihood(y, lam, 1e-3),
                      rel=1e-12)
