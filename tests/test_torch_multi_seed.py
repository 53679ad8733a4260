"""Port ``tune.multi_seed`` against the JAX package on the CPU: the same
seeded data and float64 configs through the JAX ``multi_seed_fit``
(``jax.vmap`` of the flat sweep) and the port's (``torch.func.vmap`` of
its flat sweep).  Stacked states to rtol 1e-10 (the Gaussian's signed
means also atol 1e-12, as ``tests/test_torch_gaussian_fit.py``), per-seed
metrics to 1e-9; each vmapped seed equal to the port's own single flat
fit of that seed; the seeds differ."""

import dataclasses

import numpy as np
import pytest
import torch

from pmf_tpu.models import GaussianMFConfig as JGaussianConfig
from pmf_tpu.models import HPFConfig as JHPFConfig
from pmf_tpu.models import PoissonMFConfig as JPoissonConfig
from pmf_tpu.tune.multi_seed import multi_seed_fit as j_multi_seed_fit
from pmf_tpu_torch.models import (
    HPF,
    GaussianMF,
    GaussianMFConfig,
    HPFConfig,
    PoissonMF,
    PoissonMFConfig,
)
from pmf_tpu_torch.ops import segment
from pmf_tpu_torch.tune.multi_seed import multi_seed_fit

torch.set_num_threads(1)

SEEDS = (3, 7)
BASE = dict(n_factors=5, max_iter=4, tol=None, verbose=False, dtype="float64")
# name: (JAX config class, port config class, port model, rating shift, extra)
CASES = {
    "hpf": (JHPFConfig, HPFConfig, HPF, 1.0, {}),
    "poisson": (JPoissonConfig, PoissonMFConfig, PoissonMF, 0.0, {}),
    "poisson_extended": (JPoissonConfig, PoissonMFConfig, PoissonMF, 0.0,
                         {"extended": True}),
    "gaussian": (JGaussianConfig, GaussianMFConfig, GaussianMF, -3.0, {"use_bias": False}),
    "gaussian_bias": (JGaussianConfig, GaussianMFConfig, GaussianMF, -3.0, {"use_bias": True}),
}
ATOL = {"gaussian": 1e-12, "gaussian_bias": 1e-12}


def _data(small_splits, shift):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    return (tu, ti, tx + shift), (vu, vi, vx + shift)


@pytest.fixture(scope="module")
def fits(small_splits):
    out = {}
    for name, (jcls, tcls, _, shift, extra) in CASES.items():
        train, val = _data(small_splits, shift)
        ref = j_multi_seed_fit(jcls(**BASE, **extra), train, val, seeds=SEEDS)
        got = multi_seed_fit(tcls(**BASE, **extra), train, val, seeds=SEEDS, device="cpu")
        out[name] = ref, got
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_stacked_states_equal_the_jax_multi_seed_fit(fits, name):
    (j_state, _), (t_state, _) = fits[name]
    assert sorted(t_state) == sorted(j_state)
    for k in j_state:
        got = t_state[k]
        assert got.shape[0] == len(SEEDS) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(j_state[k]), rtol=1e-10,
                                   atol=ATOL.get(name, 0.0), err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_metrics_equal_the_jax_multi_seed_fit(fits, name):
    (_, j_metrics), (_, t_metrics) = fits[name]
    assert [m["seed"] for m in t_metrics] == list(SEEDS)
    for jm, tm in zip(j_metrics, t_metrics):
        assert set(tm) == {"seed", "val_rmse", "val_macro_mae"}
        for key in ("val_rmse", "val_macro_mae"):
            assert abs(tm[key] - jm[key]) < 1e-9, key


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_seed_equals_the_single_flat_fit(fits, small_splits, name):
    _, tcls, model_cls, shift, extra = CASES[name]
    train, val = _data(small_splits, shift)
    t_state, t_metrics = fits[name][1]
    for k, seed in enumerate(SEEDS):
        cfg = tcls(**BASE, **extra, random_state=seed, engine="flat")
        solo = model_cls(cfg).fit(train, val, device="cpu")
        for key, v in solo.state.items():
            np.testing.assert_allclose(t_state[key][k].numpy(), v.numpy(), rtol=1e-10,
                                       atol=ATOL.get(name, 0.0), err_msg=f"{seed} {key}")
        assert abs(t_metrics[k]["val_rmse"] - solo.fit_history[-1]["val_rmse"]) < 1e-9


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_seeds_differ(fits, name):
    t_state = fits[name][1][0]
    key = "m_theta" if name.startswith("gaussian") else "a_theta"
    assert not np.allclose(t_state[key][0].numpy(), t_state[key][1].numpy())
    metrics = fits[name][1][1]
    assert metrics[0]["val_rmse"] != metrics[1]["val_rmse"]


def test_the_gaussian_branch_runs_full_covariance_and_exact_biases(small_splits):
    """As the reference, no covariance or bias_update reaches the sweep:
    a config asking for lagged biases fits as exact."""
    train, val = _data(small_splits, -3.0)
    cfg = GaussianMFConfig(**BASE, use_bias=True)
    exact = multi_seed_fit(cfg, train, val, seeds=(1,), device="cpu")[0]
    lagged = multi_seed_fit(dataclasses.replace(cfg, bias_update="lagged"), train, val,
                            seeds=(1,), device="cpu")[0]
    for k in exact:
        torch.testing.assert_close(lagged[k], exact[k], rtol=0, atol=0)
    assert exact["V_theta"].shape[-2:] == (5, 5)


def test_without_validation_and_the_iteration_count(small_splits):
    train, _ = _data(small_splits, 1.0)
    cfg = HPFConfig(**BASE)
    state, metrics = multi_seed_fit(cfg, train, None, seeds=(0, 1, 2), n_iter=2,
                                    device="cpu")
    assert metrics == [] and state["a_theta"].shape[0] == 3
    solo = HPF(dataclasses.replace(cfg, max_iter=2, random_state=2)).fit(train, device="cpu")
    np.testing.assert_allclose(state["a_theta"][2].numpy(), solo.state["a_theta"].numpy(),
                               rtol=1e-10)


def test_unsupported_config_raises(small_splits):
    train, _ = _data(small_splits, 1.0)
    with pytest.raises(TypeError, match="unsupported config"):
        multi_seed_fit(object(), train, device="cpu")


def test_segment_sum_runs_under_vmap_and_equals_the_loop():
    gen = torch.Generator().manual_seed(0)
    data = torch.rand(3, 50, 4, generator=gen, dtype=torch.float64)
    ids = torch.randint(-2, 12, (50,), generator=gen)  # some out of range
    got = torch.func.vmap(lambda d: segment.sorted_segment_sum(d, ids, 10))(data)
    for s in range(3):
        want = torch.zeros(10, 4, dtype=torch.float64)
        for e in range(50):
            if 0 <= ids[e] < 10:
                want[ids[e]] += data[s, e]
        torch.testing.assert_close(got[s], want, rtol=1e-14, atol=1e-14)
