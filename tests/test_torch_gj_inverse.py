"""Port K4 (batched Gauss-Jordan inverse, plain version on the CPU) and
the flat engine's Cholesky solves against the JAX package: the Pallas
kernel in interpret mode at 1e-5 in float32, and ``torch.linalg.inv`` /
the JAX ``ops.solve`` functions in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.ops import solve as jsolve
from pmf_tpu.ops.pallas.gj_inverse import batched_psd_inverse_pallas
from pmf_tpu_torch.ops import gj_inverse, solve

torch.set_num_threads(1)


def _pd(R, K, dtype, seed=0):
    """Precision-like matrices I/eta^2 + S/sigma^2 (S a sum of outer
    products), as the Gaussian blocks invert."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((R, K, K + 3)) * 0.5
    return (np.eye(K) / 0.4 + A @ np.transpose(A, (0, 2, 1)) / 0.5).astype(dtype)


@pytest.mark.parametrize("K", [1, 5, 20])
def test_gj_plain_matches_jax_pallas_interpret(K):
    mats = _pd(300, K, np.float32, seed=K)
    ref = np.asarray(batched_psd_inverse_pallas(jnp.asarray(mats), interpret=True))
    got = gj_inverse.batched_psd_inverse_gj_plain(torch.from_numpy(mats))
    assert got.dtype == torch.float32 and got.shape == mats.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K", [5, 20])
def test_gj_plain_float64_matches_linalg_inv(K):
    mats = torch.from_numpy(_pd(200, K, np.float64, seed=10 + K))
    got = gj_inverse.batched_psd_inverse_gj_plain(mats)
    np.testing.assert_allclose(got.numpy(), torch.linalg.inv(mats).numpy(),
                               rtol=1e-10, atol=1e-12)


def test_gj_wrapper_on_cpu_is_the_plain_version():
    mats = torch.from_numpy(_pd(50, 6, np.float32, seed=3))
    before = gj_inverse.GJ_LAUNCHES.count
    np.testing.assert_array_equal(
        gj_inverse.batched_psd_inverse_gj(mats).numpy(),
        gj_inverse.batched_psd_inverse_gj_plain(mats).numpy())
    assert gj_inverse.GJ_LAUNCHES.count == before


@pytest.mark.parametrize("K", [4, 20])
def test_cholesky_inverse_and_solve_match_jax(K):
    mats = _pd(100, K, np.float64, seed=20 + K)
    rhs = np.random.default_rng(K).standard_normal((100, K))
    np.testing.assert_allclose(
        solve.batched_psd_inverse(torch.from_numpy(mats)).numpy(),
        np.asarray(jsolve.batched_psd_inverse(jnp.asarray(mats))),
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        solve.batched_psd_solve(torch.from_numpy(mats), torch.from_numpy(rhs)).numpy(),
        np.asarray(jsolve.batched_psd_solve(jnp.asarray(mats), jnp.asarray(rhs))),
        rtol=1e-10, atol=1e-12)
