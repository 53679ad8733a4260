"""K4's panel form (K >= 240, past the CTA form), on the CPU.

A numpy emulation of ``gj_inverse_panel_kernel`` (``csrc/gj_inverse.cu``)
as ``ops/gj_inverse.py::panel_plan`` lays it out: the pivots in panels of
b; for each, the nb x nb pivot block eliminated alone (each pivot's row
and its column before the pivot kept), then the strips (the panel's rows
at every other column, divided by each pivot in turn; the panel's
columns at every other row, each multiplier kept and the pivot's column
zeroed), then the rest of the matrix through the panel's pivots in order.
In float32 without contraction it equals the unblocked in-place
elimination bit for bit, since each entry sees the same operations in
the same order; it is held against float64 ``linalg.inv``, the JAX
package's plain inverse and the JAX Pallas kernel's arithmetic; the
full-covariance fit at K = 256 runs against the JAX fit.  The plan: every b within shared memory, the C plan equal to the Python one at
every boundary up to K = 1000 and at the far edges."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.ops.pallas.gj_inverse import _gj_kernel
from pmf_tpu.ops.solve import batched_psd_inverse
from pmf_tpu_torch.ops import gj_inverse
from tests.test_torch_hugek import GJ_EDGE_KS, _gj_host_plan
from tests.test_torch_k3k4 import INV_RTOL, _pd, _per_matrix_err

torch.set_num_threads(1)


def emulate_unblocked(mats, dtype=np.float32):
    """The in-place elimination pivot by pivot, every product and
    difference rounded to ``dtype`` (no contraction): at pivot p, r =
    [row p, 1 at p] / a[p][p]; a[i][j] = (j == p ? 0 : a[i][j]) - a[i][p]
    r[j], i != p; row p takes r."""
    a = mats.astype(dtype).copy()
    for p in range(a.shape[1]):
        piv = a[:, p, p].copy()
        row = a[:, p, :].copy()
        row[:, p] = 1
        row = row / piv[:, None]
        col = a[:, :, p].copy()
        a[:, :, p] = 0
        a = a - col[:, :, None] * row[:, None, :]
        a[:, p, :] = row
    return a


def emulate_panel(mats, b, dtype=np.float32):
    """The panel form's steps over the matrices at once, in its order."""
    a = mats.astype(dtype).copy()
    R, K, _ = a.shape
    for p0 in range(0, K, b):
        nb = min(b, K - p0)
        pan = np.arange(p0, p0 + nb)
        oth = np.r_[0:p0, p0 + nb:K]  # the other rows and columns, in order
        # 1. The pivot block alone; rD[k] its row k after pivot k, cD[k]
        # its column k before it.
        D = a[:, pan][:, :, pan]
        rD, cD, pv = (np.empty((R, nb, nb), dtype), np.empty((R, nb, nb), dtype),
                      np.empty((R, nb), dtype))
        for k in range(nb):
            pv[:, k] = D[:, k, k]
            r = D[:, k, :].copy()
            r[:, k] = 1
            rD[:, k] = r / pv[:, k, None]
            cD[:, k] = D[:, :, k]
            D[:, :, k] = 0
            D = D - cD[:, k, :, None] * rD[:, k, None, :]
            D[:, k, :] = rD[:, k]
        # 2. The panel's rows at the other columns (each column a thread's
        # nb values), and the panel's columns at the other rows.
        V = a[:, pan][:, :, oth]
        Rs = np.empty_like(V)
        for k in range(nb):
            Rs[:, k] = V[:, k, :] / pv[:, k, None]
            V = V - cD[:, k, :, None] * Rs[:, k, None, :]
            V[:, k, :] = Rs[:, k]
        W = a[:, oth][:, :, pan]
        Cs = np.empty((R, nb, len(oth)), dtype)
        for k in range(nb):
            Cs[:, k] = W[:, :, k]
            W[:, :, k] = 0
            W = W - Cs[:, k, :, None] * rD[:, k, None, :]
        # 3. The rest, through the panel's pivots in order.
        X = a[:, oth][:, :, oth]
        for k in range(nb):
            X = X - Cs[:, k, :, None] * Rs[:, k, None, :]
        a[:, pan[:, None], pan] = D
        a[:, pan[:, None], oth] = V
        a[:, oth[:, None], pan] = W
        a[:, oth[:, None], oth] = X
    return a


@pytest.mark.parametrize("K,b", [(9, 8), (20, 8), (37, 16), (70, 32), (70, 24),
                                 (129, 32), (240, 32), (300, 32), (331, 24)])
def test_panel_order_is_the_unblocked_elimination_in_float32_bits(K, b):
    """Panels of b, a last partial panel where b does not divide K: every
    entry sees the unblocked elimination's operations in its order."""
    mats = _pd(2, K, seed=400 + K)
    got = emulate_panel(mats, b)
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, emulate_unblocked(mats))


@pytest.mark.parametrize("K", [240, 385, 553])
def test_panel_emulation_at_the_plan_matches_float64_inv_and_the_jax_plain_inverse(K):
    mats = _pd(2, K, seed=500 + K)
    got = emulate_panel(mats, gj_inverse.panel_plan(K)["b"])
    assert _per_matrix_err(got, np.linalg.inv(mats.astype(np.float64))) <= INV_RTOL
    ref = np.asarray(batched_psd_inverse(jnp.asarray(mats)))
    assert _per_matrix_err(got, ref) <= INV_RTOL


class _Ref:
    """An array standing in for a Pallas ref: ``ref[...]`` reads it,
    ``ref[...] = v`` replaces it."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, v):
        self.a = v


def _jax_kernel(mats):
    """The JAX Pallas kernel's body ``_gj_kernel`` run eagerly on the
    matrices' own lanes: the kernel's jnp operations, pivot by pivot.  In
    interpret mode (``batched_psd_inverse_pallas(interpret=True)``) the
    same body compiles as one unrolled program, 343 s at K = 240 here; run
    op by op it takes about 2 s."""
    src, dst = _Ref(jnp.transpose(jnp.asarray(mats), (1, 2, 0))), _Ref(None)
    _gj_kernel(src, dst, k=mats.shape[1])
    return np.transpose(np.asarray(dst.a), (2, 0, 1))


@pytest.mark.parametrize("K", [240, 305])
def test_panel_emulation_matches_the_jax_kernel(K):
    """Against the JAX Pallas kernel's arithmetic at the panel form's first
    K and past the CTA form's last tile width (T = 15 to K = 240), each
    with its plan's b."""
    mats = _pd(2, K, seed=600 + K)
    got = emulate_panel(mats, gj_inverse.panel_plan(K)["b"])
    assert _per_matrix_err(got, _jax_kernel(mats)) <= INV_RTOL
    assert _per_matrix_err(got, np.linalg.inv(mats.astype(np.float64))) <= INV_RTOL


def test_gaussian_full_blocked_fit_at_k256_matches_jax(monkeypatch):
    """The full-covariance blocked fit at K = 256 (the card's full-width
    fit's K) on a 40 x 30 split of 400 ratings, 2 sweeps, port against the
    JAX package at ``test_torch_bigk.py``'s gates.  The JAX side inverts
    with its own Cholesky inverse (``pmf_tpu.ops.solve.batched_psd_inverse``,
    its flat engine's) in place of the interpret-mode Gauss-Jordan kernel,
    whose unrolled pivots compile for 643 s at this K here (9 s with the
    Cholesky inverse); the port's side runs K4's plain version."""
    import pmf_tpu.ops.pallas.gj_inverse as jgj
    from pmf_tpu.data.synthetic import synth_splits
    from tests.test_torch_bigk import _same_history
    from tests.test_torch_hugek import _gaussian_fit_pair

    monkeypatch.setattr(jgj, "batched_psd_inverse_pallas",
                        lambda mats, interpret=False: batched_psd_inverse(mats))
    tm, jm = _gaussian_fit_pair(synth_splits(40, 30, 400, seed=11), n_factors=256,
                                covariance="full", max_iter=2)
    _same_history(tm, jm)
    for name, v in tm.state.items():
        assert np.all(np.isfinite(v.numpy())), name


def test_panel_plan_fits_shared_memory():
    """b a multiple of 8, at most PANEL_MAX_B (a strip's values in a
    thread's registers); two CTAs an SM where b can stay at least
    PANEL_MIN_B2, else the largest b of one CTA, else the strips in global
    memory."""
    for k in range(gj_inverse.TILE_MAX_K + 1, 4000, 7):
        p = gj_inverse.panel_plan(k)
        b, ctas, nbytes = p["b"], p["ctas_per_sm"], p["smem_bytes"]
        assert b % 8 == 0 and gj_inverse.PANEL_MIN_B <= b <= gj_inverse.PANEL_MAX_B
        assert nbytes == 4 * gj_inverse.panel_words(k, b, p["global_panels"])
        assert nbytes <= gj_inverse.SMEM_PER_CTA
        assert ctas * (nbytes + 1024) <= gj_inverse.SMEM_PER_SM
        assert p["stride"] % 4 == 0 and k <= p["stride"] < k + 4
        if not p["global_panels"]:
            assert p["scratch_floats"] == 0
            bigger = [t for t in range(b + 8, gj_inverse.PANEL_MAX_B + 1, 8)
                      if ctas * (4 * gj_inverse.panel_words(k, t, False) + 1024)
                      <= gj_inverse.SMEM_PER_SM]
            assert not bigger, k
            assert ctas == 2 or 2 * (4 * gj_inverse.panel_words(
                k, gj_inverse.PANEL_MIN_B2, False) + 1024) > gj_inverse.SMEM_PER_SM
        else:
            assert b == gj_inverse.PANEL_MAX_B
            assert 4 * gj_inverse.panel_words(k, gj_inverse.PANEL_MIN_B, False) \
                > gj_inverse.SMEM_PER_CTA
            assert p["scratch_floats"] == 2 * b * p["stride"]
    assert gj_inverse.panel_plan(gj_inverse.TILE_MAX_K) is None


def test_panel_plan_matches_the_dispatch_at_every_boundary(tmp_path):
    """``panel_plan`` against the C host plan block compiled with g++ on
    both sides of every boundary of the panel form up to K = 1000, and at
    the far edges of the dispatch test."""
    plan = _gj_host_plan(tmp_path)
    bounds = gj_inverse.panel_boundary_ks(1000)
    assert bounds[0] == gj_inverse.TILE_MAX_K + 1 == 240
    ks = sorted({k for b in bounds for k in (b - 1, b)} | {1000} | set(GJ_EDGE_KS))
    for k in ks:
        f, b, ctas, smem, in_global, stride = plan(k)
        p = gj_inverse.panel_plan(k)
        if p is None:
            assert f != 2, k
            continue
        assert f == 2 and (b, ctas, smem, bool(in_global), stride) == (
            p["b"], p["ctas_per_sm"], p["smem_bytes"], p["global_panels"], p["stride"]), k
