"""K3's padded table and K4's row-per-lane arithmetic, on the CPU.

K4: a numpy float32 emulation of the kernel (``csrc/gj_inverse.cu``) as
``ops/gj_inverse.py::launch_plan`` lays it out (the CTA's matrices copied
into a padded shared tile by the kernel's multiply-shift division, thread
t holding row t % K of matrix t // K, the elimination in place with one
reciprocal a pivot) against float64 ``linalg.inv`` and the JAX
Pallas kernel in interpret mode, per matrix at 1e-4 of its largest entry.

K3: the padded table (its pad columns ignored by the plain version, the
only table the kernel takes, no record paying a sector more for its
16-byte start), the factor statistics on it against the JAX factor pass
(the precision-tier gate), the byte reckoning and the wrapper's bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.ops.pallas import gaussian_edge as jge
from pmf_tpu.ops.pallas.gj_inverse import batched_psd_inverse_pallas
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.ops import gaussian_edge as ge
from pmf_tpu_torch.ops import gj_inverse
from tests.test_torch_guard import _cuda_looking

torch.set_num_threads(1)

N_USERS, N_ITEMS = 120, 80
INV_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ K4 --

def _pd(R, K, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((R, K, K + 3)) * 0.5
    return (np.eye(K) / 0.4 + A @ np.transpose(A, (0, 2, 1)) / 0.5).astype(np.float32)


def _emulate_k4(mats):
    """K4 in numpy float32, CTA by CTA, as the kernel computes it."""
    R, K, _ = mats.shape
    plan = gj_inverse.launch_plan(K)
    if plan is None:  # the CTA form: one matrix a CTA, in place, two divisions
        a = mats.copy()
        for p in range(K):
            row = a[:, p, :].copy()
            row[:, p] = 1.0
            row = row / a[:, p, p][:, None]
            col = a[:, :, p].copy()
            a[:, :, p] = 0.0
            a = a - col[:, :, None] * row[:, None, :]
            a[:, p, :] = row
        return a
    S, mpc = plan["stride"], plan["matrices"]
    magic = ((1 << 32) + K - 1) // K  # the kernel takes e itself at K = 1
    flat, out = mats.reshape(-1), np.full(R * K * K, np.nan, np.float32)
    threads = np.arange(32 * plan["warps"])
    rows = threads // K  # thread t holds row t % K of matrix t // K: tile row t
    assert np.array_equal(rows * K + threads % K, threads)
    for m0 in range(0, R, mpc):
        nm = min(mpc, R - m0)
        e = np.arange(nm * K * K, dtype=np.uint64)
        q = ((e * np.uint64(magic)) >> np.uint64(32)).astype(np.int64) if K > 1 else \
            e.astype(np.int64)
        assert np.array_equal(q, e.astype(np.int64) // K)
        tile = np.full(mpc * K * S, np.nan, np.float32)  # pads never read
        tile[q * S + (e.astype(np.int64) - q * K)] = flat[m0 * K * K + e.astype(np.int64)]
        live = threads[rows < nm]
        assert len(live) == nm * K  # each row of each matrix once
        a = tile[: nm * K * S].reshape(nm, K, S)[:, :, :K].copy()
        for p in range(K):
            inv = np.float32(1.0) / a[:, p, p]  # one reciprocal, then products
            r = a[:, p, :].copy()  # row p with the 1 of I's column p, scaled
            r[:, p] = 1.0
            r = r * inv[:, None]
            c = a[:, :, p].copy()  # each thread's multiplier a[i][p]
            keep = a.copy()
            keep[:, :, p] = 0.0
            a = keep - c[:, :, None] * r[:, None, :]
            a[:, p, :] = r  # the pivot row's thread takes r
        t = tile[: nm * K * S].reshape(nm, K, S)
        t[:, :, :K] = a
        out[m0 * K * K : (m0 + nm) * K * K] = tile[q * S + (e.astype(np.int64) - q * K)]
    return out.reshape(R, K, K)


def _per_matrix_err(got, ref):
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=(1, 2))
    return float((np.abs(np.asarray(got, np.float64) - ref).max(axis=(1, 2)) / scale).max())


@pytest.mark.parametrize("K", [1, 8, 16, 20, 33, 50, 64, 128])
def test_k4_emulation_matches_float64_inv_and_the_jax_kernel(K):
    plan = gj_inverse.launch_plan(K)
    mpc = plan["matrices"] if plan else 1
    R = 2 * mpc + 3 if K < 128 else 5  # a ragged last CTA
    mats = _pd(R, K, seed=K)
    got = _emulate_k4(mats)
    assert np.all(np.isfinite(got))
    assert _per_matrix_err(got, np.linalg.inv(mats.astype(np.float64))) <= INV_RTOL
    ref = np.asarray(batched_psd_inverse_pallas(jnp.asarray(mats), interpret=True))
    assert _per_matrix_err(got, ref) <= INV_RTOL


@pytest.mark.parametrize("K,R", [(5, 1), (5, 31), (5, 33), (8, 97), (12, 15), (16, 17),
                                 (16, 47), (20, 13), (30, 3)])
def test_k4_emulation_covers_the_packing_edges(K, R):
    """Several matrices a warp (two to K = 16, four to K = 8) and matrices
    across warps (K = 20: eight in five): R not a multiple of a CTA's
    matrices."""
    mats = _pd(R, K, seed=100 + R)
    got = _emulate_k4(mats)
    assert np.all(np.isfinite(got))
    assert _per_matrix_err(got, np.linalg.inv(mats.astype(np.float64))) <= INV_RTOL
    np.testing.assert_allclose(
        got, gj_inverse.batched_psd_inverse_gj_plain(_t(mats)).numpy(), rtol=0,
        atol=1e-4 * float(np.abs(got).max()))


@pytest.mark.parametrize("K,warps,matrices", [(1, 1, 32), (8, 1, 4), (9, 2, 7),
                                               (16, 1, 2), (17, 8, 15), (20, 5, 8),
                                               (24, 3, 4), (32, 1, 1), (33, 4, 3),
                                               (50, 2, 1), (64, 2, 1)])
def test_k4_launch_plan(K, warps, matrices):
    plan = gj_inverse.launch_plan(K)
    assert (plan["warps"], plan["matrices"]) == (warps, matrices)
    assert K <= plan["kmax"] and plan["kmax"] % 4 == 0
    assert matrices * K <= 32 * warps
    S = plan["stride"]
    assert S >= K and S % 4 == 0 and S % 8 == 4  # float4 rows, distinct banks
    assert (matrices * K * S + matrices * 2 * plan["kmax"]) * 4 <= 227 * 1024


def test_k4_cta_form_past_64_and_the_bound():
    assert gj_inverse.launch_plan(65) is None and gj_inverse.launch_plan(128) is None
    assert gj_inverse.form(65) == gj_inverse.form(239) == "cta"
    assert gj_inverse.form(240) == "global"
    with pytest.raises(ValueError, match="K >= 1"):
        gj_inverse.launch_plan(0)
    with pytest.raises(ValueError, match="K >= 1"):
        gj_inverse.batched_psd_inverse_gj(_cuda_looking(torch.rand(2, 0, 0)))


# ------------------------------------------------------------------ K3 --

@pytest.fixture(scope="module")
def tail(small_ratings):
    u, i, x = small_ratings
    xc = (x - x.mean()).astype(np.float32)
    jb = j_build_blocked(u, i, xc, n_users=N_USERS, n_items=N_ITEMS, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=(16, 24), head_r0=4)
    tb = t_build_blocked(u, i, xc, n_users=N_USERS, n_items=N_ITEMS, reorder=True,
                         head=(16, 24), head_r0=4, device="cpu")
    return jb, tb


def _gauss_tables(n, K, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, K)) * 0.3
    A = rng.standard_normal((n, K, K)) * 0.1
    V = 0.2 * np.eye(K) + A @ np.transpose(A, (0, 2, 1))
    b = rng.standard_normal(n) * 0.5
    return tuple(a.astype(np.float32) for a in (m, V, b))


@pytest.mark.parametrize("with_bias_stats", [False, True], ids=["exact", "lagged"])
@pytest.mark.parametrize("K", [20, 50])
def test_factor_stats_on_the_padded_table_match_jax(tail, K, with_bias_stats):
    """``gaussian_factor_stats`` (the padded table of ``factor_table``, the
    tail pass and the head tiers) against the JAX factor pass at the
    precision-tier gate, both directions."""
    jb, tb = tail
    users, items = _gauss_tables(N_USERS, K, 3), _gauss_tables(N_ITEMS, K, 4)
    for side, (_, _, b_s), (m_o, V_o, b_o), jp, tp in (
            ("user", users, items, jb.by_user, tb.by_user),
            ("item", items, users, jb.by_item, tb.by_item)):
        got = ge.gaussian_factor_stats(_t(m_o), _t(V_o), _t(b_s), _t(b_o), tp,
                                       use_bias=True, with_bias_stats=with_bias_stats,
                                       head=tb.head, head_side=side)
        ref = jge.gaussian_factor_stats(
            m_o, V_o, b_s, b_o, jp, use_bias=True, precision="high", interpret=True,
            with_bias_stats=with_bias_stats, head=jb.head, head_side=side)
        assert len(got) == len(ref) == (5 if with_bias_stats else 2)
        for n, (g, r) in enumerate(zip(got, ref)):
            r = np.asarray(r, np.float64)
            rs = np.abs(r).max() + 1e-6
            np.testing.assert_allclose(g.numpy() / rs, r / rs, rtol=0, atol=1e-4,
                                       err_msg=f"{side} stat {n} vs JAX")


@pytest.mark.parametrize("K", [1, 3, 20, 50])
def test_plain_factor_pass_ignores_the_pad_columns(tail, K):
    p = tail[1].by_item
    T = ge.tri_size(K)
    rng = np.random.default_rng(K)
    aug = _t(rng.standard_normal((p.n_other, K + 1 + T)).astype(np.float32))
    stride = ge.factor_stride(K)
    assert stride % 4 == 0 and 0 <= stride - (K + 1 + T) < 4
    padded = torch.cat([aug, torch.full((p.n_other, stride - K - 1 - T), float("nan"))],
                       dim=1)
    for wbs in (False, True):
        ref = ge.factor_tail_stats_plain(aug, p.row_ptr, p.other, p.x, K, wbs)
        assert torch.equal(
            ge.factor_tail_stats_plain(padded, p.row_ptr, p.other, p.x, K, wbs), ref)
        assert torch.equal(ge.factor_tail_stats(padded, p.row_ptr, p.other, p.x, K, wbs),
                           ref)


@pytest.mark.parametrize("K", [1, 5, 20])
@pytest.mark.parametrize("permuted", [False, True])
def test_factor_table_packs_and_permutes_in_one_gather(K, permuted):
    m, V, b = (_t(a) for a in _gauss_tables(30, K, K))
    A = (V + m[:, :, None] * m[:, None, :]).reshape(-1, K * K)
    rows = torch.from_numpy(np.random.default_rng(K).permutation(30)) if permuted else None
    got = ge.factor_table(m, b, A, rows)
    ref = torch.cat([m, b[:, None], ge.pack_tri(A, K)], dim=1)
    if permuted:
        ref = ref[rows]
    T = ge.tri_size(K)
    assert got.shape == (30, ge.factor_stride(K)) and got.is_contiguous()
    assert torch.equal(got[:, : K + 1 + T], ref)
    assert not bool(got[:, K + 1 + T :].any())


def test_factor_reckoning_counts_sectors():
    """Records of 924 bytes on a 928-byte stride span 29 sectors each."""
    K = 20
    row_ptr = torch.tensor([0, 2, 3])
    other = torch.tensor([0, 5, 1], dtype=torch.int32)
    p = t_build_blocked(np.array([0, 0, 1]), np.array([0, 5, 1]),
                        np.ones(3, np.float32), n_users=2, n_items=6,
                        device="cpu").by_user
    assert torch.equal(p.row_ptr, row_ptr) and torch.equal(p.other, other)
    r = ge.factor_reckoning(p, K)
    T = ge.tri_size(K)
    fixed = 3 * 8 + 2 * 4 * (2 * K + T)
    assert r["per_edge"] == fixed + 3 * 29 * 32
    assert r["table_once"] == fixed + 6 * 4 * (K + 1 + T)


def test_padded_records_cost_no_extra_sector():
    """With the stride rounded up to 4 floats, a record that starts 16
    bytes into a sector spans no more sectors than one that starts on a
    sector, at every K the kernel takes."""
    for K in range(1, 129):
        rec, stride = 4 * (K + 1 + ge.tri_size(K)), 4 * ge.factor_stride(K)
        assert stride % 16 == 0
        if stride % 32:
            assert (16 + rec + 31) // 32 == (rec + 31) // 32, K


def test_factor_wrapper_bounds():
    csr = tuple(_cuda_looking(t) for t in (torch.tensor([0, 1, 1, 2]),
                                           torch.tensor([0, 4], dtype=torch.int32),
                                           torch.ones(2)))
    with pytest.raises(ValueError, match="K >= 1"):
        ge.factor_tail_stats(_cuda_looking(torch.rand(5, 4)), *csr, 0)


@pytest.mark.parametrize("K", [1, 2, 4, 20, 50, 128])
def test_factor_kernel_wants_the_padded_table(K):
    """On CUDA tensors the wrapper takes only the table padded to
    ``factor_stride(K)`` columns, as ``factor_table`` makes it."""
    csr = tuple(_cuda_looking(t) for t in (torch.tensor([0, 1, 1, 2]),
                                           torch.tensor([0, 4], dtype=torch.int32),
                                           torch.ones(2)))
    width = K + 1 + ge.tri_size(K)
    for bad in {width, ge.factor_stride(K) + 4} - {ge.factor_stride(K)}:
        with pytest.raises(ValueError, match="aug must be"):
            ge.factor_tail_stats(_cuda_looking(torch.rand(5, bad)), *csr, K)
