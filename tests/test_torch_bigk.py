"""The port past K = 32: every kernel's plain version against the JAX
package at K in {33, 50, 70} (the Pallas kernels in interpret mode, at
the gates the K <= 32 tests use), one blocked fit per family at K = 50
against the JAX fit, the wide K2's launch plan and arithmetic, the K4
CTA form's in-place elimination, and every kernel wrapper's bound of
K <= 128, named in the error it raises at K = 129."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.models import gaussian_mf as jg
from pmf_tpu.models import hpf as jhpf
from pmf_tpu.models import hpf_map as j_map
from pmf_tpu.models import poisson_mf as jpmf
from pmf_tpu.ops import dense_head as jdh
from pmf_tpu.ops.pallas import cavi_edge as j_cavi_edge
from pmf_tpu.ops.pallas import ext_edge as jext
from pmf_tpu.ops.pallas import gaussian_edge as jge
from pmf_tpu.ops.pallas.cavi_edge import poisson_edge_stats as j_edge_stats
from pmf_tpu.ops.pallas.gj_inverse import batched_psd_inverse_pallas
from pmf_tpu.ops.pallas.segmented import run_segmented
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.models import gaussian_mf as tg
from pmf_tpu_torch.models import hpf as thpf
from pmf_tpu_torch.models import hpf_map as t_map
from pmf_tpu_torch.models import poisson_mf as tpmf
from pmf_tpu_torch.ops import (
    cavi_edge,
    dense_head,
    ext_edge,
    gaussian_edge,
    gj_inverse,
    map_grad,
)
from pmf_tpu_torch.ops.adam import adam_init
from tests.test_torch_dense_head import _emulate_kernel
from tests.test_torch_guard import _cuda_looking, _map_args
from tests.test_torch_map_grad import (
    jax_step_accumulators,
    map_data,
    port_layout,
    softplus_tables,
)

torch.set_num_threads(1)

WIDE_KS = pytest.mark.parametrize("K", [33, 50, 70])
N_USERS, N_ITEMS = 120, 80
HEAD = (16, 24)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gamma(rng, *shape):
    return rng.gamma(1.0, 1.0, size=shape).astype(np.float32)


def _layouts(small_ratings, x, head=HEAD):
    u, i, _ = small_ratings
    jb = j_build_blocked(u, i, x, n_users=N_USERS, n_items=N_ITEMS, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=head, head_r0=4)
    tb = t_build_blocked(u, i, x, n_users=N_USERS, n_items=N_ITEMS, reorder=True,
                         head=head, head_r0=4, device="cpu")
    return jb, tb


def _sides(jb, tb, users, items):
    return (("user", users, items, jb.by_user, tb.by_user),
            ("item", items, users, jb.by_item, tb.by_item))


def _tier_gate(got, ref, what):
    """The JAX package's precision-tier gate for signed sums, per statistic."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4, err_msg=what)


# --------------------------------------------------- plain vs JAX, K > 32 --

@WIDE_KS
def test_k1_edge_stats_match_jax(small_ratings, K):
    jb, tb = _layouts(small_ratings, small_ratings[2] + 1.0)
    rng = np.random.default_rng(K)
    e_theta, e_beta = _gamma(rng, N_USERS, K), _gamma(rng, N_ITEMS, K)
    for side, es, eo, jp, tp in _sides(jb, tb, e_theta, e_beta):
        ref = j_edge_stats(jnp.asarray(es), jnp.asarray(eo), jp, interpret=True,
                           precision="high", head=jb.head, head_side=side)
        got = cavi_edge.poisson_edge_stats(_t(es), _t(eo), tp, head=tb.head,
                                           head_side=side)
        for g, r in zip(got, ref):
            assert g.shape == (tp.n_self, K)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4, atol=1e-5,
                                       err_msg=side)


@WIDE_KS
def test_k1_raw_mode_matches_jax_kernel(small_ratings, K):
    jb, tb = _layouts(small_ratings, small_ratings[2] + 1.0, head=None)
    rng = np.random.default_rng(K + 1)
    e_theta, e_beta = _gamma(rng, N_USERS, K), _gamma(rng, N_ITEMS, K)
    for side, es, eo, jp, tp in _sides(jb, tb, e_theta, e_beta):
        es, eo = es[tp.self_old_of_new.numpy()], eo[tp.other_old_of_new.numpy()]
        kernel = lambda *a, **kw: j_cavi_edge._kernel(  # noqa: E731
            *a, bs_self=jp.bs_self, bs_other=jp.bs_other, chunk_size=jp.chunk_size,
            rate_floor=1e-10, k=K, parts=1, highest=True, group=jp.group, mode="raw",
            **kw)
        pad = lambda t, n: jnp.pad(jnp.asarray(t), ((0, n - t.shape[0]), (0, 0)))  # noqa: E731
        ref = run_segmented(kernel, jp, pad(es, jp.n_self_blocks * jp.bs_self),
                            pad(eo, jp.n_other_blocks * jp.bs_other), 2 * K,
                            interpret=True)
        got = cavi_edge.tail_edge_stats(_t(es), _t(eo), tp.row_ptr, tp.other, None,
                                        mode="raw")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=1e-5,
                                   err_msg=side)


@WIDE_KS
@pytest.mark.parametrize("m_f32", [False, True], ids=["m_bf16", "m_f32"])
def test_k2_head_stats_match_jax(small_ratings, K, m_f32):
    """Both sides of one tier, M stored as bf16 or (a cell past 256
    copies) as float32."""
    u, i, x = small_ratings
    if m_f32:
        u, i, x = (np.concatenate([a, np.full(300, a[0])]) for a in (u, i, x))
    jb, tb = _layouts((u, i, x), x + 1.0)
    assert (tb.head[0].m.dtype == torch.float32) == m_f32
    rng = np.random.default_rng(K + 2)
    for jh, th in zip(jb.head, tb.head):
        theta = _gamma(rng, th.hu, K)
        beta = np.zeros((th.hip, K), np.float32)
        beta[: th.hi] = _gamma(rng, th.hi, K)
        for j_fn, t_fn in ((jdh.poisson_head_stats, dense_head.poisson_head_stats),
                           (jdh.poisson_head_stats_t, dense_head.poisson_head_stats_t)):
            ref = j_fn(jnp.asarray(theta), jnp.asarray(beta), jh, 1e-10, "high", True)
            got = t_fn(_t(theta), _t(beta), th, 1e-10)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4,
                                           atol=1e-5, err_msg=t_fn.__name__)


def _gauss_tables(n, K, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, K)) * 0.5
    A = rng.standard_normal((n, K, K)) * 0.1
    V = 0.5 * np.eye(K) + A @ np.transpose(A, (0, 2, 1))
    b = rng.standard_normal(n) * 0.5
    v = rng.gamma(1.0, 0.5, size=(n, K))
    return tuple(a.astype(np.float32) for a in (m, V, b, v))


def _gauss_case(small_ratings, K, seed):
    u, i, x = small_ratings
    jb, tb = _layouts(small_ratings, (x - x.mean()).astype(np.float32))
    return _sides(jb, tb, _gauss_tables(N_USERS, K, seed),
                  _gauss_tables(N_ITEMS, K, seed + 1)), jb, tb


@WIDE_KS
@pytest.mark.parametrize("with_bias_stats", [False, True], ids=["exact", "lagged"])
def test_k3_factor_stats_match_jax(small_ratings, K, with_bias_stats):
    sides, jb, tb = _gauss_case(small_ratings, K, 3 * K)
    for side, (_, _, b_s, _), (m_o, V_o, b_o, _), jp, tp in sides:
        ref = jge.gaussian_factor_stats(
            m_o, V_o, b_s, b_o, jp, use_bias=True, precision="high", interpret=True,
            with_bias_stats=with_bias_stats, head=jb.head, head_side=side)
        got = gaussian_edge.gaussian_factor_stats(
            _t(m_o), _t(V_o), _t(b_s), _t(b_o), tp, use_bias=True,
            with_bias_stats=with_bias_stats, head=tb.head, head_side=side)
        assert len(got) == len(ref) and got[1].shape == (tp.n_self, K, K)
        for n, (g, r) in enumerate(zip(got, ref)):
            _tier_gate(g.numpy(), r, f"{side} stat {n}")


@WIDE_KS
def test_k4_plain_matches_jax_kernel(K):
    rng = np.random.default_rng(K)
    A = rng.standard_normal((40, K, K + 3)) * 0.5
    mats = (np.eye(K) / 0.4 + A @ np.transpose(A, (0, 2, 1)) / 0.5).astype(np.float32)
    ref = np.asarray(batched_psd_inverse_pallas(jnp.asarray(mats), interpret=True))
    got = gj_inverse.batched_psd_inverse_gj_plain(_t(mats))
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=0, atol=1e-5)


@WIDE_KS
def test_k5_bias_stats_match_jax(small_ratings, K):
    sides, jb, tb = _gauss_case(small_ratings, K, 5 * K)
    for side, (m_s, *_), (m_o, _, b_o, _), jp, tp in sides:
        ref = jge.gaussian_bias_stats(m_s, m_o, b_o, jp, precision="high",
                                      interpret=True, head=jb.head, head_side=side)
        got = gaussian_edge.gaussian_bias_stats(_t(m_s), _t(m_o), _t(b_o), tp,
                                                head=tb.head, head_side=side)
        _tier_gate(got.numpy(), ref, side)


@WIDE_KS
def test_k6_diag_stats_match_jax(small_ratings, K):
    sides, jb, tb = _gauss_case(small_ratings, K, 7 * K)
    for side, (m_s, _, b_s, _), (m_o, _, b_o, v_o), jp, tp in sides:
        ref = jge.gaussian_diag_stats(m_o, v_o, m_s, b_s, b_o, jp, use_bias=True,
                                      precision="high", interpret=True, head=jb.head,
                                      head_side=side)
        got = gaussian_edge.gaussian_diag_stats(_t(m_o), _t(v_o), _t(m_s), _t(b_s),
                                                _t(b_o), tp, use_bias=True,
                                                head=tb.head, head_side=side)
        for n, (g, r) in enumerate(zip(got, ref)):
            _tier_gate(g.numpy(), r, f"{side} stat {n}")


def _ext_case(small_ratings, K, seed):
    jb, tb = _layouts(small_ratings, small_ratings[2] + 1.0)
    rng = np.random.default_rng(seed)
    th, be, th_new, be_new = (_gamma(rng, n, K) for n in (N_USERS, N_ITEMS) * 2)
    phi, psi = _gamma(rng, N_USERS), _gamma(rng, N_ITEMS)
    return jb, tb, (("user", th, be, psi, th_new, jb.by_user, tb.by_user),
                    ("item", be, th, phi, be_new, jb.by_item, tb.by_item))


@WIDE_KS
def test_k7_factor_stats_match_jax(small_ratings, K):
    jb, tb, sides = _ext_case(small_ratings, K, 11 * K)
    for side, es, eo, so, _, jp, tp in sides:
        ref = jext.ext_factor_stats(jnp.asarray(es), jnp.asarray(eo), jnp.asarray(so),
                                    jp, precision="high", interpret=True,
                                    head=jb.head, head_side=side)
        got = ext_edge.ext_factor_stats(_t(es), _t(eo), _t(so), tp, head=tb.head,
                                        head_side=side)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4, atol=1e-5,
                                       err_msg=side)


@WIDE_KS
def test_k8_scalar_stats_match_jax(small_ratings, K):
    jb, tb, sides = _ext_case(small_ratings, K, 13 * K)
    for side, _, eo, so, es_new, jp, tp in sides:
        ref = jext.ext_scalar_stats(jnp.asarray(es_new), jnp.asarray(eo),
                                    jnp.asarray(so), jp, precision="high",
                                    interpret=True, head=jb.head, head_side=side)
        got = ext_edge.ext_scalar_stats(_t(es_new), _t(eo), _t(so), tp, head=tb.head,
                                        head_side=side)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=1e-5,
                                   err_msg=side)


@pytest.fixture(scope="module")
def jax_map_layout():
    u, i, x, n_users, n_items = map_data()
    return j_map.build_map_layout(u, i, x, n_users, n_items, batch_size=4 * 2048,
                                  dtype=np.float32, mix=4)


@WIDE_KS
def test_k9_step_matches_jax_kernel(jax_map_layout, K):
    lay = jax_map_layout
    u_sp, i_sp = softplus_tables(lay.n_users, lay.n_items, K, np.float32, seed=K)
    seg_ids = (0, 3, 5)
    ref_u, ref_i = jax_step_accumulators(u_sp, i_sp, lay, seg_ids)
    got_u, got_i = map_grad.map_grad_step(_t(u_sp), _t(i_sp), port_layout(lay, mix=4),
                                          seg_ids, t_map.LAMBDA_FLOOR)
    assert got_u.shape == (lay.n_users, K + 2) and got_i.shape == (lay.n_items, K + 1)
    np.testing.assert_allclose(got_u.numpy(), ref_u, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_i.numpy(), ref_i, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(got_u[:, K].numpy(), ref_u[:, K])


# ------------------------------------------------ blocked fits at K = 50 --

def _shifted(small_splits):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    return (tu, ti, tx + 1.0), (vu, vi, vx + 1.0)


def _same_history(tm, jm):
    assert len(tm.fit_history) == len(jm.fit_history) > 0
    for t_rec, j_rec in zip(tm.fit_history, jm.fit_history):
        assert t_rec["iteration"] == j_rec["iteration"]
        assert abs(t_rec["val_rmse"] - j_rec["val_rmse"]) < 1e-4
        assert abs(t_rec["val_macro_mae"] - j_rec["val_macro_mae"]) < 1e-4


def test_hpf_blocked_fit_at_k50_matches_jax(small_splits):
    train, val = _shifted(small_splits)
    kw = dict(n_factors=50, max_iter=4, tol=None, verbose=False, engine="blocked_high")
    jm = jhpf.HPF(jhpf.HPFConfig(**kw)).fit(train, val)
    tm = thpf.HPF(thpf.HPFConfig(**kw)).fit(train, val, device="cpu")
    _same_history(tm, jm)


@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
def test_poisson_blocked_fit_at_k50_matches_jax(small_splits, extended):
    train, val, _ = small_splits
    kw = dict(n_factors=50, max_iter=4, tol=None, verbose=False,
              engine="blocked_high", extended=extended)
    jm = jpmf.PoissonMF(jpmf.PoissonMFConfig(**kw)).fit(train, val)
    tm = tpmf.PoissonMF(tpmf.PoissonMFConfig(**kw)).fit(train, val, device="cpu")
    _same_history(tm, jm)


@pytest.mark.parametrize("covariance", ["full", "diag"])
def test_gaussian_blocked_fit_at_k50_matches_jax(small_splits, covariance):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    mean = float(tx.mean())
    train, val = (tu, ti, tx - mean), (vu, vi, vx - mean)
    # The default priors: with the tighter ones of the K = 5 tests the diag
    # fit diverges at K = 50 on this small split (in both packages).
    kw = dict(n_factors=50, max_iter=4, tol=None, verbose=False, engine="blocked_high",
              covariance=covariance)
    jm = jg.GaussianMF(jg.GaussianMFConfig(**kw)).fit(train, val, global_mean=mean)
    tm = tg.GaussianMF(tg.GaussianMFConfig(**kw)).fit(train, val, global_mean=mean,
                                                      device="cpu")
    _same_history(tm, jm)


def test_hpf_map_blocked_epoch_at_k50_matches_jax():
    """One blocked epoch on the JAX layout's segments in the JAX epoch's
    segment order, at K = 50 (the fits draw other segments, so the epoch
    is the comparison)."""
    from tests.test_torch_hpf_map import SCAL, _compare_state, _j, _scales
    import jax
    import optax

    u, i, x, n_users, n_items = map_data()
    mix = 3
    cfg = t_map.HPFMapConfig(n_factors=50, random_state=0, lr=0.01)
    lay = j_map.build_map_layout(u, i, x, n_users, n_items, batch_size=mix * 2048,
                                 dtype=np.float32, mix=mix)
    us, is_ = _scales(u, i, n_users, n_items, np.float32)
    u_o2n, i_o2n = np.asarray(lay.u_old_of_new), np.asarray(lay.i_old_of_new)
    p_np = t_map._init_params_numpy(n_users, n_items, cfg)
    p_new = {"user": p_np["user"][u_o2n], "item": p_np["item"][i_o2n]}
    key = jax.random.key(5)
    perm = np.array(jax.random.permutation(key, lay.n_segments))
    opt = optax.adam(cfg.lr)
    jp = _j(p_new)
    jp, js, j_loss = j_map.train_epoch_blocked(
        jp, opt.init(jp), key, lay, jnp.asarray(us[u_o2n]), jnp.asarray(is_[i_o2n]),
        SCAL, opt, precision="highest", interpret=True, mix=mix)
    tp = t_map.params_from_numpy(p_new, device="cpu")
    tp, ts, t_loss = t_map.train_epoch_blocked(
        tp, adam_init(tp), perm, port_layout(lay, mix), _t(us[u_o2n]), _t(is_[i_o2n]),
        SCAL, cfg.lr, mix)
    _compare_state(tp, ts, jp, js, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4)


# ----------------------------------------------- launch plan and dispatch --

@pytest.mark.parametrize("K,blocks,groups", [(1, 1, 1), (20, 3, 1), (32, 4, 1),
                                             (33, 8, 2), (50, 8, 2), (64, 8, 2),
                                             (65, 12, 3), (128, 16, 4)])
def test_k2_depth_and_output_groups(K, blocks, groups):
    """Up to K = 32 the depth pads to blocks of 8; past it to whole groups
    of 4 blocks, one CTA a group (grid.z)."""
    assert dense_head.depth_blocks(K) == blocks and 8 * blocks >= K
    assert dense_head.output_groups(K) == groups
    if K > 32:
        assert blocks == dense_head.GROUP_BLOCKS * groups


REAL_TIERS = [(3072, 59392), (9216, 14848), (36864, 4096), (112640, 1024), (70, 128)]


@pytest.mark.parametrize("K", [33, 50, 128])
@pytest.mark.parametrize("rows,hip", REAL_TIERS)
def test_k2_plan_fits_shared_memory_past_k32(rows, hip, K):
    """The wide instances' ring fits one CTA's shared memory, two CTAs fit
    an SM (the launch bounds' count), and the grid counts each P tile once
    a group of outputs."""
    for item_side in (False, True):
        for m_f32, has_lo in ((False, False), (False, True), (True, True)):
            plan = dense_head.plan_launch(rows, hip, K, item_side, m_f32, has_lo, 132)
            nt = dense_head.depth_blocks(K)
            assert plan.depth == 8 * nt and plan.groups == nt // 4
            assert plan.smem_bytes == plan.stages * dense_head.stage_bytes(
                item_side, m_f32, has_lo, K) <= 232_448
            assert plan.ctas_per_sm == dense_head.MAX_CTAS_PER_SM_WIDE == 2
            assert plan.ctas_per_sm * (plan.smem_bytes + 1024) <= 233_472
            n_q = rows if item_side else hip
            serial = -(-n_q // plan.q_tile)
            assert (plan.splits - 1) * plan.tiles_per_split < serial
            assert plan.splits * plan.tiles_per_split >= serial


def test_k2_plan_keeps_the_k32_plans():
    """The K <= 32 plans are those of the three-CTA instances."""
    plan = dense_head.plan_launch(36864, 4096, 20, False, False, True, 132)
    assert plan.groups == 1 and plan.ctas_per_sm == 3 and plan.depth == 24
    with pytest.raises(ValueError, match="K <= 128"):
        dense_head.plan_launch(36864, 4096, 129, False, False, True, 132)


def _emulate_wide(theta, beta, x_hi, m, x_lo, item_side):
    """K2's wide form: the depth padded to 8 depth_blocks(K) columns, each
    output group of 32 factors from its own recomputed R (the same R, so
    the groups side by side are the whole product)."""
    K = theta.shape[1]
    pad = 8 * dense_head.depth_blocks(K) - K
    th = torch.nn.functional.pad(theta, (0, pad))
    be = torch.nn.functional.pad(beta, (0, pad))
    out, _ = _emulate_kernel(th, be, x_hi, m, x_lo, 1e-10, item_side)
    width = th.shape[1]
    groups = [torch.cat([out[:, 32 * z : 32 * z + 32],
                         out[:, width + 32 * z : width + 32 * z + 32]], dim=1)
              for z in range(dense_head.output_groups(K))]
    w = torch.cat([g[:, :32] for g in groups], dim=1)[:, :K]
    mo = torch.cat([g[:, 32:] for g in groups], dim=1)[:, :K]
    return torch.cat([w, mo], dim=1)


@pytest.mark.parametrize("K", [50, 128])
@pytest.mark.parametrize("item_side", [False, True], ids=["user", "item"])
def test_k2_wide_arithmetic_matches_plain_float64(small_ratings, K, item_side):
    """The wide form's bf16-plane arithmetic over a padded depth holds the
    card check's 1e-4 against the plain version in float64."""
    u, i, x = small_ratings
    h = t_build_blocked(u, i, x + 1.0 + 0.013 * np.arange(len(x)) % 0.7, reorder=True,
                        head=(40, 60), head_r0=4, device="cpu").head[0]
    rng = np.random.default_rng(K)
    theta = _t(rng.gamma(0.3, 1.0, size=(h.hu, K)).astype(np.float32))
    beta = np.zeros((h.hip, K), np.float32)
    beta[: h.hi] = rng.gamma(0.3, 1.0, size=(h.hi, K))
    beta = _t(beta)
    got = _emulate_wide(theta, beta, h.x_hi, h.m, h.x_lo, item_side)
    ref = dense_head.fused_alloc_tier_plain(theta.double(), beta.double(), h.x_hi, h.m,
                                            h.x_lo, rate_floor=1e-10,
                                            item_side=item_side)
    assert got.shape == ref.shape
    torch.testing.assert_close(got.double(), ref, rtol=1e-4, atol=0)


def _gj_in_place(mats):
    """K4's CTA form in float64: the elimination in place, column p of A
    turned into column p of the inverse at pivot p."""
    a = mats.astype(np.float64).copy()
    R, K, _ = a.shape
    for p in range(K):
        piv = a[:, p, p].copy()
        row = a[:, p, :].copy()
        row[:, p] = 1.0
        row = row / piv[:, None]
        col = a[:, :, p].copy()
        a[:, :, p] = 0.0
        a = a - col[:, :, None] * row[:, None, :]
        a[:, p, :] = row
    return a


@pytest.mark.parametrize("K", [33, 50, 128])
def test_k4_in_place_elimination_equals_the_plain_version(K):
    """The CTA form's in-place elimination takes the same operations on the
    same values as the plain [A | I] form: equal in float64."""
    rng = np.random.default_rng(K)
    A = rng.standard_normal((6, K, K + 3)) * 0.5
    mats = np.eye(K) / 0.4 + A @ np.transpose(A, (0, 2, 1)) / 0.5
    ref = gj_inverse.batched_psd_inverse_gj_plain(_t(mats)).numpy()
    np.testing.assert_allclose(_gj_in_place(mats), ref, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(ref @ mats, np.broadcast_to(np.eye(K), mats.shape),
                               atol=1e-9)


# ---------------------------------------------- the bound at K = 129 --

def _csr(n_self, n_other, nnz):
    row_ptr = torch.full((n_self + 1,), nnz, dtype=torch.int64)
    row_ptr[0] = 0
    other = torch.arange(nnz, dtype=torch.int32) % n_other
    return tuple(_cuda_looking(t) for t in (row_ptr, other, torch.ones(nnz)))


def _wide(*shape):
    return _cuda_looking(torch.rand(*shape))


K9 = 129
WRAPPERS = {
    "K1": lambda: cavi_edge.tail_edge_stats(_wide(3, K9), _wide(5, K9), *_csr(3, 5, 4)),
    "K1raw": lambda: cavi_edge.tail_edge_stats(_wide(3, K9), _wide(5, K9),
                                               *_csr(3, 5, 4)[:2], None, mode="raw"),
    "K2": lambda: dense_head.fused_alloc_tier(
        _wide(8, K9), _wide(128, K9),
        _cuda_looking(torch.ones(8, 128, dtype=torch.bfloat16)),
        _cuda_looking(torch.ones(8, 128, dtype=torch.bfloat16)), rate_floor=1e-10),
    "K3": lambda: gaussian_edge.factor_tail_stats(
        _wide(5, K9 + 1 + K9 * (K9 + 1) // 2), *_csr(3, 5, 4), K9),
    "K4": lambda: gj_inverse.batched_psd_inverse_gj(_wide(2, K9, K9)),
    "K5": lambda: gaussian_edge.bias_tail_stats(_wide(5, 132), *_csr(3, 5, 4), K=K9),
    "K6": lambda: gaussian_edge.diag_tail_stats(_wide(3, 132), _wide(5, 132),
                                                _wide(5, 132), *_csr(3, 5, 4), K=K9),
    "K7": lambda: ext_edge.ext_factor_tail(_wide(3, K9), _wide(5, 132), *_csr(3, 5, 4)),
    "K8": lambda: ext_edge.ext_scalar_tail(_wide(3, K9), _wide(5, 132),
                                           *_csr(3, 5, 4)[:2]),
    "K9": lambda: map_grad.map_grad_pieces(*_map_args(K=K9)),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_every_wrapper_names_the_k128_bound(kernel):
    """Each kernel wrapper raises on K = 129 before anything is built, and
    says where the bound lies."""
    with pytest.raises(ValueError, match="1 <= K <= 128"):
        WRAPPERS[kernel]()


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_every_wrapper_takes_k128_on_the_cpu(kernel):
    """On CPU tensors K = 128 runs each wrapper's plain version."""
    k = 128
    cpu = {
        "K1": lambda: cavi_edge.tail_edge_stats(
            torch.rand(3, k), torch.rand(5, k), torch.tensor([0, 2, 2, 4]),
            torch.tensor([0, 4, 1, 2], dtype=torch.int32), torch.ones(4)),
        "K1raw": lambda: cavi_edge.tail_edge_stats(
            torch.rand(3, k), torch.rand(5, k), torch.tensor([0, 2, 2, 4]),
            torch.tensor([0, 4, 1, 2], dtype=torch.int32), None, mode="raw"),
        "K2": lambda: dense_head.fused_alloc_tier(
            torch.rand(8, k), torch.rand(128, k), torch.ones(8, 128, dtype=torch.bfloat16),
            torch.ones(8, 128, dtype=torch.bfloat16), rate_floor=1e-10),
        "K3": lambda: gaussian_edge.factor_tail_stats(
            torch.rand(5, k + 1 + k * (k + 1) // 2), torch.tensor([0, 2, 2, 4]),
            torch.tensor([0, 4, 1, 2], dtype=torch.int32), torch.ones(4), k),
        "K4": lambda: gj_inverse.batched_psd_inverse_gj(
            torch.eye(k).expand(2, k, k) * 2.0),
        "K5": lambda: gaussian_edge.bias_tail_stats(
            torch.rand(5, k + 1), torch.tensor([0, 2, 2, 4]),
            torch.tensor([0, 4, 1, 2], dtype=torch.int32), torch.ones(4)),
        "K6": lambda: gaussian_edge.diag_tail_stats(
            torch.rand(3, k + 1), torch.rand(5, k + 1), torch.rand(5, k),
            torch.tensor([0, 2, 2, 4]),
            torch.tensor([0, 4, 1, 2], dtype=torch.int32), torch.ones(4)),
        "K7": lambda: ext_edge.ext_factor_tail(
            torch.rand(3, k), torch.rand(5, k + 1), torch.tensor([0, 2, 2, 4]),
            torch.tensor([0, 4, 1, 2], dtype=torch.int32), torch.ones(4)),
        "K8": lambda: ext_edge.ext_scalar_tail(
            torch.rand(3, k), torch.rand(5, k + 1), torch.tensor([0, 2, 2, 4]),
            torch.tensor([0, 4, 1, 2], dtype=torch.int32)),
        "K9": lambda: map_grad.map_grad_pieces(*_cpu_map_args(k)),
    }[kernel]
    out = cpu()
    assert out is None or bool(torch.isfinite(out).all())


def _cpu_map_args(k):
    args = _map_args(K=k)
    g = args[2]
    g = dataclasses.replace(g, **{
        f.name: getattr(g, f.name).as_subclass(torch.Tensor) for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor)})
    return [torch.rand(3, k + 1), torch.rand(5, k + 1), g, 0, 1e-6, True,
            torch.zeros(3, k + 2)]
