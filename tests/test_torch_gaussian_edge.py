"""Port ``gaussian_{factor,bias,diag}_stats`` (CSR tail + dense head
tiers; kernels K3, K5, K6 through their plain versions on the CPU) and
the Gaussian head products against the JAX package: in float32 against
the blocked Pallas passes in interpret mode at the JAX package's own
precision-tier gate (max |port - jax| <= 1e-4 * max |jax| per statistic,
``tests/test_gaussian_lagged.py``), and in float64 against flat segment
sums at 1e-8.

The float64 cases centre the ratings by a mean rounded to 1/8, so every
head cell sum is exact in the stored bf16 ``x_hi`` + ``x_lo`` planes and
the head adds no storage error."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.ops import dense_head as jdh
from pmf_tpu.ops.pallas import gaussian_edge as jge
from pmf_tpu.ops.segment import edge_dot, gather_rows, sorted_segment_sum
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.ops import dense_head as tdh
from pmf_tpu_torch.ops import gaussian_edge as tge

torch.set_num_threads(1)

N_USERS, N_ITEMS, K = 120, 80, 5
HEADS = [None, (16, 24), [(0, 8, 40), (8, 24, 12)]]
HEAD_IDS = ["tail_only", "one_tier", "staircase"]


def _centred(x, exact):
    mean = np.round(x.mean() * 8) / 8 if exact else x.mean()
    return (x - mean).astype(np.float64 if exact else np.float32)


def _tables(n, dtype, seed):
    """Random (m, V, b, v) rows: V symmetric positive-definite."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, K))
    A = rng.standard_normal((n, K, K)) * 0.3
    V = 0.5 * np.eye(K) + A @ np.transpose(A, (0, 2, 1))
    b = rng.standard_normal(n) * 0.5
    v = rng.gamma(1.0, 0.5, size=(n, K))
    return tuple(a.astype(dtype) for a in (m, V, b, v))


def _layouts(small_ratings, head, exact):
    u, i, x = small_ratings
    xc = _centred(x, exact)
    tb = t_build_blocked(u, i, xc, n_users=N_USERS, n_items=N_ITEMS,
                         dtype=xc.dtype, reorder=True, head=head, head_r0=4,
                         device="cpu")
    if exact:
        return xc, tb, j_build_ratings(u, i, xc, n_users=N_USERS,
                                       n_items=N_ITEMS, dtype=np.float64)
    jb = j_build_blocked(u, i, xc, n_users=N_USERS, n_items=N_ITEMS,
                         block_users=32, block_items=32, chunk_size=16,
                         group=2, reorder=True, head=head, head_r0=4)
    return xc, tb, jb


def _sides(users, items, tb, j):
    """(side, self tables, other tables, port pass, JAX pass or flat ids)."""
    if hasattr(j, "u_by_u"):
        ju = (j.u_by_u, j.i_by_u, j.x_by_u, N_USERS)
        ji = (j.i_by_i, j.u_by_i, j.x_by_i, N_ITEMS)
    else:
        ju, ji = j.by_user, j.by_item
    return (("user", users, items, tb.by_user, ju),
            ("item", items, users, tb.by_item, ji))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_tier_gate(got, ref, what):
    """The JAX package's precision-tier gate, per statistic."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4, err_msg=what)


# ------------------------------------------------------------- layout --

@pytest.mark.parametrize("head", HEADS[1:], ids=HEAD_IDS[1:])
def test_head_rating_sums_match_jax(small_ratings, head):
    u, i, x = small_ratings
    xc = _centred(x, exact=False)
    jb = j_build_blocked(u, i, xc, n_users=N_USERS, n_items=N_ITEMS,
                         block_users=32, block_items=32, chunk_size=16,
                         group=2, reorder=True, head=head, head_r0=4)
    tb = t_build_blocked(u, i, xc, n_users=N_USERS, n_items=N_ITEMS,
                         reorder=True, head=head, head_r0=4, device="cpu")
    assert len(tb.head) == len(jb.head)
    for th, jh in zip(tb.head, jb.head):
        assert th.x_sum_user.dtype == th.x_sum_item.dtype == torch.float32
        assert th.x_sum_user.shape == (th.hu,) and th.x_sum_item.shape == (th.hip,)
        np.testing.assert_allclose(th.x_sum_user.numpy(), np.asarray(jh.x_sum_user),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(th.x_sum_item.numpy(), np.asarray(jh.x_sum_item),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("k", [1, 5, 20])
def test_pack_unpack_tri_round_trip_and_match_jax(k):
    rng = np.random.default_rng(k)
    A = rng.standard_normal((7, k, k))
    sym = A + np.transpose(A, (0, 2, 1))
    tri = tge.pack_tri(_t(sym.reshape(7, k * k)), k)
    assert tri.shape == (7, tge.tri_size(k))
    np.testing.assert_array_equal(tri.numpy(),
                                  np.asarray(jge.pack_tri(sym.reshape(7, k * k), k)))
    np.testing.assert_array_equal(tge.unpack_tri(tri, k).numpy(), sym)


@pytest.mark.parametrize("copies", [0, 300, 70_000], ids=["bf16", "f32", "past_2^16"])
def test_m_bf16_planes_sum_to_m_and_are_kept(small_ratings, copies):
    """The card's M operand: one bf16 plane, or (counts past 256) the top
    16 bits and the remainder, exact below 2^16 and within 2^-16 past it."""
    u, i, x = small_ratings
    uu = np.concatenate([u, np.full(copies, u[0])])
    ii = np.concatenate([i, np.full(copies, i[0])])
    xx = np.concatenate([x, np.full(copies, 2.0)])
    head = t_build_blocked(uu, ii, xx, reorder=True, head=(16, 24), head_r0=4,
                           device="cpu").head[0]
    planes = head.m_bf16_planes()
    assert all(p.dtype == torch.bfloat16 for p in planes)
    assert len(planes) == (1 if copies == 0 else 2)
    total = sum(p.double() for p in planes)
    m = head.m.double()
    np.testing.assert_allclose(total.numpy(), m.numpy(),
                               rtol=0 if copies < 65536 else 2**-16)
    assert head.m_bf16_planes()[0] is planes[0]


# -------------------------------------------------------- head products --

@pytest.mark.parametrize("transposed", [False, True], ids=["user", "item"])
def test_head_products_match_jax(small_ratings, transposed):
    """On the CPU the products are plain matmuls over the summed planes;
    against the JAX "highest" tier (f32 dots on the recombined cells)."""
    u, i, x = small_ratings
    xc = _centred(x, exact=False)
    jb = j_build_blocked(u, i, xc, n_users=N_USERS, n_items=N_ITEMS,
                         block_users=32, block_items=32, chunk_size=16,
                         group=2, reorder=True, head=(16, 24), head_r0=4)
    tb = t_build_blocked(u, i, xc, n_users=N_USERS, n_items=N_ITEMS,
                         reorder=True, head=(16, 24), head_r0=4, device="cpu")
    jh, th = jb.head[0], tb.head[0]
    rng = np.random.default_rng(3)
    n = th.hu if transposed else th.hip
    tab = rng.standard_normal((n, 9)).astype(np.float32)
    xtab = rng.standard_normal((n, 4)).astype(np.float32)
    jfn = jdh.head_products_t if transposed else jdh.head_products
    tfn = tdh.head_products_t if transposed else tdh.head_products
    ref = jfn(jh, tab, xtab, precision="highest")
    got = tfn(th, _t(tab), _t(xtab))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    mp, xp = tfn(th, _t(tab), None)
    assert xp is None
    np.testing.assert_array_equal(mp.numpy(), got[0].numpy())


# ------------------------------------------------------------------ K3 --

def _flat_factor(m_o, V_o, b_s, b_o, ids, with_bias_stats):
    s_ids, o_ids, xs, n_self = ids
    m_e = gather_rows(jnp.asarray(m_o), o_ids)
    A = (V_o + m_o[:, :, None] * m_o[:, None, :]).reshape(-1, K * K)
    S_A = sorted_segment_sum(gather_rows(jnp.asarray(A), o_ids), s_ids,
                             n_self).reshape(n_self, K, K)
    b_oe = gather_rows(jnp.asarray(b_o), o_ids)
    resid = xs - gather_rows(jnp.asarray(b_s), s_ids) - b_oe
    S_w = sorted_segment_sum(m_e * resid[:, None], s_ids, n_self)
    if not with_bias_stats:
        return S_w, S_A
    return (S_w, S_A, sorted_segment_sum(m_e, s_ids, n_self),
            sorted_segment_sum(xs, s_ids, n_self),
            sorted_segment_sum(b_oe, s_ids, n_self))


@pytest.mark.parametrize("with_bias_stats", [False, True], ids=["exact", "lagged"])
@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_factor_stats_match_jax_interpret(small_ratings, head, with_bias_stats):
    _, tb, jb = _layouts(small_ratings, head, exact=False)
    users, items = _tables(N_USERS, np.float32, 0), _tables(N_ITEMS, np.float32, 1)
    for side, (m_s, _, b_s, _), (m_o, V_o, b_o, _), tp, jp in _sides(users, items, tb, jb):
        ref = jge.gaussian_factor_stats(
            m_o, V_o, b_s, b_o, jp, use_bias=True, precision="high",
            interpret=True, with_bias_stats=with_bias_stats, head=jb.head,
            head_side=side)
        got = tge.gaussian_factor_stats(
            _t(m_o), _t(V_o), _t(b_s), _t(b_o), tp, use_bias=True,
            with_bias_stats=with_bias_stats, head=tb.head, head_side=side)
        assert len(got) == len(ref)
        for n, (g, r) in enumerate(zip(got, ref)):
            assert g.dtype == torch.float32
            _assert_tier_gate(g.numpy(), r, f"{side} stat {n}")


@pytest.mark.parametrize("with_bias_stats", [False, True], ids=["exact", "lagged"])
@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_factor_stats_float64_match_flat(small_ratings, head, with_bias_stats):
    _, tb, flat = _layouts(small_ratings, head, exact=True)
    users, items = _tables(N_USERS, np.float64, 2), _tables(N_ITEMS, np.float64, 3)
    for side, (_, _, b_s, _), (m_o, V_o, b_o, _), tp, ids in _sides(users, items, tb, flat):
        ref = _flat_factor(m_o, V_o, b_s, b_o, ids, with_bias_stats)
        got = tge.gaussian_factor_stats(
            _t(m_o), _t(V_o), _t(b_s), _t(b_o), tp, use_bias=True,
            with_bias_stats=with_bias_stats, head=tb.head, head_side=side)
        for n, (g, r) in enumerate(zip(got, ref)):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-8,
                                       atol=1e-8, err_msg=f"{side} stat {n}")


def test_factor_stats_without_bias_ignore_the_biases(small_ratings):
    _, tb, flat = _layouts(small_ratings, (16, 24), exact=True)
    m_o, V_o, b_o, _ = _tables(N_ITEMS, np.float64, 4)
    b_s = _tables(N_USERS, np.float64, 5)[2]
    zeros = (np.zeros_like(b_s), np.zeros_like(b_o))
    ref = _flat_factor(m_o, V_o, *zeros, (flat.u_by_u, flat.i_by_u, flat.x_by_u,
                                          N_USERS), False)
    got = tge.gaussian_factor_stats(_t(m_o), _t(V_o), _t(b_s), _t(b_o), tb.by_user,
                                    use_bias=False, head=tb.head)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-8, atol=1e-8)
    with pytest.raises(ValueError, match="with_bias_stats requires use_bias"):
        tge.gaussian_factor_stats(_t(m_o), _t(V_o), _t(b_s), _t(b_o), tb.by_user,
                                  use_bias=False, with_bias_stats=True)


# ------------------------------------------------------------------ K5 --

@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_bias_stats_match_jax_interpret(small_ratings, head):
    _, tb, jb = _layouts(small_ratings, head, exact=False)
    users, items = _tables(N_USERS, np.float32, 6), _tables(N_ITEMS, np.float32, 7)
    for side, (m_s, *_), (m_o, _, b_o, _), tp, jp in _sides(users, items, tb, jb):
        ref = jge.gaussian_bias_stats(m_s, m_o, b_o, jp, precision="high",
                                      interpret=True, head=jb.head, head_side=side)
        got = tge.gaussian_bias_stats(_t(m_s), _t(m_o), _t(b_o), tp, head=tb.head,
                                      head_side=side)
        _assert_tier_gate(got.numpy(), ref, side)


@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_bias_stats_float64_match_flat(small_ratings, head):
    _, tb, flat = _layouts(small_ratings, head, exact=True)
    users, items = _tables(N_USERS, np.float64, 8), _tables(N_ITEMS, np.float64, 9)
    for side, (m_s, *_), (m_o, _, b_o, _), tp, ids in _sides(users, items, tb, flat):
        s_ids, o_ids, xs, n_self = ids
        inter = edge_dot(gather_rows(jnp.asarray(m_s), s_ids),
                         gather_rows(jnp.asarray(m_o), o_ids))
        resid = xs - gather_rows(jnp.asarray(b_o), o_ids) - inter
        ref = sorted_segment_sum(resid, s_ids, n_self)
        got = tge.gaussian_bias_stats(_t(m_s), _t(m_o), _t(b_o), tp, head=tb.head,
                                      head_side=side)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8,
                                   atol=1e-8, err_msg=side)


# ------------------------------------------------------------------ K6 --

@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_diag_stats_match_jax_interpret(small_ratings, head, use_bias):
    _, tb, jb = _layouts(small_ratings, head, exact=False)
    users, items = _tables(N_USERS, np.float32, 10), _tables(N_ITEMS, np.float32, 11)
    for side, (m_s, _, b_s, _), (m_o, _, b_o, v_o), tp, jp in _sides(users, items, tb, jb):
        ref = jge.gaussian_diag_stats(m_o, v_o, m_s, b_s, b_o, jp,
                                      use_bias=use_bias, precision="high",
                                      interpret=True, head=jb.head, head_side=side)
        got = tge.gaussian_diag_stats(_t(m_o), _t(v_o), _t(m_s), _t(b_s), _t(b_o),
                                      tp, use_bias=use_bias, head=tb.head,
                                      head_side=side)
        for n, (g, r) in enumerate(zip(got, ref)):
            _assert_tier_gate(g.numpy(), r, f"{side} stat {n}")


@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_diag_stats_float64_match_flat(small_ratings, head):
    _, tb, flat = _layouts(small_ratings, head, exact=True)
    users, items = _tables(N_USERS, np.float64, 12), _tables(N_ITEMS, np.float64, 13)
    for side, (m_s, _, b_s, _), (m_o, _, b_o, v_o), tp, ids in _sides(users, items, tb, flat):
        s_ids, o_ids, xs, n_self = ids
        m_e = gather_rows(jnp.asarray(m_o), o_ids)
        pred = edge_dot(gather_rows(jnp.asarray(m_s), s_ids), m_e)
        resid = (xs - gather_rows(jnp.asarray(b_s), s_ids)
                 - gather_rows(jnp.asarray(b_o), o_ids))
        ref = (sorted_segment_sum(m_e * (resid - pred)[:, None], s_ids, n_self),
               sorted_segment_sum(gather_rows(jnp.asarray(v_o + m_o * m_o), o_ids),
                                  s_ids, n_self),
               sorted_segment_sum(m_e * m_e, s_ids, n_self))
        got = tge.gaussian_diag_stats(_t(m_o), _t(v_o), _t(m_s), _t(b_s), _t(b_o),
                                      tp, use_bias=True, head=tb.head,
                                      head_side=side)
        for n, (g, r) in enumerate(zip(got, ref)):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-8,
                                       atol=1e-8, err_msg=f"{side} stat {n}")


# ------------------------------------------------------ tail wrappers --

def test_tail_wrappers_on_cpu_are_the_plain_versions_and_chunk(small_ratings):
    """The wrappers run the plain versions for CPU tensors, and the plain
    versions' edge chunks (which bound their temporaries on the card)
    change nothing but the summation grouping."""
    _, tb, _ = _layouts(small_ratings, None, exact=True)
    p = tb.by_item
    rng = np.random.default_rng(14)
    T = tge.tri_size(K)
    aug3 = _t(rng.standard_normal((N_USERS, K + 1 + T)))
    m_o, sq_o = (_t(rng.standard_normal((N_USERS, K))) for _ in range(2))
    b_o = _t(rng.standard_normal(N_USERS))
    m_s, b_s = _t(rng.standard_normal((N_ITEMS, K))), _t(rng.standard_normal(N_ITEMS))
    args = (p.row_ptr, p.other, p.x)
    before = (tge.FACTOR_LAUNCHES.count, tge.BIAS_LAUNCHES.count,
              tge.DIAG_LAUNCHES.count)
    for wbs in (False, True):
        whole = tge.factor_tail_stats(aug3, *args, K, wbs)
        assert whole.shape == (N_ITEMS, 2 * K + T + 2 * wbs)
        np.testing.assert_array_equal(
            whole.numpy(), tge.factor_tail_stats_plain(aug3, *args, K, wbs).numpy())
        np.testing.assert_allclose(
            tge.factor_tail_stats_plain(aug3, *args, K, wbs, max_edges=7).numpy(),
            whole.numpy(), rtol=1e-12, atol=1e-12)
    mb_o, mb_s = tge.record_table(m_o, b_o), tge.record_table(m_s, b_s)
    whole = tge.bias_tail_stats(mb_o, *args, K=K)
    assert whole.shape == (N_ITEMS, K + 2)
    np.testing.assert_allclose(tge.bias_tail_stats_plain(mb_o, *args, K=K, max_edges=7),
                               whole, rtol=1e-12, atol=1e-12)
    whole = tge.diag_tail_stats(mb_s, mb_o, sq_o, *args, K=K)
    assert whole.shape == (N_ITEMS, 3 * K)
    np.testing.assert_allclose(tge.diag_tail_stats_plain(mb_s, mb_o, sq_o, *args, K=K,
                                                         max_edges=7),
                               whole, rtol=1e-12, atol=1e-12)
    assert (tge.FACTOR_LAUNCHES.count, tge.BIAS_LAUNCHES.count,
            tge.DIAG_LAUNCHES.count) == before


def test_row_chunks_cover_every_row_once():
    row_ptr = torch.tensor([0, 3, 3, 20, 21, 25, 25, 30])
    chunks = list(tge._row_chunks(row_ptr, 5))
    assert chunks[0][0] == 0 and chunks[-1][1] == 7
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    for r0, r1 in chunks:
        edges = int(row_ptr[r1] - row_ptr[r0])
        assert edges <= 5 or r1 - r0 == 1
    assert list(tge._row_chunks(row_ptr, None)) == [(0, 7)]
