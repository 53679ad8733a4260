"""Port extended-Poisson edge passes (CSR tail + dense head tiers, the
plain versions of kernels K7 and K8 on the CPU) against the JAX package:
the blocked Pallas passes in interpret mode at the reference's own engine
gate (5e-4 / 1e-5), in float64 against flat segment sums at 1e-9, and the
head statistics on one tier."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.ops import dense_head as jdh
from pmf_tpu.ops.pallas import ext_edge as jext
from pmf_tpu.ops.segment import edge_dot, gather_rows, sorted_segment_sum
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.ops import dense_head as tdh
from pmf_tpu_torch.ops import ext_edge

torch.set_num_threads(1)

HEADS = [None, (16, 24), [(0, 8, 40), (8, 24, 12)]]
HEAD_IDS = ["tail_only", "one_tier", "staircase"]
SIDES = pytest.mark.parametrize("side", ["user", "item"])


def _tables(dtype, K=6, seed=0):
    """(E_theta, E_beta, E_theta_new, E_beta_new, E_phi, E_psi) for 120
    users and 80 items."""
    rng = np.random.default_rng(seed)
    g = lambda *shape: rng.gamma(1.0, 1.0, size=shape).astype(dtype)  # noqa: E731
    return g(120, K), g(80, K), g(120, K), g(80, K), g(120), g(80)


def _layouts(small_ratings, head, dtype=np.float32):
    u, i, x = small_ratings
    x = x + 1.0  # integer ratings: the head planes hold X exactly
    jb = j_build_blocked(u, i, x, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=head, head_r0=4)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, dtype=dtype,
                         reorder=True, head=head, head_r0=4, device="cpu")
    return (u, i, x), jb, tb


def _pass_args(side, tabs, jb, tb):
    """(E_self, E_other, s_other, E_self_new, JAX pass, port pass)."""
    th, be, th_new, be_new, phi, psi = tabs
    if side == "user":
        return th, be, psi, th_new, jb.by_user, tb.by_user
    return be, th, phi, be_new, jb.by_item, tb.by_item


@SIDES
@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_factor_stats_match_jax_interpret(small_ratings, head, side):
    _, jb, tb = _layouts(small_ratings, head)
    es, eo, so, _, jp, tp = _pass_args(side, _tables(np.float32), jb, tb)
    ref = jext.ext_factor_stats(jnp.asarray(es), jnp.asarray(eo), jnp.asarray(so),
                                jp, precision="high", interpret=True,
                                head=jb.head, head_side=side)
    got = ext_edge.ext_factor_stats(*(torch.from_numpy(t) for t in (es, eo, so)),
                                    tp, head=tb.head, head_side=side)
    for g, r, name in zip(got, ref, ("S_alloc", "S_wother")):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4, atol=1e-5,
                                   err_msg=name)


@SIDES
@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_scalar_stats_match_jax_interpret(small_ratings, head, side):
    _, jb, tb = _layouts(small_ratings, head)
    _, eo, so, es_new, jp, tp = _pass_args(side, _tables(np.float32, seed=1), jb, tb)
    ref = jext.ext_scalar_stats(jnp.asarray(es_new), jnp.asarray(eo),
                                jnp.asarray(so), jp, precision="high",
                                interpret=True, head=jb.head, head_side=side)
    got = ext_edge.ext_scalar_stats(*(torch.from_numpy(t) for t in (es_new, eo, so)),
                                    tp, head=tb.head, head_side=side)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=1e-5)


@SIDES
@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_stats_float64_match_flat(small_ratings, head, side):
    (u, i, x), jb, tb = _layouts(small_ratings, head, dtype=np.float64)
    es, eo, so, es_new, _, tp = _pass_args(side, _tables(np.float64, seed=2), jb, tb)
    flat = j_build_ratings(u, i, x, n_users=120, n_items=80, dtype=np.float64)
    if side == "user":
        sids, oids, xs, n_self = flat.u_by_u, flat.i_by_u, flat.x_by_u, 120
    else:
        sids, oids, xs, n_self = flat.i_by_i, flat.u_by_i, flat.x_by_i, 80
    g_self = gather_rows(jnp.asarray(es), sids)
    g_other = gather_rows(jnp.asarray(eo), oids)
    s_e = gather_rows(jnp.asarray(so), oids)
    dot = jnp.maximum(edge_dot(g_self, g_other), 1e-10)
    refs = (
        sorted_segment_sum((xs / dot)[:, None] * g_self * g_other, sids, n_self),
        sorted_segment_sum(g_other * s_e[:, None], sids, n_self),
        sorted_segment_sum(
            s_e * edge_dot(gather_rows(jnp.asarray(es_new), sids), g_other),
            sids, n_self))
    t = {k: torch.from_numpy(v) for k, v in
         dict(es=es, eo=eo, so=so, es_new=es_new).items()}
    got = (*ext_edge.ext_factor_stats(t["es"], t["eo"], t["so"], tp, head=tb.head,
                                      head_side=side),
           ext_edge.ext_scalar_stats(t["es_new"], t["eo"], t["so"], tp,
                                     head=tb.head, head_side=side))
    for g, r in zip(got, refs):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9)


@pytest.mark.parametrize("transposed", [False, True], ids=["user", "item"])
def test_ext_head_stats_match_jax(small_ratings, transposed):
    _, jb, tb = _layouts(small_ratings, (16, 24))
    jh, th = jb.head[0], tb.head[0]
    rng = np.random.default_rng(3)
    K = 7
    theta = rng.gamma(1.0, 1.0, size=(th.hu, K)).astype(np.float32)
    beta = np.zeros((th.hip, K), np.float32)
    beta[: th.hi] = rng.gamma(1.0, 1.0, size=(th.hi, K))
    if transposed:
        s_tab = rng.gamma(1.0, 1.0, size=(th.hu, 1)).astype(np.float32) * theta
        j_fn, t_fn = jdh.ext_head_stats_t, tdh.ext_head_stats_t
    else:
        s_tab = rng.gamma(1.0, 1.0, size=(th.hip, 1)).astype(np.float32) * beta
        j_fn, t_fn = jdh.ext_head_stats, tdh.ext_head_stats
    ref = j_fn(jnp.asarray(theta), jnp.asarray(beta), jnp.asarray(s_tab), jh,
               1e-10, "high")
    got = t_fn(*(torch.from_numpy(a) for a in (theta, beta, s_tab)), th, 1e-10)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4, atol=1e-5)


def test_tail_wrappers_on_cpu_are_the_plain_versions(small_ratings):
    _, _, tb = _layouts(small_ratings, None)
    p = tb.by_user
    th, be, th_new, _, _, psi = (torch.from_numpy(t)
                                 for t in _tables(np.float32, K=5, seed=4))
    before = (ext_edge.FACTOR_LAUNCHES.count, ext_edge.SCALAR_LAUNCHES.count)
    rec = ext_edge.es_record(be, psi)  # the [e | s] records K7 and K8 read
    got7 = ext_edge.ext_factor_tail(th, rec, p.row_ptr, p.other, p.x)
    ref7 = ext_edge.ext_factor_tail_plain(th, rec, p.row_ptr, p.other, p.x)
    got8 = ext_edge.ext_scalar_tail(th_new, rec, p.row_ptr, p.other)
    ref8 = ext_edge.ext_scalar_tail_plain(th_new, rec, p.row_ptr, p.other)
    assert got7.shape == (120, 10) and got8.shape == (120,)
    torch.testing.assert_close(got7, ref7, rtol=0, atol=0)
    torch.testing.assert_close(got8, ref8, rtol=0, atol=0)
    # no kernel launched
    assert before == (ext_edge.FACTOR_LAUNCHES.count, ext_edge.SCALAR_LAUNCHES.count)


def test_plain_row_chunks_agree(small_ratings):
    _, _, tb = _layouts(small_ratings, None, dtype=np.float64)
    p = tb.by_item
    th, be, _, be_new, phi, _ = (torch.from_numpy(t)
                                 for t in _tables(np.float64, seed=5))
    rec = ext_edge.es_record(th, phi)
    whole7 = ext_edge.ext_factor_tail_plain(be, rec, p.row_ptr, p.other, p.x)
    chunk7 = ext_edge.ext_factor_tail_plain(be, rec, p.row_ptr, p.other, p.x,
                                            max_edges=7)
    whole8 = ext_edge.ext_scalar_tail_plain(be_new, rec, p.row_ptr, p.other)
    chunk8 = ext_edge.ext_scalar_tail_plain(be_new, rec, p.row_ptr, p.other,
                                            max_edges=7)
    torch.testing.assert_close(chunk7, whole7, rtol=1e-12, atol=0)
    torch.testing.assert_close(chunk8, whole8, rtol=1e-12, atol=0)


def test_tail_plain_zero_rows_floor_and_weights():
    """Rows without edges give zeros; a zero dot is clamped to the floor;
    the dot is unweighted and only the second half carries the scalars;
    the scalar pass is linear in the factor pass's second half."""
    es = torch.tensor([[1.0, 0.0], [0.5, 0.5], [2.0, 1.0]])
    eo = torch.tensor([[0.0, 3.0], [1.0, 1.0]])
    so = torch.tensor([10.0, 0.5])
    row_ptr = torch.tensor([0, 2, 2, 3])
    other = torch.tensor([0, 1, 1], dtype=torch.int32)
    x = torch.tensor([4.0, 2.0, 6.0])
    rec = torch.cat([eo, so[:, None]], dim=1)  # [e | s]
    out = ext_edge.ext_factor_tail_plain(es, rec, row_ptr, other, x)
    # row 0: edge to o=0 has dot max(0, floor): alloc = x/floor * 0 = 0;
    # edge to o=1: dot 1, alloc = 2 * [1, 0]; weighted 10*[0,3] + .5*[1,1].
    torch.testing.assert_close(out[0], torch.tensor([2.0, 0.0, 0.5, 30.5]))
    torch.testing.assert_close(out[1], torch.zeros(4))
    torch.testing.assert_close(out[2], torch.tensor([4.0, 2.0, 0.5, 0.5]))
    es_new = torch.tensor([[1.0, 2.0], [3.0, 4.0], [0.5, 0.25]])
    sdot = ext_edge.ext_scalar_tail_plain(es_new, rec, row_ptr, other)
    torch.testing.assert_close(sdot, torch.tensor([61.5, 0.0, 0.375]))
    torch.testing.assert_close(sdot, torch.sum(es_new * out[:, 2:], dim=1))


def test_head_requires_a_reordered_layout(small_ratings):
    u, i, x = small_ratings
    tb = t_build_blocked(u, i, x + 1.0, reorder=True, head=(16, 24), head_r0=4,
                         device="cpu")
    flat_p = t_build_blocked(u, i, x + 1.0, reorder=False, device="cpu").by_user
    th, be, _, _, _, psi = (torch.from_numpy(t) for t in _tables(np.float32))
    with pytest.raises(ValueError, match="reordered"):
        ext_edge.ext_factor_stats(th, be, psi, flat_p, head=tb.head)
    with pytest.raises(ValueError, match="reordered"):
        ext_edge.ext_scalar_stats(th, be, psi, flat_p, head=tb.head)
    # Without a head an unreordered layout is fine.
    sa, sw = ext_edge.ext_factor_stats(th, be, psi, flat_p)
    assert sa.shape == sw.shape == (120, 6)
