"""Port ``poisson_edge_stats`` (CSR tail + dense head tiers, kernel plain
versions on the CPU) against the JAX package: the blocked Pallas pass in
interpret mode at the reference's own engine gate (5e-4 / 1e-5), and in
float64 against flat segment sums at 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.ops.pallas.cavi_edge import poisson_edge_stats as j_edge_stats
from pmf_tpu.ops.segment import edge_dot, gather_rows, sorted_segment_sum
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.ops import cavi_edge

torch.set_num_threads(1)

HEADS = [None, (16, 24), [(0, 8, 40), (8, 24, 12)]]
HEAD_IDS = ["tail_only", "one_tier", "staircase"]


def _tables(n_users, n_items, K, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.gamma(1.0, 1.0, size=(n_users, K)).astype(dtype),
            rng.gamma(1.0, 1.0, size=(n_items, K)).astype(dtype))


def _flat_stats(e_self, e_other, self_ids, other_ids, x, n_self, floor=1e-10):
    g_self = gather_rows(e_self, self_ids)
    g_other = gather_rows(e_other, other_ids)
    rate = jnp.maximum(edge_dot(g_self, g_other), floor)
    alloc = (x / rate)[:, None] * g_self * g_other
    return (sorted_segment_sum(alloc, self_ids, n_self),
            sorted_segment_sum(g_other, self_ids, n_self))


@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_edge_stats_match_jax_interpret(small_ratings, head):
    u, i, x = small_ratings
    x = x + 1.0
    e_theta, e_beta = _tables(120, 80, 6, np.float32)
    jb = j_build_blocked(u, i, x, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=head, head_r0=4)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True,
                         head=head, head_r0=4, device="cpu")
    for side, es, eo, jp, tp in (("user", e_theta, e_beta, jb.by_user, tb.by_user),
                                 ("item", e_beta, e_theta, jb.by_item, tb.by_item)):
        ref = j_edge_stats(jnp.asarray(es), jnp.asarray(eo), jp, interpret=True,
                           precision="high", head=jb.head, head_side=side)
        got = cavi_edge.poisson_edge_stats(torch.from_numpy(es), torch.from_numpy(eo),
                                           tp, head=tb.head, head_side=side)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4,
                                       atol=1e-5, err_msg=side)


@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
def test_edge_stats_float64_match_flat(small_ratings, head):
    u, i, x = small_ratings
    x = x + 1.0  # integer ratings: the head planes hold X exactly
    e_theta, e_beta = _tables(120, 80, 6, np.float64, seed=1)
    flat = j_build_ratings(u, i, x, n_users=120, n_items=80, dtype=np.float64)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, dtype=np.float64,
                         reorder=True, head=head, head_r0=4, device="cpu")
    cases = (
        ("user", e_theta, e_beta, flat.u_by_u, flat.i_by_u, flat.x_by_u, 120, tb.by_user),
        ("item", e_beta, e_theta, flat.i_by_i, flat.u_by_i, flat.x_by_i, 80, tb.by_item),
    )
    for side, es, eo, sids, oids, xs, n_self, tp in cases:
        ref = _flat_stats(jnp.asarray(es), jnp.asarray(eo), sids, oids, xs, n_self)
        got = cavi_edge.poisson_edge_stats(torch.from_numpy(es), torch.from_numpy(eo),
                                           tp, head=tb.head, head_side=side)
        for g, r in zip(got, ref):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9,
                                       err_msg=side)


def test_tail_wrapper_on_cpu_is_the_plain_version(small_ratings):
    u, i, x = small_ratings
    tb = t_build_blocked(u, i, x + 1.0, reorder=True, device="cpu")
    es, eo = (torch.from_numpy(t) for t in _tables(120, 80, 5, np.float32, seed=2))
    p = tb.by_user
    before = cavi_edge.TAIL_LAUNCHES.count
    got = cavi_edge.tail_edge_stats(es, eo, p.row_ptr, p.other, p.x)
    ref = cavi_edge.tail_edge_stats_plain(es, eo, p.row_ptr, p.other, p.x)
    assert got.shape == (120, 10)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert cavi_edge.TAIL_LAUNCHES.count == before  # no kernel launched


def test_tail_plain_zero_rows_and_floor():
    """Rows without edges give zeros; a zero rate is clamped to the floor."""
    es = torch.tensor([[1.0, 0.0], [0.5, 0.5], [2.0, 1.0]])
    eo = torch.tensor([[0.0, 3.0], [1.0, 1.0]])
    row_ptr = torch.tensor([0, 2, 2, 3])
    other = torch.tensor([0, 1, 1], dtype=torch.int32)
    x = torch.tensor([4.0, 2.0, 6.0])
    out = cavi_edge.tail_edge_stats_plain(es, eo, row_ptr, other, x)
    # row 0: edge to o=0 has rate max(0, floor): alloc = x/floor * 0 = 0.
    torch.testing.assert_close(out[0], torch.tensor([2.0, 0.0, 1.0, 4.0]))
    torch.testing.assert_close(out[1], torch.zeros(4))
    torch.testing.assert_close(out[2], torch.tensor([4.0, 2.0, 1.0, 1.0]))
