"""Port ``poisson_edge_stats`` (CSR tail + dense head tiers, kernel plain
versions on the CPU) against the JAX package: the blocked Pallas pass in
interpret mode at the reference's own engine gate (5e-4 / 1e-5), and in
float64 against flat segment sums at 1e-9.  K1's mode "raw" against the
same Pallas kernel with ``mode="raw"`` and against its own linear identity."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.ops.pallas import cavi_edge as j_cavi_edge
from pmf_tpu.ops.pallas.cavi_edge import poisson_edge_stats as j_edge_stats
from pmf_tpu.ops.pallas.segmented import run_segmented
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


def _raw_passes(small_ratings, K, dtype, seed):
    """(side, JAX pass, port pass, new-space self table, other table)."""
    u, i, x = small_ratings
    e_theta, e_beta = _tables(120, 80, K, dtype, seed=seed)
    jb = j_build_blocked(u, i, x + 1.0, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True)
    tb = t_build_blocked(u, i, x + 1.0, n_users=120, n_items=80, dtype=dtype,
                         reorder=True, device="cpu")
    for side, es, eo, jp, tp in (("user", e_theta, e_beta, jb.by_user, tb.by_user),
                                 ("item", e_beta, e_theta, jb.by_item, tb.by_item)):
        yield (side, jp, tp, es[tp.self_old_of_new.numpy()],
               eo[tp.other_old_of_new.numpy()])


@pytest.mark.parametrize("K", [6, 20])
def test_raw_mode_matches_jax_kernel_interpret(small_ratings, K):
    """The reference kernel with mode="raw" (f32 HIGHEST dots), driven over
    the pass's segments as the extended-Poisson passes drive theirs."""
    for side, jp, tp, es, eo in _raw_passes(small_ratings, K, np.float32, seed=3):
        kernel = functools.partial(
            j_cavi_edge._kernel, bs_self=jp.bs_self, bs_other=jp.bs_other,
            chunk_size=jp.chunk_size, rate_floor=1e-10, k=K, parts=1, highest=True,
            group=jp.group, mode="raw")
        pad = lambda t, n: jnp.pad(jnp.asarray(t), ((0, n - t.shape[0]), (0, 0)))  # noqa: E731
        ref = run_segmented(kernel, jp, pad(es, jp.n_self_blocks * jp.bs_self),
                            pad(eo, jp.n_other_blocks * jp.bs_other), 2 * K,
                            interpret=True)
        got = cavi_edge.tail_edge_stats(torch.from_numpy(es), torch.from_numpy(eo),
                                        tp.row_ptr, tp.other, None, mode="raw")
        assert got.shape == (tp.n_self, 2 * K) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=1e-5,
                                   err_msg=side)


def test_raw_mode_is_its_own_linear_identity(small_ratings):
    """sum_e e_s * e_o = e_s * sum_e e_o: the first half of "raw" is the
    self row times its second half, which is also mode "cavi"'s."""
    for side, _, tp, es, eo in _raw_passes(small_ratings, 5, np.float64, seed=4):
        es, eo = torch.from_numpy(es), torch.from_numpy(eo)
        raw = cavi_edge.tail_edge_stats(es, eo, tp.row_ptr, tp.other, None, mode="raw")
        cavi = cavi_edge.tail_edge_stats(es, eo, tp.row_ptr, tp.other, tp.x)
        assert raw.dtype == torch.float64
        torch.testing.assert_close(raw[:, :5], es * raw[:, 5:], rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(raw[:, 5:], cavi[:, 5:], rtol=0, atol=0)
        # With x present the result is the same: "raw" reads no rating.
        with_x = cavi_edge.tail_edge_stats_plain(es, eo, tp.row_ptr, tp.other, tp.x,
                                                 mode="raw")
        torch.testing.assert_close(with_x, raw, rtol=0, atol=0)


def test_raw_mode_by_hand_and_unknown_mode():
    es = torch.tensor([[1.0, 2.0], [0.5, 0.5], [2.0, 1.0]])
    eo = torch.tensor([[0.0, 3.0], [1.0, 1.0]])
    row_ptr = torch.tensor([0, 2, 2, 3])
    other = torch.tensor([0, 1, 1], dtype=torch.int32)
    before = (cavi_edge.TAIL_LAUNCHES.count, cavi_edge.TAIL_RAW_LAUNCHES.count)
    out = cavi_edge.tail_edge_stats(es, eo, row_ptr, other, None, mode="raw")
    torch.testing.assert_close(out, torch.tensor([[1.0, 8.0, 1.0, 4.0],
                                                  [0.0, 0.0, 0.0, 0.0],
                                                  [2.0, 1.0, 1.0, 1.0]]))
    assert before == (cavi_edge.TAIL_LAUNCHES.count, cavi_edge.TAIL_RAW_LAUNCHES.count)
    for fn in (cavi_edge.tail_edge_stats, cavi_edge.tail_edge_stats_plain):
        with pytest.raises(ValueError, match="unknown mode"):
            fn(es, eo, row_ptr, other, None, mode="rate")
