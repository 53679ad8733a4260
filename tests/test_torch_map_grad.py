"""Port ``ops.map_grad`` (kernel K9's plain versions on the CPU) against
(a) the JAX package's Pallas kernel in interpret mode, driven as
``train_epoch_blocked`` drives it, on segments decoded from the JAX layout,
at the JAX tests' own gate (rtol 2e-4, atol 2e-5, f32); (b) autograd of the
port's ``batch_loss`` without prior terms, float64, 1e-10; (c) a case
computed by hand; (d) the per-epoch grouping by (step, self row) that the
kernel reads: every edge once, rows unique within a step, pieces tiling
each run, and each step equal to the COO plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.models import hpf_map as j_map
from pmf_tpu.ops.pallas.map_grad import make_map_grad_call
from pmf_tpu_torch.models import hpf_map as t_map
from pmf_tpu_torch.ops import map_grad

torch.set_num_threads(1)

FLOOR = t_map.LAMBDA_FLOOR
RTOL, ATOL = 2e-4, 2e-5  # tests/test_hpf_map_blocked.py's gate


def map_data(n_users=600, n_items=200, nnz=11000, seed=13):
    """Unique (u, i) pairs with +1-shifted integer ratings."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz)
    i = rng.integers(0, n_items, nnz)
    _, first = np.unique(u * n_items + i, return_index=True)
    u, i = u[first], i[first]
    x = rng.integers(1, 6, len(u)).astype(np.float64) + 1.0
    return u, i, x, n_users, n_items


def decode_segments(lay):
    """The JAX layout's segments as (u_new, i_new, x) arrays of their real
    slots: a slot is real where its packed self id is inside the block."""
    C = lay.chunk_size
    segs = []
    for s in range(lay.n_segments):
        loc = np.asarray(lay.loc[s])
        s_loc, o_loc = loc >> 16, loc & 0xFFFF
        real = s_loc < lay.bs_self
        sb = np.repeat(np.asarray(lay.sb[s]), C)
        ob = np.repeat(np.asarray(lay.ob[s]), C)
        segs.append(((sb * lay.bs_self + s_loc)[real].astype(np.int64),
                     (ob * lay.bs_other + o_loc)[real].astype(np.int64),
                     np.asarray(lay.x[s])[real]))
    return segs


def jax_perms(lay):
    return tuple(np.asarray(p) for p in (lay.u_old_of_new, lay.u_new_of_old,
                                         lay.i_old_of_new, lay.i_new_of_old))


def port_layout(lay, mix, dtype=np.float32):
    """The port's layout over exactly the JAX layout's segments."""
    return t_map.MapBlockedLayout.from_segments(
        decode_segments(lay), jax_perms(lay), lay.n_users, lay.n_items, mix,
        device="cpu", dtype=dtype)


def jax_step_accumulators(u_sp, i_sp, lay, seg_ids):
    """One step's accumulators from the Pallas kernel (f32 HIGHEST dots,
    interpret mode), assembled as ``train_epoch_blocked`` assembles them."""
    K = u_sp.shape[1] - 1
    SEG, C, G = lay.seg_chunks, lay.chunk_size, lay.group
    n_self_pad = lay.n_self_blocks * lay.bs_self
    n_other_pad = lay.n_other_blocks * lay.bs_other
    u_pad = jnp.pad(jnp.asarray(u_sp), ((0, n_self_pad - u_sp.shape[0]), (0, 0)))
    i_pad = jnp.pad(jnp.asarray(i_sp), ((0, n_other_pad - i_sp.shape[0]), (0, 0)))
    call = make_map_grad_call(
        bs_self=lay.bs_self, bs_other=lay.bs_other, chunk_size=C, KT=K + 1, K=K,
        parts=1, highest=True, group=G, seg_chunks=SEG, out_rows=lay.out_rows,
        lam_floor=FLOOR, interpret=True)
    acc_u = np.zeros((n_self_pad + lay.out_rows, K + 2), np.float32)
    acc_i = np.zeros((lay.n_other_blocks, lay.bs_other, K + 1), np.float32)
    for s in seg_ids:
        self_g, other_g = call(lay.sb[s], lay.ob[s], lay.loc[s].reshape(SEG * C, 1),
                               lay.x[s].reshape(SEG * C, 1), u_pad, *([i_pad] * G))
        self_g = np.array(self_g)
        self_g[int(lay.seg_nrows[s]):] = 0.0
        r0 = int(lay.seg_row0[s])
        acc_u[r0 : r0 + lay.out_rows] += self_g
        np.add.at(acc_i, np.asarray(lay.ob[s]),
                  np.asarray(other_g).reshape(SEG, lay.bs_other, K + 1))
    return (acc_u[: lay.n_users],
            acc_i.reshape(n_other_pad, K + 1)[: lay.n_items])


def softplus_tables(n_users, n_items, K, dtype, seed=0):
    rng = np.random.default_rng(seed)
    sp = lambda t: np.logaddexp(t, 0.0).astype(dtype)  # noqa: E731
    return (sp(0.5 * rng.standard_normal((n_users, K + 1))),
            sp(0.5 * rng.standard_normal((n_items, K + 1))))


@pytest.fixture(scope="module")
def jax_layout():
    u, i, x, n_users, n_items = map_data()
    lay = j_map.build_map_layout(u, i, x, n_users, n_items, batch_size=4 * 2048,
                                 dtype=np.float32, mix=4)
    assert lay.n_segments == 8 and int(lay.seg_nrows[-1]) == 0  # 6 real + 2 dummy
    return (u, i, x), lay


def test_decoded_segments_hold_every_edge_once(jax_layout):
    (u, i, x), lay = jax_layout
    segs = decode_segments(lay)
    assert [len(s[0]) for s in segs][-2:] == [0, 0]
    nu = np.concatenate([s[0] for s in segs])
    ni = np.concatenate([s[1] for s in segs])
    xs = np.concatenate([s[2] for s in segs])
    u_o2n, i_o2n = np.asarray(lay.u_old_of_new), np.asarray(lay.i_old_of_new)
    got = sorted(zip(u_o2n[nu].tolist(), i_o2n[ni].tolist(), xs.tolist()))
    assert got == sorted(zip(u.tolist(), i.tolist(), x.tolist()))


@pytest.mark.parametrize("seg_ids", [(0,), (5,), (0, 3, 5), (1, 2, 4, 7), (6, 7)],
                         ids=["first", "last_real", "three", "with_dummy", "dummies"])
def test_step_matches_jax_kernel(jax_layout, seg_ids):
    _, lay = jax_layout
    u_sp, i_sp = softplus_tables(lay.n_users, lay.n_items, 6, np.float32)
    ref_u, ref_i = jax_step_accumulators(u_sp, i_sp, lay, seg_ids)
    t_lay = port_layout(lay, mix=4)
    got_u, got_i = map_grad.map_grad_step(torch.from_numpy(u_sp), torch.from_numpy(i_sp),
                                          t_lay, seg_ids, FLOOR)
    assert got_u.dtype == torch.float32 and got_u.shape == (lay.n_users, 8)
    assert got_i.shape == (lay.n_items, 7)
    np.testing.assert_allclose(got_u.numpy(), ref_u, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_i.numpy(), ref_i, rtol=RTOL, atol=ATOL)
    # The count columns are exact.
    np.testing.assert_array_equal(got_u[:, 6].numpy(), ref_u[:, 6])
    np.testing.assert_array_equal(got_i[:, 6].numpy(), ref_i[:, 6])


@pytest.mark.parametrize("seg_ids", [(0,), (0, 3, 5), (1, 2, 4, 7)],
                         ids=["one", "three", "with_dummy"])
def test_plain_coo_matches_jax_kernel(jax_layout, seg_ids):
    _, lay = jax_layout
    u_sp, i_sp = softplus_tables(lay.n_users, lay.n_items, 6, np.float32, seed=1)
    ref_u, ref_i = jax_step_accumulators(u_sp, i_sp, lay, seg_ids)
    segs = decode_segments(lay)
    nu, ni, xs = (torch.from_numpy(np.concatenate([segs[s][c] for s in seg_ids]))
                  for c in range(3))
    got_u, got_i = map_grad.map_grad_plain(torch.from_numpy(u_sp), torch.from_numpy(i_sp),
                                           nu, ni, xs, FLOOR)
    np.testing.assert_allclose(got_u.numpy(), ref_u, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_i.numpy(), ref_i, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mix", [1, 3, 8])
def test_step_equals_plain_coo_float64(mix):
    """The grouped path of a step equals the COO plain version on the same
    edges, on the port's own layout."""
    u, i, x, n_users, n_items = map_data(nnz=4000, seed=3)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items, batch_size=mix * 300,
                                 mix=mix, dtype=np.float64, device="cpu")
    u_sp, i_sp = (torch.from_numpy(t) for t in
                  softplus_tables(n_users, n_items, 5, np.float64, seed=2))
    seg_ids = list(range(mix))
    got_u, got_i = map_grad.map_grad_step(u_sp, i_sp, lay, seg_ids, FLOOR)
    nu, ni, xs = (torch.cat(c) for c in zip(*(lay.segment(s) for s in seg_ids)))
    ref_u, ref_i = map_grad.map_grad_plain(u_sp, i_sp, nu, ni, xs, FLOOR)
    assert got_u.dtype == torch.float64
    torch.testing.assert_close(got_u, ref_u, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_i, ref_i, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("piece", [map_grad.PIECE, 3])
@pytest.mark.parametrize("mix", [1, 3, 8])
def test_epoch_grouping_holds_every_edge_once_in_pieces(mix, piece):
    """One epoch's grouping, each direction: every edge of the layout once,
    each step's rows unique, a row's run tiled by its pieces (all of
    ``piece`` edges but the last), and each step's pieces holding that
    step's edges."""
    u, i, x, n_users, n_items = map_data(nnz=4000, seed=3)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items, batch_size=mix * 300,
                                 mix=mix, device="cpu")
    order = np.random.default_rng(mix).permutation(lay.n_segments)
    edges = np.stack([lay.u.numpy(), lay.i.numpy(), lay.x.numpy()], axis=1)
    for g, self_col in zip(lay.group(order, mix, 4, piece), (0, 1)):
        ptr = g.piece_ptr.numpy()
        lens = np.diff(ptr)
        assert ptr[0] == 0 and ptr[-1] == lay.nnz and (lens >= 1).all()
        assert (lens <= piece).all()
        rows = np.repeat(g.piece_row.numpy(), lens)
        got = np.stack([rows, g.other.numpy(), g.x.numpy()], axis=1)
        want = edges[:, [self_col, 1 - self_col, 2]]
        np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                      want[np.lexsort(want.T[::-1])])
        first, count = g.piece_first.numpy(), g.piece_count.numpy()
        step_off = g.step_off.numpy()
        assert step_off[0] == 0 and step_off[-1] == g.n_pieces
        for s in range(g.n_steps):
            p0, p1 = step_off[s], step_off[s + 1]
            assert lens[p0:p1].sum() == g.step_edges[s]
            starts = np.flatnonzero(first[p0:p1] == np.arange(p0, p1)) + p0
            assert len(np.unique(g.piece_row.numpy()[starts])) == len(starts)
            assert g.max_step_pieces >= p1 - p0
            for f in starts:
                run = slice(f, f + count[f])
                assert (first[run] == f).all() and (count[run] == count[f]).all()
                assert (g.piece_row.numpy()[run] == g.piece_row.numpy()[f]).all()
                assert (lens[run][:-1] == piece).all()
        assert g.n_runs == int((first == np.arange(g.n_pieces)).sum())


@pytest.mark.parametrize("mix", [1, 3, 8])
def test_every_step_of_an_epoch_equals_plain_coo_float64(mix):
    """Each step of an epoch grouping with runs cut into pieces of 3 edges
    (so that most rows span several pieces) equals the COO plain version
    of the step's segments."""
    u, i, x, n_users, n_items = map_data(nnz=4000, seed=4)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items, batch_size=mix * 300,
                                 mix=mix, dtype=np.float64, device="cpu")
    u_sp, i_sp = (torch.from_numpy(t) for t in
                  softplus_tables(n_users, n_items, 5, np.float64, seed=5))
    order = np.random.default_rng(7).permutation(lay.n_segments)
    groups = lay.group(order, mix, 5, 3)
    for step in range(groups[0].n_steps):
        got_u, got_i = map_grad.map_grad_grouped(u_sp, i_sp, groups, step, FLOOR)
        seg_ids = order[step * mix : (step + 1) * mix]
        nu, ni, xs = (torch.cat(c) for c in zip(*(lay.segment(s) for s in seg_ids)))
        ref_u, ref_i = map_grad.map_grad_plain(u_sp, i_sp, nu, ni, xs, FLOOR)
        torch.testing.assert_close(got_u, ref_u, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_i, ref_i, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("K", [1, 7, 32])
def test_accumulators_are_autograd_of_the_nll(K):
    """With zero prior scales ``batch_loss`` is the NLL alone, so its
    gradient with respect to the SOFTPLUS'D rows is the w-weighted sums,
    and the chain rule through softplus is a multiply by sigmoid."""
    u, i, x, n_users, n_items = map_data(n_users=40, n_items=30, nnz=500, seed=5)
    rng = np.random.default_rng(K)
    p_user = torch.from_numpy(0.5 * rng.standard_normal((n_users, K + 1)))
    p_item = torch.from_numpy(0.5 * rng.standard_normal((n_items, K + 1)))
    ut, it, xt = torch.from_numpy(u), torch.from_numpy(i), torch.from_numpy(x)
    leaves = {"user": p_user.clone().requires_grad_(True),
              "item": p_item.clone().requires_grad_(True)}
    scal = (0.3, 1.0, 1.0, 0.3, 1.0, 1.0)
    loss = t_map.batch_loss(leaves, ut, it, xt, torch.ones(len(u), dtype=torch.bool),
                            torch.zeros(n_users, dtype=torch.float64),
                            torch.zeros(n_items, dtype=torch.float64), scal)
    g_user, g_item = torch.autograd.grad(loss, [leaves["user"], leaves["item"]])
    acc_u, acc_i = map_grad.map_grad_plain(t_map.softplus(p_user), t_map.softplus(p_item),
                                           ut, it, xt, FLOOR)
    torch.testing.assert_close(acc_u[:, :K] * torch.sigmoid(p_user[:, :K]),
                               g_user[:, :K], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(acc_i[:, :K] * torch.sigmoid(p_item[:, :K]),
                               g_item[:, :K], rtol=1e-10, atol=1e-10)
    assert float(g_user[:, K].abs().max()) == 0.0  # xi enters the priors only
    torch.testing.assert_close(acc_u[:, K + 1].sum(), loss.detach(),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(acc_u[:, K].numpy(), np.bincount(u, minlength=n_users))
    np.testing.assert_array_equal(acc_i[:, K].numpy(), np.bincount(i, minlength=n_items))


def _hand_layout():
    """Two users, two items, K = 1.  Segment 0: edges (0, 0, x=2) and
    (1, 1, x=3); segment 1: empty; segment 2: edge (0, 1, x=1), so user 0
    and item 1 are shared by two segments of one step.  Edge (1, 1) has
    <theta, beta> = 1e-4 * 1e-3 < floor: clamped."""
    segs = [(np.array([0, 1]), np.array([0, 1]), np.array([2.0, 3.0])),
            (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)),
            (np.array([0]), np.array([1]), np.array([1.0]))]
    ident = (np.arange(2),) * 4
    lay = t_map.MapBlockedLayout.from_segments(segs, ident, 2, 2, 3, device="cpu",
                                               dtype=np.float64)
    u_sp = torch.tensor([[2.0, 9.0], [1e-4, 9.0]], dtype=torch.float64)
    i_sp = torch.tensor([[0.5, 7.0], [1e-3, 7.0]], dtype=torch.float64)
    return lay, u_sp, i_sp


def test_hand_computed_step():
    lay, u_sp, i_sp = _hand_layout()
    assert lay.n_segments == 3 and lay.n_real_segments == 2
    assert lay.segment(1)[0].numel() == 0  # the empty segment
    acc_u, acc_i = map_grad.map_grad_step(u_sp, i_sp, lay, [0, 1, 2], FLOOR)
    log = np.log
    # edge (0,0): lam = 1, w = 1 - 2/1 = -1, nll = 1 - 2 log 1 = 1
    # edge (0,1): lam = 2e-3, w = 1 - 1/2e-3 = -499, nll = 2e-3 - log 2e-3
    # edge (1,1): dot 1e-7 < floor: lam = 1e-6, w = 0, nll = 1e-6 - 3 log 1e-6
    want_u = np.array([[-1 * 0.5 + -499 * 1e-3, 2.0, 1.0 + 2e-3 - log(2e-3)],
                       [0.0, 1.0, 1e-6 - 3 * log(1e-6)]])
    want_i = np.array([[-1 * 2.0, 1.0],
                       [-499 * 2.0 + 0.0 * 1e-4, 2.0]])
    np.testing.assert_allclose(acc_u.numpy(), want_u, rtol=1e-12)
    np.testing.assert_allclose(acc_i.numpy(), want_i, rtol=1e-12)


def test_rows_wrapper_adds_into_out_and_launches_nothing_on_cpu():
    """The step wrapper STORES the rows its step holds and leaves the
    others as they were; on the CPU it launches nothing."""
    lay, u_sp, i_sp = _hand_layout()
    by_user, by_item = lay.group([2, 0, 1], 1, 1)  # three steps of one segment
    out = torch.full((2, 3), 10.0, dtype=torch.float64)
    before = map_grad.MAP_GRAD_LAUNCHES.count
    map_grad.map_grad_pieces(u_sp, i_sp, by_user, 0, FLOOR, True, out)  # segment 2
    ref = torch.full((2, 3), 10.0, dtype=torch.float64)
    map_grad.map_grad_pieces_plain(u_sp, i_sp, by_user, 0, FLOOR, True, ref)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert out[1].tolist() == [10.0, 10.0, 10.0]  # row 1 is not in segment 2
    assert out[0, 1].item() == 1.0  # stored, not added
    # The empty segment's step stores nothing, in either direction.
    map_grad.map_grad_pieces(i_sp, u_sp, by_item, 2, FLOOR, False, out[:, :2])
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert by_user.step_edges.tolist() == [1, 2, 0]
    assert map_grad.MAP_GRAD_LAUNCHES.count == before


def test_last_table_column_is_ignored_by_the_dot():
    lay, u_sp, i_sp = _hand_layout()
    ref = map_grad.map_grad_step(u_sp, i_sp, lay, [0, 2], FLOOR)
    u2, i2 = u_sp.clone(), i_sp.clone()
    u2[:, -1] = -3.0
    i2[:, -1] = 123.0
    got = map_grad.map_grad_step(u2, i2, lay, [0, 2], FLOOR)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
