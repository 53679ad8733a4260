"""Port data layer against the JAX package: synthetic generators, the
dual-sorted COO, eval sets, the popularity perms, the head staircase and
the dense head cell planes must equal the reference arrays exactly."""

import numpy as np
import pytest
import torch

from pmf_tpu.data import blocked as jblocked
from pmf_tpu.data import synthetic as jsynth
from pmf_tpu.data.coo import build_eval_set as j_build_eval_set
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu_torch.data import blocked as tblocked
from pmf_tpu_torch.data import synthetic as tsynth
from pmf_tpu_torch.data.coo import build_eval_set as t_build_eval_set
from pmf_tpu_torch.data.coo import build_ratings as t_build_ratings

torch.set_num_threads(1)


def _np(t):
    """Tensor -> numpy, bf16 as its raw 16-bit pattern."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same(t, j, what):
    got, ref = _np(t), _jnp(j)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def test_synthetic_generators_match_jax():
    for got, ref in zip(tsynth.synth_ratings(120, 80, 1500, seed=7),
                        jsynth.synth_ratings(120, 80, 1500, seed=7)):
        np.testing.assert_array_equal(got, ref)
    for gs, rs in zip(tsynth.synth_splits(150, 90, 2500, seed=11),
                      jsynth.synth_splits(150, 90, 2500, seed=11)):
        for got, ref in zip(gs, rs):
            np.testing.assert_array_equal(got, ref)


def test_bench_zipf_generator_matches_bench():
    import bench

    for got, ref in zip(tsynth.synth(300, 200, 5000, seed=3),
                        bench.synth(300, 200, 5000, seed=3)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_ratings_matches_jax(small_ratings, dtype):
    u, i, x = small_ratings
    t = t_build_ratings(u, i, x, dtype=dtype, device="cpu")
    j = j_build_ratings(u, i, x, dtype=dtype)
    for f in ("u_by_u", "i_by_u", "x_by_u", "u_by_i", "i_by_i", "x_by_i",
              "user_counts", "item_counts"):
        _assert_same(getattr(t, f), getattr(j, f), f)
    for f in ("n_users", "n_items", "nnz", "nnz_padded"):
        assert getattr(t, f) == getattr(j, f), f


def test_build_eval_set_matches_jax(small_splits):
    _, (u, i, x), _ = small_splits
    # Ids past the model range exercise the ``valid`` mask.
    u = np.concatenate([u, [149, 400]])
    i = np.concatenate([i, [300, 3]])
    x = np.concatenate([x, [2.0, 5.0]])
    t = t_build_eval_set(u, i, x, 150, 90, device="cpu")
    j = j_build_eval_set(u, i, x, 150, 90)
    for f in ("u", "i", "x", "real", "valid", "class_id", "class_value"):
        _assert_same(getattr(t, f), getattr(j, f), f)
    for f in ("n_rows", "n_rows_padded", "n_classes"):
        assert getattr(t, f) == getattr(j, f), f


def _zipf(n_users=3000, n_items=2048, nnz=60_000, seed=2):
    return tsynth.synth(n_users, n_items, nnz, seed=seed)


@pytest.mark.parametrize("cell_bytes,r0", [(4, 32), (6, 16)])
def test_pick_tiers_match_jax(cell_bytes, r0):
    u, i, _ = _zipf()
    _, un = tblocked._count_perms(u, 3000)
    _, inn = tblocked._count_perms(i, 2048)
    nu, ni = un[u], inn[i]
    kw = dict(n_users=3000, n_items=2048, head_bytes=1_500_000 * cell_bytes,
              cell_bytes=cell_bytes, r0=r0, min_nnz=0, min_cover=0.01)
    got = tblocked._pick_tiers(nu, ni, **kw)
    ref = jblocked._pick_tiers(nu, ni, **kw)
    assert got == ref
    assert len(got) >= 2  # a real staircase, not a single block


def test_reorder_perms_match_jax():
    u, i, x = _zipf()
    head = [(0, 64, 1024), (64, 192, 256)]
    t = tblocked.build_blocked(u, i, x, reorder=True, head=head, head_r0=32, device="cpu")
    j = jblocked.build_blocked(u, i, x, block_users=64, block_items=64,
                               chunk_size=16, group=2, reorder=True, head=head,
                               head_r0=32)
    for d in ("by_user", "by_item"):
        for f in ("self_old_of_new", "other_old_of_new", "self_new_of_old"):
            np.testing.assert_array_equal(
                getattr(getattr(t, d), f).numpy(),
                np.asarray(getattr(getattr(j, d), f)), err_msg=f"{d}.{f}")
        assert getattr(t, d).nnz == getattr(j, d).nnz


def _with_duplicates(u, i, x, n_dup=200, seed=0):
    """Repeat some edges (duplicate (u, i) pairs) with fresh ratings."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(u), size=n_dup, replace=False)
    xd = rng.integers(1, 6, size=n_dup).astype(x.dtype)
    return (np.concatenate([u, u[pick]]), np.concatenate([i, i[pick]]),
            np.concatenate([x, xd]))


@pytest.mark.parametrize("head", [(16, 24), [(0, 8, 40), (8, 24, 12)]],
                         ids=["one_tier", "staircase"])
@pytest.mark.parametrize("shift", [1.0, 1.37], ids=["integer", "fractional"])
def test_head_planes_match_jax(small_ratings, head, shift):
    u, i, x = _with_duplicates(*small_ratings)
    x = x + shift
    t = tblocked.build_blocked(u, i, x, reorder=True, head=head, head_r0=4, device="cpu")
    j = jblocked.build_blocked(u, i, x, block_users=32, block_items=32,
                               chunk_size=16, group=2, reorder=True, head=head,
                               head_r0=4)
    assert len(t.head) == len(j.head)
    for th, jh in zip(t.head, j.head):
        for f in ("hu", "hi", "r0", "row_start", "hip"):
            assert getattr(th, f) == getattr(jh, f), f
        _assert_same(th.x_hi, jh.x_hi, "x_hi")
        _assert_same(th.m, jh.m, "m")
        assert (th.x_lo is None) == (jh.x_lo is None) == (shift == 1.0)
        if th.x_lo is not None:
            _assert_same(th.x_lo, jh.x_lo, "x_lo")


def test_head_m_plane_is_f32_past_256_duplicates(small_ratings):
    u, i, x = small_ratings
    # 300 copies of the busiest user's busiest-item edge: one cell with
    # multiplicity > 256, which bf16 cannot hold exactly.
    uu = np.concatenate([u, np.full(300, u[0])])
    ii = np.concatenate([i, np.full(300, i[0])])
    xx = np.concatenate([x, np.full(300, 2.0)]) + 1.0
    t = tblocked.build_blocked(uu, ii, xx, reorder=True, head=(120, 80), head_r0=4, device="cpu")
    j = jblocked.build_blocked(uu, ii, xx, block_users=32, block_items=32,
                               chunk_size=16, group=2, reorder=True,
                               head=(120, 80), head_r0=4)
    assert t.head[0].m.dtype == torch.float32
    _assert_same(t.head[0].m, j.head[0].m, "m")
    _assert_same(t.head[0].x_hi, j.head[0].x_hi, "x_hi")


def test_tail_csr_holds_the_non_head_edges(small_ratings):
    u, i, x = small_ratings
    b = tblocked.build_blocked(u, i, x + 1.0, reorder=True, head=(16, 24), head_r0=4, device="cpu")
    n_head = int(b.head[0].m.float().sum())
    for p in (b.by_user, b.by_item):
        assert p.row_ptr.dtype == torch.int64 and p.other.dtype == torch.int32
        assert int(p.row_ptr[0]) == 0 and int(p.row_ptr[-1]) == p.nnz
        assert bool(torch.all(p.row_ptr[1:] >= p.row_ptr[:-1]))
        assert p.nnz + n_head == len(u)
    # No tail edge falls inside the head corner (new space).
    rows = torch.repeat_interleave(torch.arange(b.by_user.n_self),
                                   b.by_user.row_ptr[1:] - b.by_user.row_ptr[:-1])
    in_head = (rows < 16) & (b.by_user.other < 24)
    assert not bool(torch.any(in_head))
