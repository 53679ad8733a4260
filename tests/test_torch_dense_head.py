"""Port dense-head statistics (kernel K2's plain version on the CPU)
against the JAX package's fused Pallas kernel in interpret mode, on the
same tier, at the reference's engine gate (5e-4 / 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.ops import dense_head as jdh
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.ops import dense_head as tdh

torch.set_num_threads(1)


def _case(small_ratings, kind):
    """(u, i, x) for: integer ratings (x_lo None, m bf16), fractional
    ratings (x_lo present) and a cell with multiplicity > 256 (m f32; its
    rating sum is past bf16's exact integers, so x_lo is present too)."""
    u, i, x = small_ratings
    if kind == "integer":
        return u, i, x + 1.0
    if kind == "fractional":
        return u, i, x + 1.0 + 0.013 * np.arange(len(x)) % 0.7
    uu = np.concatenate([u, np.full(300, u[0])])
    ii = np.concatenate([i, np.full(300, i[0])])
    return uu, ii, np.concatenate([x, np.full(300, 3.0)]) + 1.0


@pytest.mark.parametrize("kind", ["integer", "fractional", "m_f32"])
@pytest.mark.parametrize("head", [(16, 24), [(0, 8, 40), (8, 24, 12)]],
                         ids=["one_tier", "staircase"])
def test_head_stats_match_jax(small_ratings, kind, head):
    u, i, x = _case(small_ratings, kind)
    jb = j_build_blocked(u, i, x, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=head, head_r0=4)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True,
                         head=head, head_r0=4, device="cpu")
    t0 = tb.head[0]
    assert (t0.x_lo is not None) == (kind != "integer")
    assert (t0.m.dtype == torch.float32) == (kind == "m_f32")
    rng = np.random.default_rng(3)
    K = 7
    for jh, th in zip(jb.head, tb.head):
        theta = rng.gamma(1.0, 1.0, size=(th.hu, K)).astype(np.float32)
        beta = np.zeros((th.hip, K), np.float32)
        beta[: th.hi] = rng.gamma(1.0, 1.0, size=(th.hi, K))
        for j_fn, t_fn in ((jdh.poisson_head_stats, tdh.poisson_head_stats),
                           (jdh.poisson_head_stats_t, tdh.poisson_head_stats_t)):
            ref = j_fn(jnp.asarray(theta), jnp.asarray(beta), jh, 1e-10,
                       "high", True)
            got = t_fn(torch.from_numpy(theta), torch.from_numpy(beta), th, 1e-10)
            for g, r in zip(got, ref):
                assert g.shape == r.shape
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4,
                                           atol=1e-5, err_msg=t_fn.__name__)


@pytest.mark.parametrize("item_side", [False, True], ids=["user", "item"])
def test_plain_row_chunks_agree(small_ratings, item_side):
    u, i, x = _case(small_ratings, "fractional")
    h = t_build_blocked(u, i, x, reorder=True, head=(40, 60), head_r0=4, device="cpu").head[0]
    rng = np.random.default_rng(8)
    theta = torch.from_numpy(rng.gamma(1.0, 1.0, size=(40, 5)))
    beta = torch.from_numpy(rng.gamma(1.0, 1.0, size=(h.hip, 5)))
    kw = dict(rate_floor=1e-10, item_side=item_side)
    whole = tdh.fused_alloc_tier_plain(theta, beta, h.x_hi, h.m, h.x_lo, **kw)
    chunked = tdh.fused_alloc_tier_plain(theta, beta, h.x_hi, h.m, h.x_lo,
                                         row_chunk=7, **kw)
    assert whole.dtype == torch.float64
    torch.testing.assert_close(chunked, whole, rtol=1e-12, atol=0)


def test_head_wrapper_on_cpu_is_the_plain_version(small_ratings):
    u, i, x = _case(small_ratings, "integer")
    h = t_build_blocked(u, i, x, reorder=True, head=(16, 24), head_r0=4, device="cpu").head[0]
    theta = torch.rand(16, 4, generator=torch.Generator().manual_seed(0))
    beta = torch.rand(h.hip, 4, generator=torch.Generator().manual_seed(1))
    before = tdh.HEAD_LAUNCHES.count
    got = tdh.fused_alloc_tier(theta, beta, h.x_hi, h.m, rate_floor=1e-10)
    ref = tdh.fused_alloc_tier_plain(theta, beta, h.x_hi, h.m, rate_floor=1e-10)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert tdh.HEAD_LAUNCHES.count == before


@pytest.mark.parametrize("rows,hip,item_side", [
    (3072, 59392, False), (3072, 59392, True), (112640, 1024, False),
    (112640, 1024, True), (8, 512, False), (8, 512, True)])
def test_plan_splits_leaves_no_split_empty(rows, hip, item_side):
    splits = tdh.plan_splits(rows, hip, item_side, n_sm=132)
    if item_side:
        serial = -(-rows // tdh.ITEM_ROW_BATCH)
    else:
        serial = hip // tdh.USER_COLS
    per = -(-serial // splits)
    assert 1 <= splits <= serial
    assert (splits - 1) * per < serial  # the last split has work
