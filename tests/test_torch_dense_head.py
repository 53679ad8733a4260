"""Port dense-head statistics (kernel K2's plain version on the CPU)
against the JAX package's fused Pallas kernel in interpret mode, on the
same tier, at the reference's engine gate (5e-4 / 1e-5).  K2 itself runs
only on the card, so its arithmetic (bf16 planes rounded to nearest,
three-term products, float32 sums) is emulated here in plain tensor code
and held against the plain version in float64 and the JAX kernel, and its
launch plan is checked as the pure function it is."""

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


def _planes(t, truncate=False):
    """float32 -> (hi, lo) bf16 planes as float32: hi rounded to nearest, as
    the kernel splits, or truncated to the top 16 bits."""
    t = t.float()
    if truncate:
        hi = (t.contiguous().view(torch.int32) & -65536).view(torch.float32)
    else:
        hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _three_terms(a, b):
    """a @ b as the kernel issues it: hi*lo + lo*hi + hi*hi of bf16 planes
    (each product exact in float32), summed in float32."""
    (a_hi, a_lo), (b_hi, b_lo) = a, b
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulate_kernel(theta, beta, x_hi, m, x_lo, rate_floor, item_side,
                    truncate=False):
    """K2's arithmetic in plain float32 tensor code: every f32 operand two
    bf16 planes, every product three terms (a bf16 M is one exact plane),
    W split between the two products.  Returns (out, R).

    Each product here is one float32 matmul over the whole reduction axis.
    The length of the kernel's mma chains (one chain a tile, joined by float
    adds) is not emulated: ``test_short_mma_chains_beat_one_long_chain``
    pins why they are short, and ``chip_smoke.py::phase_k2`` holds the
    kernel itself on the real tiers, whose reduction axes are long enough
    to show a truncating accumulator."""
    th, be = _planes(theta, truncate), _planes(beta, truncate)
    R = _three_terms(th, (be[0].T, be[1].T))
    x = x_hi.float() + (0 if x_lo is None else x_lo.float())
    mf = m.float()
    W = torch.where(mf > 0, x * (1.0 / torch.clamp_min(R, rate_floor)), 0.0)
    w = _planes(W, truncate)
    mp = (mf, torch.zeros_like(mf)) if m.dtype == torch.bfloat16 else _planes(mf, truncate)
    if item_side:
        w, mp, other = (w[0].T, w[1].T), (mp[0].T, mp[1].T), th
    else:
        other = be
    return torch.cat([_three_terms(w, other), _three_terms(mp, other)], dim=1), R


def _tier(small_ratings, kind, K, seed):
    u, i, x = _case(small_ratings, kind)
    jb = j_build_blocked(u, i, x, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=(40, 60), head_r0=4)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True,
                         head=(40, 60), head_r0=4, device="cpu")
    h = tb.head[0]
    rng = np.random.default_rng(seed)
    theta = rng.gamma(0.3, 1.0, size=(h.hu, K)).astype(np.float32)
    beta = np.zeros((h.hip, K), np.float32)
    beta[: h.hi] = rng.gamma(0.3, 1.0, size=(h.hi, K))
    return jb.head[0], h, torch.from_numpy(theta), torch.from_numpy(beta)


KINDS = ["integer", "fractional", "m_f32"]
SIDES = pytest.mark.parametrize("item_side", [False, True], ids=["user", "item"])


@SIDES
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_arithmetic_matches_plain_float64(small_ratings, kind, item_side):
    """The card check's tolerance, 1e-4 relative per element, holds for the
    kernel's bf16-plane arithmetic against the plain version in float64."""
    _, h, theta, beta = _tier(small_ratings, kind, K=20, seed=11)
    assert (h.x_lo is not None) == (kind != "integer")
    assert (h.m.dtype == torch.float32) == (kind == "m_f32")
    got, _ = _emulate_kernel(theta, beta, h.x_hi, h.m, h.x_lo, 1e-10, item_side)
    ref = tdh.fused_alloc_tier_plain(theta.double(), beta.double(), h.x_hi, h.m,
                                     h.x_lo, rate_floor=1e-10, item_side=item_side)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    torch.testing.assert_close(got.double(), ref, rtol=1e-4, atol=0)


@SIDES
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_arithmetic_matches_jax(small_ratings, kind, item_side):
    """The same arithmetic against the JAX kernel in interpret mode, at the
    engine gate."""
    jh, h, theta, beta = _tier(small_ratings, kind, K=7, seed=12)
    out, _ = _emulate_kernel(theta, beta, h.x_hi, h.m, h.x_lo, 1e-10, item_side)
    j_fn = jdh.poisson_head_stats_t if item_side else jdh.poisson_head_stats
    ref = j_fn(jnp.asarray(theta.numpy()), jnp.asarray(beta.numpy()), jh, 1e-10,
               "high", True)
    got = ((beta if item_side else theta) * out[:, :7], out[:, 7:])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4, atol=1e-5)


def test_rounded_planes_beat_truncated_planes():
    """hi = bf16(t) rounded to nearest halves the lo plane's range against
    the truncated top 16 bits, so the three-term products lose less: the
    kernel rounds."""
    rng = np.random.default_rng(5)
    rows, hip, K = 256, 512, 20
    theta = torch.from_numpy(rng.gamma(0.3, 1.0, size=(rows, K)).astype(np.float32))
    beta = torch.from_numpy(rng.gamma(0.3, 1.0, size=(hip, K)).astype(np.float32))
    m = torch.from_numpy((rng.random((rows, hip)) < 0.5).astype(np.float32))
    x_hi = (m * torch.from_numpy(rng.integers(1, 6, size=(rows, hip)))).to(torch.bfloat16)
    m = m.to(torch.bfloat16)
    ref = tdh.fused_alloc_tier_plain(theta.double(), beta.double(), x_hi, m,
                                     rate_floor=1e-10)
    R_ref = theta.double() @ beta.double().T

    def worst(got, want):
        return float(((got.double() - want).abs() / want.abs().clamp_min(1e-300)).max())

    errs = {}
    for truncate in (False, True):
        out, R = _emulate_kernel(theta, beta, x_hi, m, None, 1e-10, False, truncate)
        errs[truncate] = (worst(R, R_ref), worst(out, ref))
    assert errs[False][0] < 5e-5 and errs[False][1] < 2e-5
    assert errs[True][0] > 1.5 * errs[False][0]
    assert errs[True][1] > 1.5 * errs[False][1]


def _chain_truncating(terms):
    """Sum ``terms`` (steps, chains) along axis 0 as a tensor-core chain
    does: a float32 accumulator whose every add is truncated toward zero."""
    acc = np.zeros(terms.shape[1], np.float32)
    for step in terms:
        exact = acc.astype(np.float64) + step
        near = exact.astype(np.float32)
        over = np.abs(near.astype(np.float64)) > np.abs(exact)
        acc = np.where(over, np.nextafter(near, np.float32(0)), near)
    return acc


def test_short_mma_chains_beat_one_long_chain():
    """Why the kernel starts a fresh mma chain every tile: the tensor core's
    float32 accumulator truncates, so one chain along a reduction axis of
    1400 steps of positive terms loses some 1e-5 of the sum, which leaves
    little of the 1e-4 tolerance, while chains of 6 steps joined by
    (rounding) float adds stay two orders of magnitude under it."""
    rng = np.random.default_rng(9)
    steps, per_tile = 1400, 6
    terms = rng.gamma(0.3, 1.0, size=(steps, 256)).astype(np.float32).astype(np.float64)
    want = terms.sum(axis=0)
    long_chain = _chain_truncating(terms)
    short = np.zeros(256, np.float32)
    for t0 in range(0, steps, per_tile):
        short = short + _chain_truncating(terms[t0 : t0 + per_tile])
    err_long = np.abs(long_chain - want) / want
    err_short = np.abs(short - want) / want
    assert err_long.max() > 1e-5
    assert err_short.max() < 1e-6
    assert np.all(long_chain <= want)  # truncation only ever loses


REAL_TIERS = [(3072, 59392), (9216, 14848), (36864, 4096), (112640, 1024)]
EDGE_SHAPES = [(8, 512), (8, 64), (70, 128), (3000, 960)]


@pytest.mark.parametrize("rows,hip,item_side", [
    (r, h, side) for r, h in REAL_TIERS + EDGE_SHAPES for side in (False, True)])
def test_plan_splits_leaves_no_split_empty(rows, hip, item_side):
    """The launch plan over the real tiers' shapes and small edge shapes:
    a ring of at least three stages inside one CTA's shared memory, the
    resident CTAs inside the SM's, no empty split, and a grid that fills
    132 SMs wherever the tier has that many tiles."""
    n_sm = 132
    for m_f32, has_lo in ((False, False), (False, True), (True, True)):
        for K in (1, 16, 20, 32):
            plan = tdh.plan_launch(rows, hip, K, item_side, m_f32, has_lo, n_sm)
            n_p, n_q = (hip, rows) if item_side else (rows, hip)
            parallel = -(-n_p // plan.p_tile)
            serial = -(-n_q // plan.q_tile)
            assert plan.p_tile == tdh.P_TILE == 16 * tdh.WARPS
            assert plan.q_tile == tdh.Q_TILE
            assert plan.depth == 8 * -(-K // 8) >= K
            assert plan.stages == tdh.STAGES >= 3
            assert plan.smem_bytes == plan.stages * tdh.stage_bytes(
                item_side, m_f32, has_lo, K)
            assert plan.smem_bytes <= 232_448
            assert 1 <= plan.ctas_per_sm <= tdh.MAX_CTAS_PER_SM
            assert plan.ctas_per_sm * (plan.smem_bytes + 1024) <= 233_472
            assert 1 <= plan.splits <= min(serial, tdh.MAX_SPLITS)
            assert plan.tiles_per_split == -(-serial // plan.splits)
            assert (plan.splits - 1) * plan.tiles_per_split < serial  # none empty
            assert plan.splits * plan.tiles_per_split >= serial  # none left out
            # Equal CTAs in whole waves: the grid may stop a few CTAs short
            # of the card where one more split would start another wave.
            if parallel * min(serial, tdh.MAX_SPLITS) >= n_sm:
                assert parallel * plan.splits >= 0.9 * n_sm


def test_stage_bytes_counts_every_plane():
    """One stage at K=20, user side: 64 x 32 cells of bf16 in rows padded by
    16 bytes per plane, a float32 M in rows padded by 32, and 32 rows of
    both Q planes at 48 bytes (three blocks of 8 factors; an even count of
    blocks pads by 16)."""
    rows, cols = tdh.P_TILE, tdh.Q_TILE
    cell = rows * (2 * cols + 16)
    q = 2 * cols * 48
    assert tdh.stage_bytes(False, False, False, 20) == 2 * cell + q
    assert tdh.stage_bytes(False, False, True, 20) == 3 * cell + q
    assert tdh.stage_bytes(False, True, True, 20) == 2 * cell + rows * (4 * cols + 32) + q
    assert tdh.stage_bytes(True, True, True, 20) == (
        2 * cols * (2 * rows + 16) + cols * (4 * rows + 16) + q)
    assert tdh.stage_bytes(False, False, False, 8) == 2 * cell + 2 * cols * 16
    assert tdh.stage_bytes(False, False, False, 16) == 2 * cell + 2 * cols * 48
    assert tdh.stage_bytes(False, False, False, 32) == 2 * cell + 2 * cols * 80
