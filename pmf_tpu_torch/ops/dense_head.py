"""Dense-head CAVI statistics for the hybrid engine.

Over one staircase tier (``data.blocked.DenseHead``), with theta the
tier's user rows and beta its item rows (zero past ``hi``):

    R = theta @ beta^T                       rate per cell
    W = where(M > 0, X / max(R, floor), 0)   allocation weight per cell
    user side: [W @ beta | M @ beta]         (rows, 2K)
    item side: [W^T @ theta | M^T @ theta]   (hip, 2K)

``fused_alloc_tier`` is the wrapper of kernel K2 (``csrc/dense_head.cu``):
on CUDA tensors it launches the kernel (or raises), on CPU tensors it runs
``fused_alloc_tier_plain``.  ``precision`` is "high" or "fast" (the
engines map "blocked_mid" to "high", ``models.base.BLOCKED_PRECISION``):
"high" takes every float32 operand as two bf16 planes and each product as
three terms (``pmf_dense_head_tier``); "fast" is the reference's
``Precision.DEFAULT``, one bf16 plane rounded to nearest an operand and
one term a product (``pmf_dense_head_tier_fast``).
``plan_launch`` is the kernel's launch plan as a pure function of the
tier's shape: resident CTAs, splits of the reduction axis, passes over
the cells and shared-memory bytes.  ``poisson_head_stats{,_t}`` apply
the final self-factor multiply, as the JAX package's functions of the same
names.

``head_products{,_t}`` are the linear products the Gaussian statistics
need over one tier, ``(M @ tab, X @ xtab)`` and their transposes.  The
JAX package leaves them to XLA dots, so here they are library matmuls.
On the card they follow the JAX bf16 part scheme: at
"high" M is one exact bf16 plane, X the stored ``x_hi`` +
``x_lo`` planes, each f32 table two bf16 planes; at "fast" every operand
is one plane rounded to nearest (M rounded to bf16, X its ``x_hi`` alone);
every product accumulates and returns float32
(``torch.mm(..., out_dtype=torch.float32)``: a plain bf16 ``torch.mm``
would round its output to bf16).  On the CPU, whose torch has no kernel
for that overload, they are plain matmuls in the table's dtype, on
operands rounded as the card's "fast" planes are.

``ext_head_stats{,_t}`` are the extended-Poisson head statistics: the
allocation half from K2 (the scalar factors cancel in it), the
scalar-weighted rate half ``M @ (s * B)`` from ``head_products{,_t}``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pmf_tpu_torch.data.blocked import DenseHead
from pmf_tpu_torch.ops import _build

HEAD_LAUNCHES = _build.LaunchCounter()
HEAD_FAST_LAUNCHES = _build.LaunchCounter()  # the one-term instance
PRECISIONS = ("fast", "high")

# Kernel geometry, a copy of csrc/dense_head.cu's for the launch plan (the
# kernel sizes its own shared memory; chip_smoke.py's K2 phases run every
# case of it on the card, where a copy out of step would show as a wrong
# count of resident CTAs in the log, not as a wrong result).  P is the table
# a CTA keeps (theta on the user side, beta on the item side), Q the table
# that streams past it in tiles along the reduction axis.
WARPS = 4  # warps a CTA up to K = 32; each owns 16 rows of P
PASS_WARPS = 8  # warps a CTA past K = 32 (head_pass_kernel)
P_TILE = 16 * WARPS  # rows of P a CTA
Q_TILE = 32  # rows of Q per tile
MAX_CTAS_PER_SM = 3  # resident CTAs the kernel's launch bounds keep registers for
PASS_MAX_K = 160  # output factors one pass over the cells keeps (K_pass)
W_STRIDE = 2 * Q_TILE + 16  # bytes a row of a W tile plane
STAGES = 3  # ring of staged tiles: two in flight, one computed
MAX_STAGES = 4  # the most a ring of the pass form takes
RING_STAGES = 2  # the same where P's chunks ride the ring
MAX_SPLITS = 64  # CTAs that may share one reduction axis
SMEM_PER_CTA = 232_448  # dynamic shared memory one CTA may ask for
SMEM_PER_SM = 233_472  # of which every resident CTA reserves 1 KB
SMEM_RESERVED = 1024


def is_fast(precision: str) -> bool:
    """Whether ``precision`` is "fast" (one bf16 plane an operand, one term
    a product) rather than "high" (two planes, three terms)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} {PRECISIONS}")
    return precision == "fast"


def _bf16_rn(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to nearest bf16, back in its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def fused_alloc_tier_plain(theta_h, beta_h, x_hi, m, x_lo=None, *,
                           rate_floor: float, item_side: bool = False,
                           row_chunk: int | None = None,
                           precision: str = "high") -> torch.Tensor:
    """Plain version of K2, in the tables' dtype.  ``row_chunk`` bounds the
    rows whose (rows, hip) temporaries exist at once.  At "fast" theta,
    beta, W and M are rounded to nearest bf16 before their products, as
    the one-term kernel's operands are."""
    fast = is_fast(precision)
    if fast:
        theta_h, beta_h = _bf16_rn(theta_h), _bf16_rn(beta_h)
    rows, K = theta_h.shape
    hip = m.shape[1]
    dtype = theta_h.dtype
    step = rows if row_chunk is None else max(int(row_chunk), 1)
    out = torch.zeros((hip if item_side else rows, 2 * K), dtype=dtype,
                      device=theta_h.device)
    for r0 in range(0, rows, step):
        th = theta_h[r0 : r0 + step]
        x = x_hi[r0 : r0 + step].to(dtype)
        if x_lo is not None:
            x = x + x_lo[r0 : r0 + step].to(dtype)
        mm = m[r0 : r0 + step].to(dtype)
        R = th @ beta_h.T
        W = torch.where(mm > 0, x / torch.clamp_min(R, rate_floor), 0.0)
        if fast:
            W, mm = _bf16_rn(W), _bf16_rn(mm)
        if item_side:
            out[:, :K] += W.T @ th
            out[:, K:] += mm.T @ th
        else:
            out[r0 : r0 + step, :K] = W @ beta_h
            out[r0 : r0 + step, K:] = mm @ beta_h
    return out


def passes(K: int) -> int:
    """Passes over a tier's cells (grid.z): 1 up to PASS_MAX_K, then
    ceil(K / PASS_MAX_K), each keeping the outputs of one depth chunk;
    ``pass_chunks`` in the source."""
    return -(-K // PASS_MAX_K)


def pass_width(K: int) -> int:
    """Factors of a depth chunk past K = 32 (CW: 64, 96, 128 or 160): K
    shared evenly by ``passes(K)`` chunks, rounded up to 32."""
    return 32 * -(-K // (32 * passes(K)))


def depth_blocks(K: int) -> int:
    """Blocks of 8 factors in the kernel's depth: ceil(K / 8) up to K = 32
    (``nt_of`` in the source), then ``passes(K)`` chunks of
    ``pass_width(K)``."""
    return -(-K // 8) if K <= 32 else passes(K) * pass_width(K) // 8


def _cell_bytes(item_side: bool, m_f32: bool, has_lo: bool) -> int:
    """Shared memory of one stage's cell tile: x_hi (and x_lo) and M."""
    cell_rows, cell_cols = (Q_TILE, P_TILE) if item_side else (P_TILE, Q_TILE)
    cs = cell_cols * 2 + 16
    ms = cell_cols * 4 + (16 if item_side else 32) if m_f32 else cs
    return cell_rows * cs * (2 if has_lo else 1) + cell_rows * ms


def w_planes(m_f32: bool, fast: bool) -> int:
    """Planes of a W tile past K = 32: W hi (and lo at "high"), and for a
    float32 M its hi (and lo); a bf16 M is read from the staged cells."""
    return (1 if fast else 2) * (2 if m_f32 else 1)


def pass_smem_bytes(K: int, item_side: bool, m_f32: bool, has_lo: bool,
                    fast: bool = False, p_ring: bool = False, stages: int = STAGES) -> int:
    """Shared memory of the form past K = 32: P's planes over the whole
    depth (none with ``p_ring``), the W tile, and ``stages`` stages, each
    the cell tile and one depth chunk of Q's planes (and of P's with
    ``p_ring``); ``pass_smem_bytes`` in the source."""
    planes = 1 if fast else 2
    p_res = 0 if p_ring else planes * P_TILE * (2 * 8 * depth_blocks(K) + 16)
    w_tile = w_planes(m_f32, fast) * P_TILE * W_STRIDE
    return p_res + w_tile + stages * stage_bytes(item_side, m_f32, has_lo, K, fast, p_ring)


def pass_stages(K: int, item_side: bool, m_f32: bool, has_lo: bool,
                fast: bool = False, p_ring: bool = False) -> int:
    """Stages of the pass form's ring: RING_STAGES where P rides the ring;
    else the most, from MAX_STAGES down to two, that keep the launch
    bounds' resident CTAs (two at a chunk of 64 factors, one wider), or
    STAGES where none does; ``pass_stages`` in the source."""
    if p_ring:
        return RING_STAGES
    room = min(SMEM_PER_SM // (2 if pass_width(K) == 64 else 1) - SMEM_RESERVED,
               SMEM_PER_CTA)
    return next((n for n in range(MAX_STAGES, 1, -1)
                 if pass_smem_bytes(K, item_side, m_f32, has_lo, fast, stages=n) <= room),
                STAGES)


def p_rides_ring(K: int, item_side: bool, m_f32: bool, has_lo: bool,
                 fast: bool = False) -> bool:
    """Whether P's planes stream through the ring: where they and three
    stages no longer fit one CTA's shared memory (only past PASS_MAX_K)."""
    return K > 32 and pass_smem_bytes(K, item_side, m_f32, has_lo, fast) > SMEM_PER_CTA


def boundary_ks(item_side: bool = False, m_f32: bool = False, has_lo: bool = True,
                fast: bool = False) -> list:
    """The first K of each form of K2 past K = 32, for one kind of tier:
    the pass form at each chunk width (33, 65, 97, 129), two passes (161)
    and P in the ring.  The tests and chip_smoke.py hold K2 on both sides
    of each."""
    ring = next(k for k in range(PASS_MAX_K + 1, 100_000)
                if p_rides_ring(k, item_side, m_f32, has_lo, fast))
    return [33, 65, 97, 129, PASS_MAX_K + 1, ring]


class LaunchPlan(NamedTuple):
    """How one tier and side is launched."""

    p_tile: int  # rows of P a CTA owns
    q_tile: int  # rows of Q per staged tile
    depth: int  # K padded to 8 depth_blocks(K) (columns of the bf16 planes)
    stages: int  # ring stages
    ctas_per_sm: int  # resident CTAs the shared memory and registers allow
    splits: int  # CTAs sharing the reduction axis (grid.y)
    tiles_per_split: int
    smem_bytes: int  # dynamic shared memory a CTA
    passes: int  # passes over the cells (grid.z), each one depth chunk's outputs
    threads: int  # threads a CTA
    p_ring: bool = False  # P's chunks ride the ring


def stage_bytes(item_side: bool, m_f32: bool, has_lo: bool, K: int,
                fast: bool = False, p_ring: bool = False) -> int:
    """Shared memory of one ring stage: the cell tile's planes (rows padded
    by 16 bytes, a float32 M by 32 on the user side) and the Q tile's hi and
    lo planes, or its hi plane alone at "fast" (rows of 16 bytes per 8
    factors, padded by 16 where that count is even; past K = 32 one depth
    chunk of ``pass_width(K)`` factors, and P's chunk too with
    ``p_ring``)."""
    if K <= 32:
        blocks = depth_blocks(K)
        q_rows, q_stride = Q_TILE, 16 * blocks + (0 if blocks % 2 else 16)
    else:
        q_rows = Q_TILE + (P_TILE if p_ring else 0)
        q_stride = 2 * pass_width(K) + 16
    return _cell_bytes(item_side, m_f32, has_lo) + (1 if fast else 2) * q_rows * q_stride


@functools.lru_cache(maxsize=None)
def plan_launch(rows: int, hip: int, K: int, item_side: bool, m_f32: bool,
                has_lo: bool, n_sm: int, fast: bool = False) -> LaunchPlan:
    """The launch of one tier and side on a card of ``n_sm`` SMs: the
    resident CTAs the ring's shared memory allows, and the split of the
    reduction axis (columns on the user side, rows on the item side) that
    takes the fewest tile times when the P tiles alone would not fill the
    card.  ``fast``: the one-term instance, whose stages hold no Q lo tile.
    Past K = 32 the pass form: ``passes(K)`` CTAs a P tile (grid.z), two
    resident CTAs an SM at a chunk of 64 factors (the launch bounds), one
    wider."""
    _build.check_k(K, "head kernel")
    p_ring = p_rides_ring(K, item_side, m_f32, has_lo, fast)
    if K <= 32:
        stages, threads, max_ctas = STAGES, 32 * WARPS, MAX_CTAS_PER_SM
        smem = stages * stage_bytes(item_side, m_f32, has_lo, K, fast)
    else:
        stages = pass_stages(K, item_side, m_f32, has_lo, fast, p_ring)
        threads, max_ctas = 32 * PASS_WARPS, 2 if pass_width(K) == 64 else 1
        smem = pass_smem_bytes(K, item_side, m_f32, has_lo, fast, p_ring, stages)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"a ring of {stages} stages, {smem} bytes, does not fit "
                         f"{SMEM_PER_CTA} bytes of shared memory")
    ctas = min(max_ctas, SMEM_PER_SM // (smem + SMEM_RESERVED))
    n_p, n_q = (hip, rows) if item_side else (rows, hip)
    parallel = -(-n_p // P_TILE) * passes(K)
    serial = max(-(-n_q // Q_TILE), 1)
    slots = ctas * n_sm
    # Cost in tile times (one tile through every resident CTA): the waves
    # of CTAs, each filling its ring once, and for a split axis the partial
    # rows written and read again, in units of the tiles' cell bytes.
    cell_bytes = 2 * (1 + has_lo) + (4 if m_f32 else 2)
    partial_tiles = 2 * n_p * 2 * K * 4 / (slots * P_TILE * Q_TILE * cell_bytes)
    best = None
    for s in range(1, min(serial, MAX_SPLITS) + 1):
        per = -(-serial // s)
        s = -(-serial // per)  # as the kernel cuts them: no split is empty
        waves = -(-parallel * s // slots)
        cost = waves * (per + stages - 1) + (s * partial_tiles if s > 1 else 0)
        if best is None or cost < best[0]:
            best = (cost, s, per)
    _, splits, per = best
    return LaunchPlan(P_TILE, Q_TILE, 8 * depth_blocks(K), stages, ctas, splits, per,
                      smem, passes(K), threads, p_ring)


def _check_cuda_args(theta_h, beta_h, x_hi, m, x_lo):
    rows, K = theta_h.shape
    hip = m.shape[1]
    _build.check_k(K, "head kernel")
    if rows < 1 or hip < 64 or hip % 64:
        raise ValueError(f"head of {rows} rows by {hip} columns: the kernel needs "
                         f"rows >= 1 and a width that is a multiple of 64")
    checks = [("theta_h", theta_h, (torch.float32,), (rows, K)),
              ("beta_h", beta_h, (torch.float32,), (hip, K)),
              ("x_hi", x_hi, (torch.bfloat16,), (rows, hip)),
              ("m", m, (torch.bfloat16, torch.float32), (rows, hip))]
    if x_lo is not None:
        checks.append(("x_lo", x_lo, (torch.bfloat16,), (rows, hip)))
    for name, t, dts, shape in checks:
        if t.device != theta_h.device:
            raise ValueError(f"{name} is on {t.device}, theta_h on {theta_h.device}")
        if t.dtype not in dts:
            raise TypeError(f"{name} must be one of {dts}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def fused_alloc_tier(theta_h, beta_h, x_hi, m, x_lo=None, *,
                     rate_floor: float, item_side: bool = False,
                     precision: str = "high") -> torch.Tensor:
    """K2 over one tier: (rows, 2K) user side or (hip, 2K) item side,
    [sum W * other | sum M * other] before the self-factor multiply.  On
    the card "fast" launches the one-term instance, "high" the three-term
    one."""
    fast = is_fast(precision)
    if not theta_h.is_cuda:
        return fused_alloc_tier_plain(theta_h, beta_h, x_hi, m, x_lo,
                                      rate_floor=rate_floor, item_side=item_side,
                                      precision=precision)
    theta_h = theta_h.contiguous()
    beta_h = beta_h.contiguous()
    _check_cuda_args(theta_h, beta_h, x_hi, m, x_lo)
    _build.load_library()  # build (or raise) before asking the card anything
    rows, K = theta_h.shape
    hip = m.shape[1]
    dev = theta_h.device
    m_f32 = m.dtype == torch.float32
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_launch(rows, hip, K, item_side, m_f32, x_lo is not None, n_sm, fast)
    out_rows = hip if item_side else rows
    out = torch.empty((out_rows, 2 * K), dtype=torch.float32, device=dev)
    # The streamed table's bf16 planes (hi and lo, or hi alone at "fast"),
    # and past K = 32 the fixed table's after them, which the launch fills.
    n_planed = (rows if item_side else hip) + (0 if K <= 32 else
                                               (hip if item_side else rows))
    planes = torch.empty((1 if fast else 2) * n_planed * plan.depth, dtype=torch.bfloat16,
                         device=dev)
    partial = (torch.empty((plan.splits, out_rows, 2 * K), dtype=torch.float32,
                           device=dev) if plan.splits > 1 else None)
    name, counter = (("pmf_dense_head_tier_fast", HEAD_FAST_LAUNCHES) if fast
                     else ("pmf_dense_head_tier", HEAD_LAUNCHES))
    _build.launch(name, counter, dev, theta_h, beta_h, x_hi, x_lo, m, int(m_f32),
                  rows, hip, K, rate_floor, int(item_side), plan.splits, planes,
                  partial, out)
    return out


def poisson_head_stats(theta_h: torch.Tensor, beta_h: torch.Tensor,
                       head: DenseHead, rate_floor: float, precision: str = "high"):
    """User-side head statistics (S_alloc, S_other), both (hu, K).
    theta_h: (hu, K) tier user rows, beta_h: (hip, K) head item rows
    (zero past hi), both in count-reordered space."""
    K = theta_h.shape[1]
    out = fused_alloc_tier(theta_h, beta_h, head.x_hi, head.m, head.x_lo,
                           rate_floor=rate_floor, precision=precision)
    return theta_h * out[:, :K], out[:, K:]


def poisson_head_stats_t(theta_h: torch.Tensor, beta_h: torch.Tensor,
                         head: DenseHead, rate_floor: float, precision: str = "high"):
    """Item-side head statistics (S_alloc, S_other), both (hip, K); rows
    past hi are zeros (M is zero there)."""
    K = theta_h.shape[1]
    out = fused_alloc_tier(theta_h, beta_h, head.x_hi, head.m, head.x_lo,
                           rate_floor=rate_floor, item_side=True, precision=precision)
    return beta_h * out[:, :K], out[:, K:]


def _bf16_planes(t: torch.Tensor) -> list:
    """float32 (n, c) -> [hi, lo] bf16 planes with hi + lo == t to ~2^-16
    relative: hi keeps the top 16 bits (exact in bf16), lo rounds the
    remainder."""
    hi = (t.float().contiguous().view(torch.int32) & -65536).view(torch.float32)
    return [hi.to(torch.bfloat16), (t.float() - hi).to(torch.bfloat16)]


def _cells_product(planes: list, b: torch.Tensor, transpose_a: bool,
                   fast: bool) -> torch.Tensor:
    """(sum of cell planes) @ b, or its transpose, with b as one RN bf16
    plane at "fast", else as the truncated hi and the rounded lo of
    ``_bf16_planes``.  On the card sum_{i+j<2} A_i @ B_j (one term at
    "fast") in float32, one matmul per A plane with its B planes side by
    side.  On the CPU, a plain matmul in b's dtype, with b rounded to bf16
    at "fast"."""
    if not b.is_cuda:
        a = planes[0].to(b.dtype)
        for p in planes[1:]:
            a = a + p.to(b.dtype)
        if fast:
            b = _bf16_rn(b)
        return a.T @ b if transpose_a else a @ b
    b_planes = [b.to(torch.bfloat16)] if fast else _bf16_planes(b)
    w = b.shape[1]
    out = None
    for i, a in enumerate(planes):
        bs = b_planes[: len(b_planes) - i]
        prod = torch.mm(a.T if transpose_a else a, torch.cat(bs, dim=1),
                        out_dtype=torch.float32)
        for j in range(len(bs)):
            part = prod[:, j * w : (j + 1) * w]
            out = part if out is None else out + part
    return out


def _m_planes(head: DenseHead, tab: torch.Tensor, fast: bool) -> list:
    """M as the card's bf16 planes, or as stored for the CPU's matmuls; at
    "fast", M rounded to bf16 on both."""
    if fast:
        return [head.m_bf16_rn()]
    return head.m_bf16_planes() if tab.is_cuda else [head.m]


def _x_planes(head: DenseHead, fast: bool) -> list:
    """X's stored planes; at "fast" ``x_lo`` is dropped, as the reference's
    ``head_products`` drops it at one part."""
    return [head.x_hi] + ([head.x_lo] if head.x_lo is not None and not fast else [])


def head_products(head: DenseHead, other_tab: torch.Tensor,
                  x_tab: torch.Tensor | None, precision: str = "high"):
    """User-side linear head statistics ``(M @ other_tab, X @ x_tab)``:
    other_tab (hip, W) and x_tab (hip, Wx) or None, per head item (rows
    past hi zero).  Returns ((hu, W), (hu, Wx) or None), float32 on the
    card, the tables' dtype on the CPU."""
    fast = is_fast(precision)
    mp = _cells_product(_m_planes(head, other_tab, fast), other_tab, False, fast)
    xp = (None if x_tab is None
          else _cells_product(_x_planes(head, fast), x_tab, False, fast))
    return mp, xp


def head_products_t(head: DenseHead, self_tab: torch.Tensor,
                    x_tab: torch.Tensor | None, precision: str = "high"):
    """Item-side linear head statistics ``(M^T @ self_tab, X^T @ x_tab)``:
    self_tab (hu, W) and x_tab (hu, Wx) or None, per tier user row.
    Returns ((hip, W), (hip, Wx) or None); rows past hi are zeros."""
    fast = is_fast(precision)
    mp = _cells_product(_m_planes(head, self_tab, fast), self_tab, True, fast)
    xp = (None if x_tab is None
          else _cells_product(_x_planes(head, fast), x_tab, True, fast))
    return mp, xp


def ext_head_stats(theta_h: torch.Tensor, beta_h: torch.Tensor,
                   sbeta_h: torch.Tensor, head: DenseHead, rate_floor: float,
                   precision: str = "high"):
    """Extended-Poisson user-side head statistics (S_alloc, S_wother), both
    (hu, K).  The allocation divides by the factor dot alone, so S_alloc
    is the plain form's (K2; its M @ B half goes unused); the rate
    statistic is scalar-weighted, S_wother = M @ sbeta_h with sbeta_h =
    s_other[:, None] * beta_h made by the caller."""
    K = theta_h.shape[1]
    out = fused_alloc_tier(theta_h, beta_h, head.x_hi, head.m, head.x_lo,
                           rate_floor=rate_floor, precision=precision)
    sw, _ = head_products(head, sbeta_h, None, precision)
    return theta_h * out[:, :K], sw


def ext_head_stats_t(theta_h: torch.Tensor, beta_h: torch.Tensor,
                     stheta_h: torch.Tensor, head: DenseHead, rate_floor: float,
                     precision: str = "high"):
    """Extended-Poisson item-side head statistics (S_alloc, S_wother), both
    (hip, K), rows past hi zero; stheta_h = s_other[:, None] * theta_h (the
    user scalars)."""
    K = theta_h.shape[1]
    out = fused_alloc_tier(theta_h, beta_h, head.x_hi, head.m, head.x_lo,
                           rate_floor=rate_floor, item_side=True, precision=precision)
    sw, _ = head_products_t(head, stheta_h, None, precision)
    return beta_h * out[:, :K], sw
