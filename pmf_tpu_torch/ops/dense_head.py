"""Dense-head CAVI statistics for the hybrid engine.

Over one staircase tier (``data.blocked.DenseHead``), with theta the
tier's user rows and beta its item rows (zero past ``hi``):

    R = theta @ beta^T                       rate per cell
    W = where(M > 0, X / max(R, floor), 0)   allocation weight per cell
    user side: [W @ beta | M @ beta]         (rows, 2K)
    item side: [W^T @ theta | M^T @ theta]   (hip, 2K)

``fused_alloc_tier`` is the wrapper of kernel K2 (``csrc/dense_head.cu``):
on CUDA tensors it launches the kernel (or raises), on CPU tensors it runs
``fused_alloc_tier_plain``.  ``poisson_head_stats{,_t}`` apply the final
self-factor multiply, as the JAX package's functions of the same names.

``head_products{,_t}`` are the linear products the Gaussian statistics
need over one tier, ``(M @ tab, X @ xtab)`` and their transposes.  The
JAX package leaves them to XLA dots, so here they are library matmuls.
On the card they follow the JAX bf16 part scheme: M is one exact bf16
plane, X the stored ``x_hi`` + ``x_lo`` planes, each f32 table two bf16
planes; every product accumulates and returns float32
(``torch.mm(..., out_dtype=torch.float32)``: a plain bf16 ``torch.mm``
would round its output to bf16).  On the CPU, whose torch has no kernel
for that overload, they are plain matmuls in the table's dtype.

``ext_head_stats{,_t}`` are the extended-Poisson head statistics: the
allocation half from K2 (the scalar factors cancel in it), the
scalar-weighted rate half ``M @ (s * B)`` from ``head_products{,_t}``.
"""

from __future__ import annotations

import math

import torch

from pmf_tpu_torch.data.blocked import DenseHead
from pmf_tpu_torch.ops import _build

HEAD_LAUNCHES = _build.LaunchCounter()

# Kernel geometry (kept in step with csrc/dense_head.cu).
USER_ROWS = 64  # rows per CTA, user side
USER_COLS = 32  # columns per tile, user side
ITEM_COLS = 64  # columns per CTA, item side
ITEM_ROW_BATCH = 32  # rows per batch, item side
CTAS_PER_SM = 4  # split the reduction axis until the grid has this many


def fused_alloc_tier_plain(theta_h, beta_h, x_hi, m, x_lo=None, *,
                           rate_floor: float, item_side: bool = False,
                           row_chunk: int | None = None) -> torch.Tensor:
    """Plain version of K2, in the tables' dtype.  ``row_chunk`` bounds the
    rows whose (rows, hip) temporaries exist at once."""
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
        if item_side:
            out[:, :K] += W.T @ th
            out[:, K:] += mm.T @ th
        else:
            out[r0 : r0 + step, :K] = W @ beta_h
            out[r0 : r0 + step, K:] = mm @ beta_h
    return out


def plan_splits(rows: int, hip: int, item_side: bool, n_sm: int) -> int:
    """How many CTAs share the reduction axis (columns on the user side,
    rows on the item side) so the grid fills the card."""
    if item_side:
        parallel = hip // ITEM_COLS
        serial = -(-rows // ITEM_ROW_BATCH)
    else:
        parallel = -(-rows // USER_ROWS)
        serial = hip // USER_COLS
    if serial <= 1:
        return 1
    splits = min(serial, math.ceil(CTAS_PER_SM * n_sm / max(parallel, 1)))
    per = -(-serial // splits)  # serial tiles per split, as the kernel cuts them
    return -(-serial // per)  # no empty splits


def _check_cuda_args(theta_h, beta_h, x_hi, m, x_lo):
    rows, K = theta_h.shape
    hip = m.shape[1]
    if not 1 <= K <= 32:
        raise ValueError(f"head kernel needs 1 <= K <= 32, got K={K}")
    if hip % ITEM_COLS or hip % USER_COLS:
        raise ValueError(f"head width {hip} must be a multiple of {ITEM_COLS}")
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
                     rate_floor: float, item_side: bool = False) -> torch.Tensor:
    """K2 over one tier: (rows, 2K) user side or (hip, 2K) item side,
    [sum W * other | sum M * other] before the self-factor multiply."""
    if not theta_h.is_cuda:
        return fused_alloc_tier_plain(theta_h, beta_h, x_hi, m, x_lo,
                                      rate_floor=rate_floor, item_side=item_side)
    theta_h = theta_h.contiguous()
    beta_h = beta_h.contiguous()
    _check_cuda_args(theta_h, beta_h, x_hi, m, x_lo)
    _build.load_library()  # build (or raise) before asking the card anything
    rows, K = theta_h.shape
    hip = m.shape[1]
    dev = theta_h.device
    out_rows = hip if item_side else rows
    out = torch.empty((out_rows, 2 * K), dtype=torch.float32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = plan_splits(rows, hip, item_side, n_sm)
    partial = (torch.empty((splits, out_rows, 2 * K), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    _build.launch("pmf_dense_head_tier", HEAD_LAUNCHES, dev, theta_h, beta_h,
                  x_hi, x_lo, m, int(m.dtype == torch.float32), rows, hip, K,
                  rate_floor, int(item_side), splits, partial, out)
    return out


def poisson_head_stats(theta_h: torch.Tensor, beta_h: torch.Tensor,
                       head: DenseHead, rate_floor: float):
    """User-side head statistics (S_alloc, S_other), both (hu, K).
    theta_h: (hu, K) tier user rows, beta_h: (hip, K) head item rows
    (zero past hi), both in count-reordered space."""
    K = theta_h.shape[1]
    out = fused_alloc_tier(theta_h, beta_h, head.x_hi, head.m, head.x_lo,
                           rate_floor=rate_floor)
    return theta_h * out[:, :K], out[:, K:]


def poisson_head_stats_t(theta_h: torch.Tensor, beta_h: torch.Tensor,
                         head: DenseHead, rate_floor: float):
    """Item-side head statistics (S_alloc, S_other), both (hip, K); rows
    past hi are zeros (M is zero there)."""
    K = theta_h.shape[1]
    out = fused_alloc_tier(theta_h, beta_h, head.x_hi, head.m, head.x_lo,
                           rate_floor=rate_floor, item_side=True)
    return beta_h * out[:, :K], out[:, K:]


def _bf16_planes(t: torch.Tensor) -> list:
    """float32 (n, c) -> [hi, lo] bf16 planes with hi + lo == t to ~2^-16
    relative: hi keeps the top 16 bits (exact in bf16), lo rounds the
    remainder."""
    hi = (t.float().contiguous().view(torch.int32) & -65536).view(torch.float32)
    return [hi.to(torch.bfloat16), (t.float() - hi).to(torch.bfloat16)]


def _cells_product(planes: list, b: torch.Tensor, transpose_a: bool) -> torch.Tensor:
    """(sum of cell planes) @ b, or its transpose.  On the card the planes
    are bf16 and b splits into two bf16 planes: sum_{i+j<2} A_i @ B_j in
    float32, one matmul per A plane with its B planes side by side.  On
    the CPU, a plain matmul in b's dtype."""
    if not b.is_cuda:
        a = planes[0].to(b.dtype)
        for p in planes[1:]:
            a = a + p.to(b.dtype)
        return a.T @ b if transpose_a else a @ b
    b_planes = _bf16_planes(b)
    w = b.shape[1]
    out = None
    for i, a in enumerate(planes):
        bs = b_planes[: 2 - i]
        prod = torch.mm(a.T if transpose_a else a, torch.cat(bs, dim=1),
                        out_dtype=torch.float32)
        for j in range(len(bs)):
            part = prod[:, j * w : (j + 1) * w]
            out = part if out is None else out + part
    return out


def _m_planes(head: DenseHead, tab: torch.Tensor) -> list:
    """M as the card's bf16 planes, or as stored for the CPU's matmuls."""
    return head.m_bf16_planes() if tab.is_cuda else [head.m]


def _x_planes(head: DenseHead) -> list:
    return [head.x_hi] + ([head.x_lo] if head.x_lo is not None else [])


def head_products(head: DenseHead, other_tab: torch.Tensor,
                  x_tab: torch.Tensor | None):
    """User-side linear head statistics ``(M @ other_tab, X @ x_tab)``:
    other_tab (hip, W) and x_tab (hip, Wx) or None, per head item (rows
    past hi zero).  Returns ((hu, W), (hu, Wx) or None), float32 on the
    card, the tables' dtype on the CPU."""
    mp = _cells_product(_m_planes(head, other_tab), other_tab, transpose_a=False)
    xp = (None if x_tab is None
          else _cells_product(_x_planes(head), x_tab, transpose_a=False))
    return mp, xp


def head_products_t(head: DenseHead, self_tab: torch.Tensor,
                    x_tab: torch.Tensor | None):
    """Item-side linear head statistics ``(M^T @ self_tab, X^T @ x_tab)``:
    self_tab (hu, W) and x_tab (hu, Wx) or None, per tier user row.
    Returns ((hip, W), (hip, Wx) or None); rows past hi are zeros."""
    mp = _cells_product(_m_planes(head, self_tab), self_tab, transpose_a=True)
    xp = (None if x_tab is None
          else _cells_product(_x_planes(head), x_tab, transpose_a=True))
    return mp, xp


def ext_head_stats(theta_h: torch.Tensor, beta_h: torch.Tensor,
                   sbeta_h: torch.Tensor, head: DenseHead, rate_floor: float):
    """Extended-Poisson user-side head statistics (S_alloc, S_wother), both
    (hu, K).  The allocation divides by the factor dot alone, so S_alloc
    is the plain form's (K2; its M @ B half goes unused); the rate
    statistic is scalar-weighted, S_wother = M @ sbeta_h with sbeta_h =
    s_other[:, None] * beta_h made by the caller."""
    K = theta_h.shape[1]
    out = fused_alloc_tier(theta_h, beta_h, head.x_hi, head.m, head.x_lo,
                           rate_floor=rate_floor)
    sw, _ = head_products(head, sbeta_h, None)
    return theta_h * out[:, :K], sw


def ext_head_stats_t(theta_h: torch.Tensor, beta_h: torch.Tensor,
                     stheta_h: torch.Tensor, head: DenseHead, rate_floor: float):
    """Extended-Poisson item-side head statistics (S_alloc, S_wother), both
    (hip, K), rows past hi zero; stheta_h = s_other[:, None] * theta_h (the
    user scalars)."""
    K = theta_h.shape[1]
    out = fused_alloc_tier(theta_h, beta_h, head.x_hi, head.m, head.x_lo,
                           rate_floor=rate_floor, item_side=True)
    sw, _ = head_products_t(head, stheta_h, None)
    return beta_h * out[:, :K], sw
