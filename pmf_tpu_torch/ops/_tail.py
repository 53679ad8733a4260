"""What the CSR tail passes share: row chunking for the plain versions,
the argument checks of the kernel wrappers, and the head-tier slices and
adds of the ``*_stats`` frames (permute, tail, head adds, permute back)."""

from __future__ import annotations

import torch

from pmf_tpu_torch.data.blocked import TailCSR
from pmf_tpu_torch.ops.dense_head import head_products, head_products_t


def row_chunks(row_ptr: torch.Tensor, max_edges: int | None):
    """(row_start, row_end) ranges of whole rows holding <= max_edges edges
    each (a longer single row forms its own range)."""
    n = row_ptr.shape[0] - 1
    if max_edges is None:
        yield 0, n
        return
    rp = row_ptr.cpu()
    r = 0
    while r < n:
        stop = int(torch.searchsorted(rp, rp[r] + max_edges, right=True)) - 1
        stop = min(max(stop, r + 1), n)
        yield r, stop
        r = stop


def edges(row_ptr, other, r0, r1):
    """(local self row, other id, edge slice) of rows [r0, r1)."""
    lo, hi = int(row_ptr[r0]), int(row_ptr[r1])
    counts = row_ptr[r0 + 1 : r1 + 1] - row_ptr[r0:r1]
    local = torch.repeat_interleave(
        torch.arange(r1 - r0, device=row_ptr.device), counts)
    return local, other[lo:hi].long(), slice(lo, hi)


def check_tail_args(tables, row_ptr, other, x, n_self):
    """Raise on what the tail kernels do not take: ``tables`` are
    (name, tensor) pairs of float32 tables; ``x`` may be None for a pass
    that reads no ratings."""
    checks = [(name, t, torch.float32) for name, t in tables] + [
        ("row_ptr", row_ptr, torch.int64), ("other", other, torch.int32)]
    if x is not None:
        checks.append(("x", x, torch.float32))
    for name, t, dt in checks:
        if t.device != row_ptr.device:
            raise ValueError(f"{name} is on {t.device}, row_ptr on {row_ptr.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if row_ptr.shape[0] != n_self + 1 or (x is not None and other.shape != x.shape):
        raise ValueError("CSR shapes do not match the self rows")


def check_head(p: TailCSR, head):
    if head and not p.reordered:
        raise ValueError("dense head requires a reordered layout")
    return head or ()


def head_rows(tab: torch.Tensor, tier, head_side: str) -> torch.Tensor:
    """The tier's other rows of a new-space table (1-D or 2-D), zero-padded
    to the product's contraction length: head items [0, hi) padded to hip
    on the user side, the tier's user band on the item side."""
    if head_side == "user":
        t = tab[: tier.hi]
        pad = (0, 0) * (t.dim() - 1) + (0, tier.hip - t.shape[0])
        return torch.nn.functional.pad(t, pad)
    return tab[tier.row_start : tier.row_start + tier.hu]


def head_tables(e_self, e_other, tier, head_side: str):
    """(theta_h (hu, K), beta_h (hip, K)): the tier's user band and its
    zero-padded head items, from a pass's new-space self and other tables."""
    users, items = (e_self, e_other) if head_side == "user" else (e_other, e_self)
    return head_rows(users, tier, "item"), head_rows(items, tier, "user")


def head_out(tier, head_side: str, cols):
    """(start row, ``cols`` side by side) of one tier's per-self-row
    statistics: the user band on the user side; on the item side rows
    [0, hi), the padding rows past hi dropped."""
    out = torch.cat(list(cols), dim=1)
    return (tier.row_start, out) if head_side == "user" else (0, out[: tier.hi])


def products(tier, tab, x_tab, head_side):
    """(start row, M-product, X-product) of one tier, cut to its self rows."""
    if head_side == "user":
        mp, xp = head_products(tier, tab, x_tab)
        return tier.row_start, mp, xp
    mp, xp = head_products_t(tier, tab, x_tab)
    return 0, mp[: tier.hi], None if xp is None else xp[: tier.hi]


def add_heads(out, head_outs):
    """Add each (start row, rows) head contribution onto ``out``."""
    for start, h in head_outs:
        out[start : start + h.shape[0]] += h.to(out.dtype)
    return out
