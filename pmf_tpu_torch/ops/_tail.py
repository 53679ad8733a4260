"""What the CSR tail passes share: row chunking for the plain versions,
the argument checks of the kernel wrappers, the head-tier slices and adds
of the ``*_stats`` frames (permute, tail, head adds, permute back), and
the row-group geometry and padded tables of K1, K7, K5, K6 and K8
(``csrc/tail_groups.cuh``)."""

from __future__ import annotations

import torch

from pmf_tpu_torch.data.blocked import TailCSR
from pmf_tpu_torch.ops import _build
from pmf_tpu_torch.ops.dense_head import head_products, head_products_t

# csrc/tail_groups.cuh: kWarps, kInFlight, kDiagInFlight, kOneWord,
# kRecordOneWord, kMaxSpan, kWideWords, batch_of.
GROUP_WARPS = 8
GROUP_IN_FLIGHT = 4
DIAG_IN_FLIGHT = 2
GROUP_ONE_WORD = 8
RECORD_ONE_WORD = 16
GROUP_MAX_SPAN = 64  # words a row of the register form (G = 32, V = 2)
WIDE_WORDS = 64  # words a chunk of the wide form, two a lane
# The kernels that gather records of K + 1 columns: K5's and K6's [m | b],
# K7's and K8's [e | s].
RECORD_KERNELS = ("K5", "K6", "K7", "K8")
# The kernels that take one word a lane up to RECORD_ONE_WORD words.
WIDE_KERNELS = ("K5", "K6")
# The row-group kernels: K1 (modes "cavi", "raw"), K7, K5, K6 and K8.
PLAN_KERNELS = ("K1", "K1raw", "K7", "K5", "K6", "K8")


def tail_stride(k: int) -> int:
    """Row width, in floats, of the tables of ``k`` columns the row-group
    kernels (K1, K7, K5, K6, K8) take on the card: rounded up to 4, so that
    every row starts on 16 bytes."""
    return -(-k // 4) * 4


def columns(k: int, kernel: str = "K1") -> int:
    """Columns of a row of the other table a row-group kernel gathers: K
    factors, and the scalar in column K of the records of K5 and K6
    ([m | b]) and of K7 and K8 ([e | s])."""
    return k + 1 if kernel in RECORD_KERNELS else k


def launch_plan(k: int, kernel: str = "K1") -> dict:
    """The row-group geometry of ``kernel`` (one of PLAN_KERNELS) at ``k``
    factors, as ``tail_groups::launch`` chooses it: ``words`` W =
    ceil(columns / 4) float4 words a row; ``lanes`` G a row and ``vec`` V
    words a lane, V = 1 up to a span of GROUP_ONE_WORD words (K5, K6:
    RECORD_ONE_WORD) and 2 past it, G = span / V, for span the power of two
    at or above W; lane l of a group holds words l, l + G, ...; each lane
    loads ``batch`` / G edges' ids a batch; ``in_flight`` edges a group
    gathers at once (K6: DIAG_IN_FLIGHT); ``rows_per_warp`` and
    ``rows_per_cta`` (warps past TailCSR.long_rows); ``stride`` the padded
    width of the gathered rows.  ``wide``: past a span of GROUP_MAX_SPAN
    words, ``tail_wide_kernel`` (a warp a row, one edge at a time, the
    summed words in ``chunks`` of WIDE_WORDS walked one after another);
    ``chunks`` is 1 in the register form."""
    _build.check_k(k, "tail kernel")
    if kernel not in PLAN_KERNELS:
        raise ValueError(f"unknown row-group kernel {kernel!r} {PLAN_KERNELS}")
    cols = columns(k, kernel)
    words = -(-cols // 4)
    span = 1 << (words - 1).bit_length()
    if span > GROUP_MAX_SPAN:
        summed = words if kernel == "K5" else -(-k // 4)
        return dict(lanes=32, vec=WIDE_WORDS // 32, words=words, stride=tail_stride(cols),
                    batch=32, in_flight=1, rows_per_warp=1, rows_per_cta=GROUP_WARPS,
                    wide=True, chunks=-(-summed // WIDE_WORDS))
    one_word = RECORD_ONE_WORD if kernel in WIDE_KERNELS else GROUP_ONE_WORD
    vec = 1 if span <= one_word else 2
    lanes = span // vec
    return dict(lanes=lanes, vec=vec, words=words, stride=tail_stride(cols),
                batch=max(lanes, 8),
                in_flight=DIAG_IN_FLIGHT if kernel == "K6" else GROUP_IN_FLIGHT,
                rows_per_warp=32 // lanes, rows_per_cta=32 * GROUP_WARPS // lanes,
                wide=False, chunks=1)


def boundary_ks(kernel: str = "K1", k_max: int = 600) -> list:
    """Every K up to ``k_max`` at which ``kernel``'s geometry changes: the
    first K of each plan (lanes, vec, wide form, chunks).  The tests and
    chip_smoke.py hold the kernel at K - 1 and K of each."""
    out, last = [], None
    for k in range(1, k_max + 1):
        p = launch_plan(k, kernel)
        key = (p["lanes"], p["vec"], p["wide"], p["chunks"])
        if key != last:
            out.append(k)
            last = key
    return out


def padded_rows(tab: torch.Tensor, rows: torch.Tensor | None = None) -> torch.Tensor:
    """Rows ``rows`` of ``tab`` (all when None) in a table of
    ``tail_stride(K)`` columns, zero past K: the rows are gathered straight
    into the padded table.  The frames scatter instead (``new_space_rows``):
    on the card a gather of rows of a multiple of 16 bytes is the slow path
    (``scattered_rows``); chip_smoke.py's phases K1 and K7 time both."""
    n, K = tab.shape
    S = tail_stride(K)
    if S == K:
        return tab.contiguous() if rows is None else tab[rows]
    if rows is None:  # one cat with a zero pad
        return torch.cat([tab, tab.new_zeros((1, S - K)).expand(n, -1)], dim=1)
    out = tab.new_empty((rows.shape[0], S))
    out[:, K:] = 0
    torch.index_select(tab, 0, rows, out=out[:, :K])
    return out


def scattered_rows(tab: torch.Tensor, new_of_old: torch.Tensor) -> torch.Tensor:
    """``tab`` permuted into new space by scattering each row to its new
    place (one ``index_put_``).  On the card a gather of narrow rows whose
    width is a multiple of 16 bytes (``tab[old_of_new]``) takes PyTorch's
    one-block-a-row kernel, several times slower (PERF.md, the K5 and K6
    findings)."""
    out = torch.empty_like(tab)
    out[new_of_old] = tab
    return out


def record_rows(m: torch.Tensor, b: torch.Tensor,
                new_of_old: torch.Tensor | None = None) -> torch.Tensor:
    """Records [m | b | 0 pad] of K + 1 columns padded to ``tail_stride(K +
    1)``, b in column K (K5's and K6's [m | b], K7's and K8's [e | s]):
    joined by one cat and, with ``new_of_old``, permuted into new space by
    one scatter (``scattered_rows``)."""
    K = m.shape[1]
    pad = m.new_zeros((1, tail_stride(K + 1) - K - 1)).expand(m.shape[0], -1)
    tab = torch.cat([m, b[:, None].to(m.dtype), pad], dim=1)
    return tab if new_of_old is None else scattered_rows(tab, new_of_old)


def new_space_rows(tab: torch.Tensor, new_of_old: torch.Tensor | None) -> torch.Tensor:
    """``tab`` padded to ``tail_stride(K)`` columns (``padded_rows``) and,
    with ``new_of_old``, scattered into new space (``scattered_rows``)."""
    out = padded_rows(tab)
    return out if new_of_old is None else scattered_rows(out, new_of_old)


def tail_tables(e_self: torch.Tensor, e_other: torch.Tensor, p: TailCSR):
    """A pass's self and other tables in new space, padded for the
    row-group kernels: each scattered by ``TailCSR.*_new_of_old``."""
    return (new_space_rows(e_self, p.self_new_of_old if p.reordered else None),
            new_space_rows(e_other, p.other_new_of_old if p.reordered else None))


def band_rows(tab: torch.Tensor, p: TailCSR) -> torch.Tensor:
    """The rows of a new-space self table that ``p`` holds: all of them for a
    whole direction, rows [row0, row0 + rows) for a band
    (``data.blocked.band_of``).  A band of a padded table still starts on
    16 bytes."""
    if p.row0 == 0 and p.rows == tab.shape[0]:
        return tab
    return tab[p.row0 : p.row0 + p.rows]


def unband(out: torch.Tensor, p: TailCSR) -> torch.Tensor:
    """Per-row statistics of ``p``'s rows placed in a table of all n_self
    rows, zero outside a band."""
    if p.row0 == 0 and p.rows == p.n_self:
        return out
    full = out.new_zeros((p.n_self,) + tuple(out.shape[1:]))
    full[p.row0 : p.row0 + p.rows] = out
    return full


def check_padded_tables(K: int, tables, kernel: str = "K1") -> None:
    """Raise unless the (name, tensor) ``tables`` are the padded tables the
    row-group ``kernel`` takes on the card: 2-D, of one width,
    ``tail_stride(columns(K, kernel))`` columns, starting on 16 bytes."""
    (name0, t0), *rest = tables
    for name, t in rest:
        if t.dim() != 2 or t.shape[1] != t0.shape[1]:
            raise ValueError(f"{name0} and {name} differ in K")
    cols = columns(K, kernel)
    S = tail_stride(cols)
    if t0.dim() != 2 or t0.shape[1] != S:
        what = "K" if cols == K else f"K + {cols - K}"
        raise ValueError(f"the tables must be padded to tail_stride({what}) = {S} "
                         f"columns for K={K}, got {tuple(t0.shape)}")
    for name, t in tables:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes")


def check_long_rows(long_rows: int, n_self: int) -> None:
    if not 0 <= long_rows <= n_self:
        raise ValueError(f"long_rows must lie in [0, {n_self}], got {long_rows}")


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


def products(tier, tab, x_tab, head_side, precision: str = "high"):
    """(start row, M-product, X-product) of one tier, cut to its self rows,
    at the head products' ``precision``."""
    if head_side == "user":
        mp, xp = head_products(tier, tab, x_tab, precision)
        return tier.row_start, mp, xp
    mp, xp = head_products_t(tier, tab, x_tab, precision)
    return 0, mp[: tier.hi], None if xp is None else xp[: tier.hi]


def add_heads(out, head_outs):
    """Add each (start row, rows) head contribution onto ``out``."""
    for start, h in head_outs:
        out[start : start + h.shape[0]] += h.to(out.dtype)
    return out
