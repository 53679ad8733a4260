"""What the CSR tail passes share: row chunking for the plain versions,
the argument checks of the kernel wrappers, the head-tier slices and adds
of the ``*_stats`` frames (permute, tail, head adds, permute back), and
the row-group geometry and padded tables of K1, K7, K5, K6 and K8
(``csrc/tail_groups.cuh``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pmf_tpu_torch.data.blocked import TailCSR
from pmf_tpu_torch.ops import _build
from pmf_tpu_torch.ops.dense_head import head_products, head_products_t

# csrc/tail_groups.cuh: kWarps, kInFlight, kDiagInFlight, kOneWord,
# kRecordOneWord, kMaxSpan, kWideWords, batch_of, the dot form's
# kDotWarps, kDotInFlight, kDotStages, kDotMaxVec, dot_ring_words, and K6's
# ring form's kRingInFlight, kRingWideInFlight, kRingStages, kRingMaxVec,
# and K5's and K8's sum form's kSumInFlight, kSumStages, kSumMaxVec,
# kSumBiasFrom, kSumScalarFrom.
GROUP_WARPS = 8
GROUP_IN_FLIGHT = 4
DIAG_IN_FLIGHT = 2
GROUP_ONE_WORD = 8
RECORD_ONE_WORD = 16
GROUP_MAX_SPAN = 64  # words a row of the register form (G = 32, V = 2)
WIDE_WORDS = 64  # words a chunk of the wide form, two a lane
DOT_WARPS = 4  # warps a CTA of the dot form, a row each
DOT_IN_FLIGHT = 4  # D: edges a round
DOT_STAGES = 3  # S: rounds in a warp's ring of shared memory
DOT_MAX_VEC = 4  # words a lane: the dot form up to 128 words a row
RING_IN_FLIGHT = 4  # D: edges a round of K6's ring form, 2 words a lane
RING_WIDE_IN_FLIGHT = 2  # and at 3 or 4 words a lane (rows past 64 words)
RING_STAGES = 3  # S: rounds in a warp's ring there
RING_MAX_VEC = 4  # words a lane: the ring form up to 128 words a row
SUM_IN_FLIGHT = 2  # D: edges a round of K5's and K8's sum form
SUM_STAGES = 4  # S: rounds in a warp's ring there
SUM_MAX_VEC = 4  # words a lane: the sum form up to 128 words a row
# Words a record from which K5 (kSumBiasFrom, K = 160) and K8
# (kSumScalarFrom, K = 144) take the sum form; the register form below.
SUM_FIRST_WORDS = {"K5": 41, "K8": 37}
# The sum form's other-id windows: where the gathered records exceed
# WINDOW_MIN_L2 times the card's L2, the pass walks windows of other ids,
# each window's records at most WINDOW_L2_SHARE of the L2, at most
# MAX_WINDOWS of them and at most one a WINDOW_MIN_EDGES edges of a mean
# self row (a window's share of a row pays the row's fixed costs again).
WINDOW_MIN_L2 = 1.5
WINDOW_L2_SHARE = 0.75
MAX_WINDOWS = 4
WINDOW_MIN_EDGES = 16
# The kernels whose mode has a dot form past 32 words a row: K1 "cavi", K7;
# the ring form, two rows an edge: K6.
DOT_KERNELS = ("K1", "K7")
RING_KERNELS = ("K6",)
# The sum form, one record an edge and no per-edge dot: K5, K8.
SUM_KERNELS = ("K5", "K8")
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


def dot_ring_words(words: int, d: int = DOT_IN_FLIGHT, s: int = DOT_STAGES) -> int:
    """Float4 words of one warp's ring in the dot form: S rounds of D rows
    of ``words`` words, then the S * D ratings, four a word."""
    return s * d * words + -(-(s * d) // 4)


def launch_plan(k: int, kernel: str = "K1") -> dict:
    """The row-group geometry of ``kernel`` (one of PLAN_KERNELS) at ``k``
    factors, as ``tail_groups::launch`` chooses it; ``form`` names the
    kernel: "group" (``tail_group_kernel``), "dot" (``tail_dot_kernel``),
    "ring" (``tail_ring_kernel``), "sum" (``tail_sum_kernel``) or "wide"
    (``tail_wide_kernel``).  ``words`` W =
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
    ``chunks`` is 1 in the other forms.  The dot form (K1 "cavi" and K7
    past 32 words a row, up to 32 * DOT_MAX_VEC): a warp a row (``lanes``
    32, ``vec`` ceil(W / 32) words a lane), ``in_flight`` D edges a round,
    ``stages`` S rounds in the warp's ring, ``smem`` the CTA's bytes of
    DOT_WARPS rings.  The ring form (K6 past 32 words a row, up to 32 *
    RING_MAX_VEC): the dot form's geometry, D = RING_IN_FLIGHT edges a
    round at V = 2 (RING_WIDE_IN_FLIGHT past it), RING_STAGES rounds, each
    edge's ``words`` record words and its ceil(K / 4) words of v + m^2 in
    the ring.  The sum form (K5 and K8 from SUM_FIRST_WORDS words a row, up
    to 32 * SUM_MAX_VEC): the dot form's geometry, D = SUM_IN_FLIGHT edges a
    round, SUM_STAGES rounds, each edge's ``words`` record words in the ring
    (K8's ring keeps the ratings' words unread)."""
    _build.check_k(k, "tail kernel")
    if kernel not in PLAN_KERNELS:
        raise ValueError(f"unknown row-group kernel {kernel!r} {PLAN_KERNELS}")
    cols = columns(k, kernel)
    words = -(-cols // 4)
    span = 1 << (words - 1).bit_length()
    ring = kernel in RING_KERNELS and 32 < words <= 32 * RING_MAX_VEC
    summed = kernel in SUM_KERNELS and SUM_FIRST_WORDS[kernel] <= words <= 32 * SUM_MAX_VEC
    if ring or summed or kernel in DOT_KERNELS and 32 < words <= 32 * DOT_MAX_VEC:
        vec = -(-words // 32)
        if ring:  # the ring holds each edge's record and its v + m^2 row
            d = RING_IN_FLIGHT if vec == 2 else RING_WIDE_IN_FLIGHT
            stages, edge_words = RING_STAGES, words + -(-k // 4)
        elif summed:
            d, stages, edge_words = SUM_IN_FLIGHT, SUM_STAGES, words
        else:
            d, stages, edge_words = DOT_IN_FLIGHT, DOT_STAGES, words
        form = "ring" if ring else "sum" if summed else "dot"
        return dict(form=form, lanes=32, vec=vec, words=words,
                    stride=tail_stride(cols), batch=32, in_flight=d, stages=stages,
                    rows_per_warp=1, rows_per_cta=DOT_WARPS, wide=False, chunks=1,
                    smem=DOT_WARPS * 16 * dot_ring_words(edge_words, d, stages))
    if span > GROUP_MAX_SPAN:
        summed = words if kernel == "K5" else -(-k // 4)
        return dict(form="wide", lanes=32, vec=WIDE_WORDS // 32, words=words,
                    stride=tail_stride(cols),
                    batch=32, in_flight=1, rows_per_warp=1, rows_per_cta=GROUP_WARPS,
                    wide=True, chunks=-(-summed // WIDE_WORDS))
    one_word = RECORD_ONE_WORD if kernel in WIDE_KERNELS else GROUP_ONE_WORD
    vec = 1 if span <= one_word else 2
    lanes = span // vec
    return dict(form="group", lanes=lanes, vec=vec, words=words, stride=tail_stride(cols),
                batch=max(lanes, 8),
                in_flight=DIAG_IN_FLIGHT if kernel == "K6" else GROUP_IN_FLIGHT,
                rows_per_warp=32 // lanes, rows_per_cta=32 * GROUP_WARPS // lanes,
                wide=False, chunks=1)


def boundary_ks(kernel: str = "K1", k_max: int = 600) -> list:
    """Every K up to ``k_max`` at which ``kernel``'s geometry changes: the
    first K of each plan (form, lanes, vec, chunks).  The tests and
    chip_smoke.py hold the kernel at K - 1 and K of each."""
    out, last = [], None
    for k in range(1, k_max + 1):
        p = launch_plan(k, kernel)
        key = (p["form"], p["lanes"], p["vec"], p["chunks"])
        if key != last:
            out.append(k)
            last = key
    return out


def window_count(k: int, n_other: int, nnz: int, rows: int, l2_bytes: int,
                 kernel: str = "K5") -> int:
    """Windows of other ids the sum form of ``kernel`` (K5, K8) walks at
    ``k`` factors over ``n_other`` records, ``nnz`` edges of ``rows`` self
    rows, on a card of ``l2_bytes`` of L2: 1 where the records' bytes are at
    most WINDOW_MIN_L2 x L2 or the plan takes another form, else ceil(bytes
    / (WINDOW_L2_SHARE x L2)), at most MAX_WINDOWS and at most nnz / (rows x
    WINDOW_MIN_EDGES)."""
    if kernel not in SUM_KERNELS or launch_plan(k, kernel)["form"] != "sum":
        return 1
    table = n_other * 4 * tail_stride(k + 1)
    if table <= WINDOW_MIN_L2 * l2_bytes:
        return 1
    n = min(MAX_WINDOWS, -(-table // int(WINDOW_L2_SHARE * l2_bytes)),
            nnz // (max(rows, 1) * WINDOW_MIN_EDGES))
    return max(n, 1)


@dataclass(frozen=True)
class TailWindows:
    """A CSR's edges in ``n`` windows of other ids (equal ranges of
    ceil(n_other / n) ids): ``other`` and ``x`` the edges regrouped by
    window inside each self row (CSR order within a window), ``ptr`` (n +
    1, rows) int64: window w's edges of row r are [ptr[w, r], ptr[w + 1,
    r]), so ptr[0] and ptr[n] are the CSR's row pointers."""

    n: int
    ptr: torch.Tensor
    other: torch.Tensor
    x: torch.Tensor


def build_windows(row_ptr: torch.Tensor, other: torch.Tensor, x: torch.Tensor,
                  n_other: int, n: int) -> TailWindows:
    """``TailWindows`` of a CSR: one stable sort by (self row, window)."""
    rows = row_ptr.shape[0] - 1
    size = -(-n_other // n)
    row_of = torch.repeat_interleave(torch.arange(rows, device=row_ptr.device),
                                     row_ptr[1:] - row_ptr[:-1])
    key = row_of * n + other.long() // size
    order = torch.sort(key, stable=True).indices
    cum = torch.cumsum(torch.bincount(key, minlength=rows * n).view(rows, n), dim=1)
    ptr = torch.empty((n + 1, rows), dtype=torch.int64, device=row_ptr.device)
    ptr[0] = row_ptr[:-1]
    ptr[1:] = row_ptr[:-1][None, :] + cum.t()
    return TailWindows(n, ptr, other[order].contiguous(), x[order].contiguous())


def tail_windows(p: TailCSR, k: int, kernel: str = "K5") -> TailWindows | None:
    """The windows K5's or K8's pass over ``p`` walks on its card at ``k``
    (``window_count`` of the card's L2), None where it walks none or on the
    host.  Each (kernel, k)'s answer and each window count's windows are
    kept on the TailCSR (not a field: ``band_of`` and ``dataclasses.replace``
    do not carry it), so a sweep's call costs a lookup; below the sum form
    no device is asked."""
    if (kernel not in SUM_KERNELS or -(-(k + 1) // 4) < SUM_FIRST_WORDS[kernel]
            or not p.row_ptr.is_cuda):
        return None
    cache = p.__dict__.get("_tail_windows")
    if cache is None:
        cache = {}
        object.__setattr__(p, "_tail_windows", cache)
    if (kernel, k) not in cache:
        l2 = torch.cuda.get_device_properties(p.row_ptr.device).L2_cache_size
        n = window_count(k, p.n_other, p.nnz, p.rows, l2, kernel)
        if n > 1 and n not in cache:
            cache[n] = build_windows(p.row_ptr, p.other, p.x, p.n_other, n)
        cache[(kernel, k)] = cache[n] if n > 1 else None
    return cache[(kernel, k)]


def window_args(windows: TailWindows | None, n_self: int, width: int, device,
                with_x: bool = True) -> tuple:
    """The C entries' window arguments (n, ptr, other, [x,] part, count):
    ``part`` n partial rows of ``width`` floats a self row, ``count`` a
    zeroed arrival count a self row; (1, null, ...) without windows."""
    if windows is None:
        return (1, None, None) + ((None,) if with_x else ()) + (None, None)
    if tuple(windows.ptr.shape) != (windows.n + 1, n_self):
        raise ValueError(f"windows of {tuple(windows.ptr.shape)} pointers for {n_self} rows")
    part = torch.empty((windows.n, n_self, width), dtype=torch.float32, device=device)
    count = torch.zeros((n_self,), dtype=torch.int32, device=device)
    return ((windows.n, windows.ptr, windows.other) + ((windows.x,) if with_x else ())
            + (part, count))


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
