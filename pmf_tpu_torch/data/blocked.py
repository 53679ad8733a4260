"""Hybrid edge layout: a dense head staircase plus a CSR sparse tail.

Rows are relabelled by descending rating count (NEW space) so the busiest
users and items sit at low ids.  The (top users) x (top items) corner of a
Zipf-shaped rating matrix is then dense enough that its CAVI statistics
are dense products over stored cell planes (``DenseHead``, processed by
``ops.dense_head``); the remaining edges form the sparse tail, stored per
direction as CSR over new-space self rows (``TailCSR``, processed by
``ops.cavi_edge``).

The permutations, the staircase picker ``_pick_tiers`` and the head cell
planes are identical to the JAX package's, so head statistics compare
cell for cell.  The JAX tail is cut into (self block, other block) chunks
for one-hot matrix-unit gathers; a GPU warp reads rows directly, so here
the tail is plain CSR: ``row_ptr`` (n_self+1,) int64, ``other`` (nnz,)
int32 new-space ids and ``x`` (nnz,) ratings, stably sorted by self row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmf_tpu_torch.data.native import radix_argsort
from pmf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TailCSR:
    """One direction of the sparse tail, with the permutations its pass
    needs: tables are permuted into new space by gathering with
    ``*_old_of_new`` or scattering with ``*_new_of_old``, and statistics
    mapped back with ``self_new_of_old``."""

    row_ptr: torch.Tensor  # (n_self + 1,) int64
    other: torch.Tensor  # (nnz,) int32, new-space other ids
    x: torch.Tensor  # (nnz,) ratings
    self_old_of_new: torch.Tensor  # (n_self,) int64
    other_old_of_new: torch.Tensor  # (n_other,) int64
    self_new_of_old: torch.Tensor  # (n_self,) int64
    other_new_of_old: torch.Tensor  # (n_other,) int64
    n_self: int
    n_other: int
    nnz: int
    reordered: bool
    # Rows [0, long_rows) hold every row of at least LONG_ROW edges: the
    # row-group tail kernels (K1, K7, K5, K6) give each of them a whole warp
    # (a schedule; results do not depend on it).
    long_rows: int = 0
    # A band (``band_of``): the CSR holds self rows [row0, row0 + rows) of
    # the n_self rows, its row_ptr rebased to 0 and long_rows counted
    # within it.  A whole direction has row0 = 0 and rows = n_self.
    row0: int = 0

    @property
    def rows(self) -> int:
        """Self rows the CSR holds (n_self for a whole direction)."""
        return self.row_ptr.shape[0] - 1

    def max_row_len(self) -> int:
        if self.rows == 0:
            return 0
        return int((self.row_ptr[1:] - self.row_ptr[:-1]).max())


def band_bounds(row_ptr: np.ndarray, parts: int) -> list:
    """``parts`` contiguous (row_start, row_end) bands of a CSR's rows, cut
    where the edge count reaches k * nnz / parts, so each band holds about
    as many edges (a band of a row longer than nnz / parts holds more)."""
    rp = np.asarray(row_ptr, dtype=np.int64)
    n = rp.shape[0] - 1
    cuts = [0] + [int(np.searchsorted(rp, rp[-1] * k / parts, side="left"))
                  for k in range(1, parts)] + [n]
    cuts = np.minimum(np.maximum.accumulate(cuts), n)
    return [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])]


def band_of(p: TailCSR, r0: int, r1: int) -> TailCSR:
    """Self rows [r0, r1) of a whole direction's CSR as a CSR of its own:
    row_ptr rebased to 0, ``other`` and ``x`` cut to the band (copies, so
    the whole direction can be freed), ``long_rows`` counted within the
    band.  The permutations and sizes stay the direction's."""
    rp = p.row_ptr[r0 : r1 + 1]
    lo, hi = int(rp[0]), int(rp[-1])
    counts = (rp[1:] - rp[:-1]).cpu().numpy()
    return dataclasses.replace(p, row_ptr=(rp - lo).clone(), other=p.other[lo:hi].clone(),
                               x=p.x[lo:hi].clone(), nnz=hi - lo,
                               long_rows=long_rows(counts), row0=p.row0 + r0)


@dataclasses.dataclass(frozen=True)
class DenseHead:
    """Dense cell planes of one staircase tier: new-space user rows
    [row_start, row_start + hu) x item columns [0, hi), columns padded to
    ``hip`` (a multiple of 512).  X = sum of ratings per cell, stored as
    bf16 ``x_hi`` plus a bf16 remainder ``x_lo`` (None when X is
    bf16-exact); M = edge multiplicity per cell (bf16 when every count is
    <= 256, else f32).  Duplicate (u, i) edges are exact: rate is the same
    across duplicates, so sum_e x_e / rate == X / rate.  ``x_sum_user`` /
    ``x_sum_item`` are X's f32 row and column sums (static rating sums
    that the Gaussian bias statistics read)."""

    x_hi: torch.Tensor  # (hu, hip) bfloat16
    x_lo: torch.Tensor | None  # (hu, hip) bfloat16 remainder, or None
    m: torch.Tensor  # (hu, hip) bfloat16 or float32
    x_sum_user: torch.Tensor  # (hu,) float32
    x_sum_item: torch.Tensor  # (hip,) float32
    hu: int
    hi: int
    r0: int
    row_start: int = 0
    _planes: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def hip(self) -> int:
        return self.m.shape[1]

    def m_bf16_planes(self) -> list:
        """M as bf16 planes that sum to it: [m] when M is stored bf16, else
        its top 16 bits and the remainder (exact for counts below 2^16).
        Made at first use and kept with the head: the Gaussian head
        products read them on every pass."""
        if self.m.dtype == torch.bfloat16:
            return [self.m]
        if "m" not in self._planes:
            hi = (self.m.contiguous().view(torch.int32) & -65536).view(torch.float32)
            self._planes["m"] = [hi.to(torch.bfloat16),
                                 (self.m - hi).to(torch.bfloat16)]
        return self._planes["m"]

    def m_bf16_rn(self) -> torch.Tensor:
        """M rounded to nearest bf16 (itself when stored bf16): the one
        plane of the "fast" head products, made at first use and kept."""
        if self.m.dtype == torch.bfloat16:
            return self.m
        if "m_rn" not in self._planes:
            self._planes["m_rn"] = self.m.to(torch.bfloat16)
        return self._planes["m_rn"]


@dataclasses.dataclass(frozen=True)
class BlockedCOO:
    by_user: TailCSR  # user rows -> theta block statistics
    by_item: TailCSR  # item rows -> beta block statistics
    head: tuple | None = None  # DenseHead tiers (disjoint user bands)


def _pick_tiers(
    new_u: np.ndarray,
    new_i: np.ndarray,
    n_users: int,
    n_items: int,
    head_bytes: int,
    cell_bytes: int,
    r0: int,
    min_nnz: int = 4_000_000,
    min_cover: float = 0.02,
    max_tiers: int = 4,
    row_mult: int = 1,
) -> list:
    """Auto staircase sizing: tier 0 covers the top users across all items
    (<= 64k columns); each further tier quarters the item width and spends
    the freed bytes on a 3x-wider band of less-active users.  Returns
    [(row_start, rows, hi), ...] (contiguous user bands from row 0), empty
    when the data is too small or the head would not pay."""
    nnz = len(new_u)
    if nnz < min_nnz:
        return []
    budget_cells = head_bytes // cell_bytes
    hi0 = min(n_items, 65536)
    unit = r0 * max(row_mult, 1)
    hu0 = int(budget_cells / (hi0 * (1 + 0.75 * (max_tiers - 1)))) // unit * unit
    if hu0 < unit:
        hu = min((budget_cells // max(hi0, 1)) // unit * unit,
                 (n_users // unit) * unit)
        tiers = [(0, hu, hi0)] if hu >= unit else []
    else:
        tiers = []
        row, band, hi = 0, hu0, hi0
        for t in range(max_tiers):
            rows = min(band, ((n_users - row) // unit) * unit)
            if rows < unit or hi < 128:
                break
            tiers.append((row, rows, hi))
            row += rows
            band = 3 * hu0 * (4 ** t)
            hi = hi // 4
    kept = []
    for rs, rows, hi in tiers:
        cover = np.count_nonzero(
            (new_u >= rs) & (new_u < rs + rows) & (new_i < hi)
        )
        if cover < min_cover * nnz:
            break
        kept.append((int(rs), int(rows), int(hi)))
    if kept:
        # Extend the last tier through the remaining users as far as the
        # byte budget allows.
        rs, rows, hi = kept[-1]
        hip = -(-hi // 512) * 512
        used = sum(r * (-(-h // 512) * 512) for _, r, h in kept)
        extra = min(
            ((n_users - rs - rows) // unit) * unit,
            max(budget_cells - used, 0) // hip // unit * unit,
        )
        if extra > 0:
            kept[-1] = (rs, rows + int(extra), hi)
    return kept


def _head_cell_index(nu: np.ndarray, ni: np.ndarray, hip: int) -> np.ndarray:
    """Flat cell index of each head edge in the (hu, hip) dense planes."""
    return nu.astype(np.int32) * np.int32(hip) + ni.astype(np.int32)


def _scatter_head(idx: np.ndarray, x: np.ndarray, hu: int, hi: int, r0: int,
                  row_start: int, device) -> DenseHead:
    """Scatter head edges (flat cell index + rating) into the dense planes
    on ``device``: only the edge triples cross to the card, not the cells.
    Duplicate (u, i) pairs sum into X and count into M."""
    hip = -(-hi // 512) * 512
    if hu * hip >= 2**31:
        raise ValueError(
            f"head tier ({hu} x {hip}) exceeds int32 flat-index range "
            f"({hu * hip} cells >= 2^31); shrink head_bytes or the tier"
        )
    idx_t = torch.from_numpy(np.asarray(idx, np.int64)).to(device)
    xs = torch.from_numpy(np.asarray(x, np.float32)).to(device)
    # index_put_ with accumulate sums duplicates in edge order on the card
    # too (a stable sort of the indices, no atomics): a layout rebuilt, or
    # reloaded from the layout cache, equals the first in bits.
    X = torch.zeros(hu * hip, dtype=torch.float32, device=device)
    X.index_put_((idx_t,), xs, accumulate=True)
    M = torch.zeros(hu * hip, dtype=torch.float32, device=device)
    M.index_put_((idx_t,), torch.ones_like(xs), accumulate=True)
    del idx_t, xs
    X = X.view(hu, hip)
    M = M.view(hu, hip)
    x_hi = X.to(torch.bfloat16)
    rem = X - x_hi.float()
    has_rem = bool(torch.any(rem != 0))
    x_lo = rem.to(torch.bfloat16) if has_rem else None
    del rem
    # Multiplicities <= 256 are bf16-exact; beyond that keep f32.
    m_exact = M.numel() == 0 or float(M.max()) <= 256
    head = DenseHead(
        x_hi=x_hi,
        x_lo=x_lo,
        m=M.to(torch.bfloat16) if m_exact else M,
        x_sum_user=X.sum(dim=1),
        x_sum_item=X.sum(dim=0),
        hu=hu,
        hi=hi,
        r0=r0,
        row_start=row_start,
    )
    return head


# Rows this long get a whole warp in the row-group tail kernels (K1, K7,
# K5, K6): a group of lanes walking one alone would set the end of the pass
# (PERF.md, the K1 and K7 findings).
LONG_ROW = 128


def long_rows(counts: np.ndarray, long_row: int = LONG_ROW) -> int:
    """The fewest leading rows that hold every row of at least ``long_row``
    edges."""
    at = np.flatnonzero(counts >= long_row)
    return int(at[-1]) + 1 if at.size else 0


def _tail_host(s: np.ndarray, o: np.ndarray, x: np.ndarray, n_self: int,
               n_other: int, perms: tuple, reordered: bool, dtype):
    """A direction's CSR over self rows as host arrays and sizes (what the
    layout cache stores); edges stable-sorted by self row (the native radix
    sort, numpy without it: the same permutation)."""
    order, counts = radix_argsort(s, n_self)
    row_ptr = np.zeros(n_self + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    host = {"row_ptr": row_ptr, "other": o[order].astype(np.int32),
            "x": np.asarray(x[order], dtype=dtype)}
    for name, p in zip(("self_old_of_new", "other_old_of_new", "self_new_of_old",
                        "other_new_of_old"), perms):
        host[name] = np.asarray(p, np.int64)
    meta = {"n_self": int(n_self), "n_other": int(n_other), "nnz": int(len(s)),
            "reordered": bool(reordered), "long_rows": long_rows(counts)}
    return host, meta


def _tail_from_host(host: dict, meta: dict, device) -> TailCSR:
    return TailCSR(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                      for k, v in host.items()}, **meta)


def _count_perms(ids: np.ndarray, n: int):
    """(old_of_new, new_of_old) for descending-count order (stable)."""
    counts = np.bincount(ids, minlength=n)
    old_of_new = np.argsort(-counts, kind="stable").astype(np.int32)
    new_of_old = np.empty(n, dtype=np.int32)
    new_of_old[old_of_new] = np.arange(n, dtype=np.int32)
    return old_of_new, new_of_old


def build_blocked(
    u, i, x,
    n_users: int | None = None,
    n_items: int | None = None,
    dtype=np.float32,
    reorder: bool = False,
    head=None,
    head_bytes: int = 2 << 30,
    head_r0: int = 512,
    head_row_mult: int = 1,
    device=None,
    cache_dir: str | None = None,
) -> BlockedCOO:
    """``head``: None = all edges in the tail; "auto" = size a dense
    staircase from the data (requires ``reorder``); (hu, hi) = explicit
    head rows/cols (hu a multiple of ``head_r0``); a list of
    (row_start, rows, hi) = explicit tiers.  Edges inside the tiers are
    stored as cell planes and left out of the tail.  ``device`` None =
    the card.  ``cache_dir`` (or ``PMF_TPU_TORCH_LAYOUT_CACHE``): keep the
    layout on disk, keyed by the edges and every geometry argument, and
    reload it, equal in bits, on a repeat build (``data.layout_cache``)."""
    from pmf_tpu_torch.data import layout_cache as lc

    device = resolve_device(device)
    u = np.asarray(u, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    x = np.asarray(x)
    if n_users is None:
        n_users = int(u.max()) + 1
    if n_items is None:
        n_items = int(i.max()) + 1
    if head is not None and not reorder:
        raise ValueError("head requires reorder=True (head = top-count corner)")

    cdir = lc.resolve_cache_dir(cache_dir)
    cpath = None
    if cdir is not None:
        params = dict(n_users=n_users, n_items=n_items, dtype=np.dtype(dtype).str,
                      reorder=reorder, head=repr(head), head_bytes=head_bytes,
                      head_r0=head_r0, head_row_mult=head_row_mult,
                      long_row=LONG_ROW)
        cpath = lc.entry_path(cdir, lc.make_key(lc.data_fingerprint(u, i, x), params))
        hit = lc.load_entry(cpath)
        if hit is not None:
            return lc.unpack(*hit, device)

    if reorder:
        user_old_of_new, user_new_of_old = _count_perms(u, n_users)
        item_old_of_new, item_new_of_old = _count_perms(i, n_items)
    else:
        user_old_of_new = user_new_of_old = np.arange(n_users, dtype=np.int32)
        item_old_of_new = item_new_of_old = np.arange(n_items, dtype=np.int32)
    nu = user_new_of_old[u]
    ni = item_new_of_old[i]

    tiers = []
    r0 = head_r0
    if head is not None:
        x32 = x.astype(np.float32)
        # bf16-exact iff the low 16 mantissa bits of every f32 are zero.
        exact = not bool(np.any(x32.view(np.uint32) & np.uint32(0xFFFF)))
        cell_bytes = 4 if exact else 6  # x_hi + m (+ x_lo)
        if head == "auto":
            tiers = _pick_tiers(nu, ni, n_users, n_items, head_bytes,
                                cell_bytes, r0, row_mult=head_row_mult)
        elif isinstance(head, list):
            tiers = [(int(rs), int(rows), int(hi)) for rs, rows, hi in head]
            spans = sorted((rs, rs + rows) for rs, rows, _ in tiers)
            for (a0, b0), (a1, _) in zip(spans, spans[1:]):
                if a1 < b0:
                    raise ValueError("head tiers must have disjoint user bands")
            for rs, rows, hi in tiers:
                if rows % max(min(r0, rows), 1) or rs + rows > n_users or hi > n_items:
                    raise ValueError(f"head tier ({rs}, {rows}, {hi}) invalid")
        else:
            hu, hi = head
            r0 = min(head_r0, hu) if hu else head_r0
            if hu % max(r0, 1) or hu > n_users or hi > n_items:
                raise ValueError(
                    f"head ({hu}, {hi}) invalid: hu must be a multiple of r0={r0} "
                    f"and within ({n_users}, {n_items})"
                )
            tiers = [(0, hu, hi)] if hu and hi else []

    in_head = np.zeros(len(nu), dtype=bool)
    heads, triples = [], []
    for rs, rows, hi_t in tiers:
        mask = (nu >= rs) & (nu < rs + rows) & (ni < hi_t)
        hip_t = -(-hi_t // 512) * 512
        idx_t = _head_cell_index(nu[mask] - rs, ni[mask], hip_t)
        tier = {"hu": rows, "hi": hi_t, "r0": min(r0, rows), "row_start": rs}
        heads.append(_scatter_head(idx_t, x32[mask], device=device, **tier))
        if cpath is not None:
            triples.append((idx_t, x32[mask], tier))
        in_head |= mask
    if tiers:
        tu, ti, tx = nu[~in_head], ni[~in_head], x[~in_head]
    else:
        tu, ti, tx = nu, ni, x
    tails = {
        "bu": _tail_host(tu, ti, tx, n_users, n_items,
                         (user_old_of_new, item_old_of_new, user_new_of_old,
                          item_new_of_old), reorder, dtype),
        "bi": _tail_host(ti, tu, tx, n_items, n_users,
                         (item_old_of_new, user_old_of_new, item_new_of_old,
                          user_new_of_old), reorder, dtype)}
    if cpath is not None:
        arrays = {}
        lc.save_entry(cpath, arrays, lc.pack(tails, triples, arrays))
    return BlockedCOO(by_user=_tail_from_host(*tails["bu"], device),
                      by_item=_tail_from_host(*tails["bi"], device),
                      head=tuple(heads) if heads else None)
