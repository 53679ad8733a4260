"""Blocked ring sweeps for row-sharded (TP) training: the port's kernels
inside the ring of ``parallel.tp``.

The port of ``pmf_tpu/parallel/tp_blocked.py``.  Row ownership and the
count-balanced deal are the flat ring's.  Within each rank the rows are
relabelled by descending count (``_local_perms``, the reference's local
popularity sort), each rank permutes its own tables into that order before
the ring, so the visiting tables arrive already permuted by their owner,
and the statistics map back after it.

Each (rank, ring step) bucket of a direction is one of the port's CSR
tails (``data.blocked.TailCSR``) in those local coordinates: self rows of
the rank against the visiting shard's rows.  With a head, each bucket also
holds its dense corner (the rank's top rows against the visiting shard's
top rows) as ``data.blocked.DenseHead`` tiers scattered on the device by
``_scatter_head``; the tiers are picked from all edges with the
reference's budget and rules (``head_bytes`` a rank over both directions'
D buckets, ``head_r0``, ``head_min_nnz``, rows a multiple of head_r0 *
dp).  Every bucket is its own launch with its own shape; the tables rotate
in the state's dtype (float32 on the card).  The TPU geometry of the
reference (uniform segment lengths, dummy segments, the segment scan, the
generic segment call, rotated bf16 planes) has no counterpart.

On a ("data", "model") mesh replica p takes band p of each bucket's tail
rows, cut where the edge count reaches nnz / dp, and band p of each
tier's rows; the ring's accumulators are summed over "data" once a pass.

Kernels a ring step: HPF and plain Poisson run K1 "cavi" on the bucket's
tail and K2 on its tiers; extended Poisson runs, in pass 1, K1 "cavi" on
the unscaled visiting factors (the allocation) and on the table pre-scaled
by the scalars (its S_other half is the scalar-weighted rate), with K2 and
the M @ (s * E) head product, and in pass 2 K1 "raw" against the updated
factor rows, whose row sums are the scalar rate, with the head rows'
<theta_new, M @ (s * E)> (``ops.dense_head.ext_head_stats``'s identity);
Gaussian runs K3 on the [m | b | tri(V + m m^T)] records (with the bias
statistics when lagged), K5 for the biases and K6 for diag covariances,
with the row solves local by Cholesky, as the reference (no head, no K4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmf_tpu_torch.data.blocked import (
    LONG_ROW,
    TailCSR,
    _head_cell_index,
    _pick_tiers,
    _scatter_head,
    long_rows,
)
from pmf_tpu_torch.data.native import radix_argsort
from pmf_tpu_torch.ops._tail import new_space_rows, padded_rows, record_rows
from pmf_tpu_torch.parallel.mesh import Mesh, band_csr
from pmf_tpu_torch.parallel.tp import (
    _round_up,
    dp_degree,
    dp_index,
    ring,
    ring_index,
    sum_dp,
    tp_degree,
)


# Edges a piece of a bucket's tail row, at most.  The single-device head
# takes the dense rows out of the tail; a bucket's tiers are smaller (and
# the Gaussian ring has none), so a popular row can keep 10^5 edges there,
# which the tail kernels would walk with one warp.  Cut into pieces, such a
# row is walked by many, and the pieces' sums are added per row after the
# launch.
SPLIT_ROW = 2048


@dataclasses.dataclass(frozen=True)
class TPBlockedBucket:
    """One (rank, ring step) bucket of a direction.  ``tail`` is the CSR of
    its sparse edges over this replica's band of rows (``rows`` real rows
    from ``row0``; the whole shard on a 1-D mesh), each row cut into pieces
    of at most SPLIT_ROW edges: the CSR's rows are the pieces,
    ``piece_row`` the band row of each and ``pieces`` each band row's
    count (both None when no row was cut).  ``head`` are its dense tiers
    (this replica's band of each tier's rows; columns the visiting shard's
    first ``hi`` rows)."""

    tail: TailCSR
    head: tuple
    row0: int
    rows: int
    piece_row: torch.Tensor | None = None
    pieces: torch.Tensor | None = None

    def self_rows(self, tab: torch.Tensor) -> torch.Tensor:
        """The rows of a permuted self table that the tail's pieces read."""
        band = tab[self.row0 : self.row0 + self.rows]
        return band if self.piece_row is None else band.index_select(0, self.piece_row)

    def add(self, acc: torch.Tensor, out: torch.Tensor) -> None:
        """Add a tail launch's per-piece statistics onto ``acc``'s rows."""
        if self.pieces is not None:
            out = torch.segment_reduce(out, "sum", lengths=self.pieces, axis=0)
        _add(acc, out, self.row0)


@dataclasses.dataclass(frozen=True)
class TPBlockedLayout:
    """This rank's blocked buckets (``by_user[s]``, ``by_item[s]``), the
    local popularity permutations of its own rows (``u_old_of_new[n]`` the
    local row at rank n), and its rows' counts and rating sums in local
    (unpermuted) order."""

    by_user: tuple
    by_item: tuple
    u_old_of_new: torch.Tensor
    u_new_of_old: torch.Tensor
    i_old_of_new: torch.Tensor
    i_new_of_old: torch.Tensor
    user_counts: torch.Tensor
    item_counts: torch.Tensor
    x_sum_user: torch.Tensor
    x_sum_item: torch.Tensor
    n_users: int
    n_items: int
    n_users_pad: int
    n_items_pad: int
    users_per: int
    items_per: int
    n_devices: int
    nnz: int
    tiers_user: tuple = ()
    tiers_item: tuple = ()

    @property
    def n_buckets(self) -> int:
        return len(self.by_user) + len(self.by_item)


def _local_perms(ids: np.ndarray, per: int, D: int):
    """Each shard's local popularity permutations: its ``per`` rows sorted
    by descending global count (stable).  (old_of_new, new_of_old), both
    (D, per) int64."""
    counts = np.bincount(ids, minlength=per * D).reshape(D, per)
    old_of_new = np.argsort(-counts, axis=1, kind="stable").astype(np.int64)
    new_of_old = np.empty_like(old_of_new)
    rng = np.arange(per, dtype=np.int64)
    for d in range(D):
        new_of_old[d, old_of_new[d]] = rng
    return old_of_new, new_of_old


def _csr(s: np.ndarray, o: np.ndarray, x: np.ndarray, n_self: int, n_other: int,
         dtype, device) -> TailCSR:
    """A bucket's CSR over ``n_self`` local rows (edges stable-sorted by
    self row); no permutations of its own."""
    order, counts = radix_argsort(s, n_self)
    row_ptr = np.zeros(n_self + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    none = torch.empty(0, dtype=torch.int64, device=device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TailCSR(row_ptr=t(row_ptr), other=t(o[order].astype(np.int32)),
                   x=t(np.asarray(x[order], dtype=dtype)), self_old_of_new=none,
                   other_old_of_new=none, self_new_of_old=none, other_new_of_old=none,
                   n_self=int(n_self), n_other=int(n_other), nnz=int(len(s)),
                   reordered=False, long_rows=long_rows(counts))


def _bucket(p: TailCSR, head: tuple, split_row: int) -> TPBlockedBucket:
    """A bucket over ``p`` (a band of rows), its rows cut into pieces of at
    most ``split_row`` edges."""
    rp = p.row_ptr.cpu().numpy()
    counts = np.diff(rp)
    n_pieces = np.maximum(-(-counts // split_row), 1)
    if (n_pieces == 1).all():
        return TPBlockedBucket(dataclasses.replace(p, row0=0, n_self=p.rows), head,
                               p.row0, p.rows)
    rows = p.rows
    piece_row = np.repeat(np.arange(rows), n_pieces)
    first = np.cumsum(n_pieces) - n_pieces
    starts = rp[piece_row] + (np.arange(len(piece_row)) - first[piece_row]) * split_row
    piece_ptr = np.append(starts, rp[-1])
    dev = p.row_ptr.device
    tail = dataclasses.replace(
        p, row_ptr=torch.from_numpy(piece_ptr).to(dev), n_self=len(piece_row),
        long_rows=long_rows(np.diff(piece_ptr)), row0=0)
    return TPBlockedBucket(tail, head, p.row0, rows,
                           torch.from_numpy(piece_row).to(dev),
                           torch.from_numpy(n_pieces).to(dev))


def _tiers(head, s_loc, o_loc, x, s_per, o_per, D, dp, head_bytes, head_r0,
           head_min_nnz) -> tuple:
    """A direction's head tiers [(row_start, rows, hi)] in shard-local rows,
    the reference's rules: explicit tiers are checked (rows a multiple of
    head_r0 * dp, inside the shard, disjoint); "auto" picks a staircase from
    every bucket's (self rank, other rank) profile with ``head_bytes`` a
    rank over both directions' D buckets."""
    if head is None:
        return ()
    if isinstance(head, (list, tuple)):
        tiers = [(int(rs), int(rows), int(hi)) for rs, rows, hi in head]
        unit = head_r0 * max(dp, 1)
        for rs, rows, hi in tiers:
            if rows % unit or rs + rows > s_per or hi > o_per or hi < 1:
                raise ValueError(f"TP head tier ({rs}, {rows}, {hi}) invalid for "
                                 f"shard shape ({s_per} x {o_per}), unit {unit}")
        spans = sorted((rs, rs + rows, hi) for rs, rows, hi in tiers)
        for (a0, a1, ah), (b0, b1, bh) in zip(spans, spans[1:]):
            if b0 < a1:
                raise ValueError(
                    f"TP head tiers overlap: rows [{a0},{a1}) x hi<{ah} and "
                    f"[{b0},{b1}) x hi<{bh} share edges; tiers must cover disjoint "
                    "row ranges")
        return tuple(tiers)
    if head != "auto":
        raise ValueError(f"head must be None, 'auto' or a tier list, got {head!r}")
    x32 = np.asarray(x, np.float32)
    exact = not bool(np.any(x32.view(np.uint32) & np.uint32(0xFFFF)))
    return tuple(_pick_tiers(s_loc, o_loc, s_per, o_per, head_bytes // (2 * D),
                             4 if exact else 6, head_r0, min_nnz=head_min_nnz,
                             row_mult=dp))


def _build_dir(s_glob, o_glob, x, s_per, o_per, D, d, dp, p, s_n2o, o_n2o, tiers,
               head_r0, dtype, device, split_row, triples=None) -> tuple:
    """Rank d's D buckets of one direction: the tiers' cells of each
    bucket (replica p's band of rows) scattered into dense tiers, the rest
    of the bucket's edges as its CSR tail (replica p's band).  ``triples``
    (a list, for the layout cache): each bucket's tiers as their scatter
    triples (idx, x, tier arguments) are appended to it."""
    own = s_glob // s_per == d
    s_glob, o_glob, x = s_glob[own], o_glob[own], np.asarray(x)[own]
    v = o_glob // o_per
    step = (v - d) % D
    s_loc = s_n2o[d, s_glob % s_per]
    o_loc = o_n2o[v, o_glob % o_per]
    x32 = x.astype(np.float32)
    tail = np.ones(len(s_loc), dtype=bool)
    heads = [[] for _ in range(D)]
    kept = [[] for _ in range(D)]
    for rs, rows, hi in tiers:
        hip = -(-hi // 512) * 512
        hu_r = rows // dp
        band0 = rs + p * hu_r
        sel = tail & (s_loc >= rs) & (s_loc < rs + rows) & (o_loc < hi)
        tail &= ~sel
        mine = sel & (s_loc >= band0) & (s_loc < band0 + hu_r)
        tier = {"hu": hu_r, "hi": hi, "r0": min(head_r0, hu_r), "row_start": band0}
        for st in range(D):
            m = mine & (step == st)
            idx = _head_cell_index(s_loc[m] - band0, o_loc[m], hip)
            heads[st].append(_scatter_head(idx, x32[m], device=device, **tier))
            if triples is not None:
                kept[st].append((idx, x32[m], tier))
    if triples is not None:
        triples.extend(kept)
    out = []
    for st in range(D):
        m = tail & (step == st)
        csr = _csr(s_loc[m], o_loc[m], x[m], s_per, o_per, dtype, device)
        if dp > 1:
            csr = band_csr(csr, p, dp)
        out.append(_bucket(csr, tuple(heads[st]), split_row))
    return tuple(out)


def build_tp_blocked(u, i, x, n_users: int, n_items: int, mesh: Mesh,
                     dtype=np.float32, head=None, head_bytes: int = 2 << 30,
                     head_r0: int = 512, head_min_nnz: int = 4_000_000,
                     split_row: int = SPLIT_ROW,
                     cache_dir: str | None = None) -> TPBlockedLayout:
    """This rank's share of the blocked dual bucket layout, on the mesh's
    device; every rank calls it with the same edges (ids already balanced).
    ``head``: None = tails only; "auto" = a staircase per direction sized
    from the bucket-local edge profile (``data.blocked._pick_tiers`` on the
    shard-local shape, ``head_bytes`` a rank over both directions' D
    buckets); a list of (row_start, rows, hi) = explicit tiers for both
    directions in shard-local rows, each ``rows`` a multiple of
    ``head_r0 * dp``.  ``split_row``: the most edges a piece of a tail
    row holds (``TPBlockedBucket``).  ``cache_dir`` (or
    ``PMF_TPU_TORCH_LAYOUT_CACHE``): keep this rank's share on disk, keyed
    by the edges, every argument and the rank's coordinates, and reload it
    equal in bits on a repeat build (``data.layout_cache.pack_tp``)."""
    from pmf_tpu_torch.data import layout_cache as lc

    u = np.asarray(u, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    x = np.asarray(x, dtype=dtype)
    D, dp, d, p = tp_degree(mesh), dp_degree(mesh), ring_index(mesh), dp_index(mesh)
    users_per = _round_up(n_users, D) // D
    items_per = _round_up(n_items, D) // D
    dev = mesh.device
    cdir = lc.resolve_cache_dir(cache_dir)
    cpath = None
    triples = {"bu": None, "bi": None}
    if cdir is not None:
        params = dict(n_users=n_users, n_items=n_items, D=D, dp=dp, ring=d, replica=p,
                      dtype=np.dtype(dtype).str, head=repr(head), head_bytes=head_bytes,
                      head_r0=head_r0, head_min_nnz=head_min_nnz, split_row=split_row,
                      long_row=LONG_ROW)
        key = lc.make_key(lc.data_fingerprint(u, i, x), params, kind=lc.TP_KIND,
                          code=lc.tp_code_fingerprint())
        cpath = lc.entry_path(cdir, key, kind=lc.TP_KIND)
        hit = lc.load_entry(cpath)
        if hit is not None:
            return lc.unpack_tp(*hit, dev)
        triples = {"bu": [], "bi": []}
    u_o2n, u_n2o = _local_perms(u, users_per, D)
    i_o2n, i_n2o = _local_perms(i, items_per, D)
    u_loc = u_n2o[u // users_per, u % users_per]
    i_loc = i_n2o[i // items_per, i % items_per]
    knobs = (D, dp, head_bytes, head_r0, head_min_nnz)
    tiers_u = _tiers(head, u_loc, i_loc, x, users_per, items_per, *knobs)
    tiers_i = _tiers(head, i_loc, u_loc, x, items_per, users_per, *knobs)
    by_user = _build_dir(u, i, x, users_per, items_per, D, d, dp, p, u_n2o, i_n2o,
                         tiers_u, head_r0, dtype, dev, split_row, triples["bu"])
    by_item = _build_dir(i, u, x, items_per, users_per, D, d, dp, p, i_n2o, u_n2o,
                         tiers_i, head_r0, dtype, dev, split_row, triples["bi"])
    own_u = slice(d * users_per, (d + 1) * users_per)
    own_i = slice(d * items_per, (d + 1) * items_per)
    x64 = np.asarray(x, np.float64)

    def t(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a if dt is None else a.astype(dt))
                                ).to(dev)

    layout = TPBlockedLayout(
        by_user=by_user, by_item=by_item,
        u_old_of_new=t(u_o2n[d]), u_new_of_old=t(u_n2o[d]),
        i_old_of_new=t(i_o2n[d]), i_new_of_old=t(i_n2o[d]),
        user_counts=t(np.bincount(u, minlength=users_per * D)[own_u], dtype),
        item_counts=t(np.bincount(i, minlength=items_per * D)[own_i], dtype),
        x_sum_user=t(np.bincount(u, weights=x64, minlength=users_per * D)[own_u], dtype),
        x_sum_item=t(np.bincount(i, weights=x64, minlength=items_per * D)[own_i], dtype),
        n_users=n_users, n_items=n_items, n_users_pad=users_per * D,
        n_items_pad=items_per * D, users_per=users_per, items_per=items_per,
        n_devices=D, nnz=int(len(u)), tiers_user=tiers_u, tiers_item=tiers_i)
    if cpath is not None:
        arrays = {}
        lc.save_entry(cpath, arrays, lc.pack_tp(layout, triples, arrays))
    return layout


# -------------------------------------------------------------- passes --

def _add(acc: torch.Tensor, out: torch.Tensor, row0: int) -> None:
    """acc[row0 : row0 + rows] += out (a band's or a tier's rows)."""
    acc[row0 : row0 + out.shape[0]] += out.to(acc.dtype)


def _tier_cols(tab: torch.Tensor, tier, K: int) -> torch.Tensor:
    """The visiting shard's first ``hi`` rows (K columns), zero-padded to
    the tier's ``hip``: the tier's columns."""
    t = tab[: tier.hi, :K]
    return torch.nn.functional.pad(t, (0, 0, 0, tier.hip - t.shape[0]))


def _tier_rows(tab: torch.Tensor, tier, K: int) -> torch.Tensor:
    return tab[tier.row_start : tier.row_start + tier.hu, :K].contiguous()


def _cavi_pass(buckets, t_self, t_other, K: int, rate_floor: float, precision: str,
               mesh: Mesh) -> torch.Tensor:
    """One HPF / plain Poisson ring pass over permuted tables padded to
    ``tail_stride(K)``: K1 on each bucket's tail, K2 on its tiers.  Returns
    [S_alloc | S_other] (self_per, 2K) in permuted order, summed over the
    data axis."""
    from pmf_tpu_torch.ops.cavi_edge import tail_edge_stats
    from pmf_tpu_torch.ops.dense_head import poisson_head_stats

    acc = t_self.new_zeros((t_self.shape[0], 2 * K))

    def body(s, tabs):
        (T,) = tabs
        b = buckets[s]
        p = b.tail
        b.add(acc, tail_edge_stats(b.self_rows(t_self), T, p.row_ptr, p.other, p.x,
                                   rate_floor, K=K, long_rows=p.long_rows))
        for tier in b.head:
            sa, so = poisson_head_stats(_tier_rows(t_self, tier, K),
                                        _tier_cols(T, tier, K), tier, rate_floor,
                                        precision)
            _add(acc, torch.cat([sa, so], dim=1), tier.row_start)

    ring([t_other], body, mesh)
    (acc,) = sum_dp(mesh, acc)
    return acc


def _poisson_block(E_self, E_other, buckets, self_perm, other_perm, K, rate_floor,
                   precision, mesh):
    """(S_alloc, S_other) in the rank's own row order, state dtype."""
    t_self = new_space_rows(E_self, self_perm)
    t_other = new_space_rows(E_other, other_perm)
    acc = _cavi_pass(buckets, t_self, t_other, K, rate_floor, precision, mesh)
    acc = acc[self_perm].to(E_self.dtype)
    return acc[:, :K], acc[:, K:]


def tp_sweep_hpf_blocked(state: dict, layout: TPBlockedLayout, a, a_prime, b_prime,
                         c, c_prime, d_prime, *, mesh: Mesh,
                         precision: str = "high") -> dict:
    """One HPF CAVI iteration, row-sharded, with K1 and K2 inside the ring,
    in the reference's theta -> xi -> beta -> eta order; the same fixed
    point as ``parallel.tp.tp_sweep_hpf`` to kernel rounding."""
    from pmf_tpu_torch.models.hpf import RATE_FLOOR, _expectations, _factor_update

    K = state["a_theta"].shape[1]
    E_theta, E_beta, E_xi, E_eta = _expectations(state, a, a_prime, c, c_prime)
    lo = layout
    s_alloc, s_other = _poisson_block(E_theta, E_beta, lo.by_user, lo.u_new_of_old,
                                      lo.i_new_of_old, K, RATE_FLOOR, precision, mesh)
    a_t, b_t = _factor_update(s_alloc, s_other, E_xi, lo.user_counts, a)
    E_theta = a_t / b_t
    b_xi = b_prime + torch.sum(E_theta, dim=1)
    s_alloc, s_other = _poisson_block(E_beta, E_theta, lo.by_item, lo.i_new_of_old,
                                      lo.u_new_of_old, K, RATE_FLOOR, precision, mesh)
    a_b, b_b = _factor_update(s_alloc, s_other, E_eta, lo.item_counts, c)
    E_beta = a_b / b_b
    b_eta = d_prime + torch.sum(E_beta, dim=1)
    return {"a_theta": a_t, "b_theta": b_t, "a_beta": a_b, "b_beta": b_b,
            "b_xi": b_xi, "b_eta": b_eta}


def tp_sweep_poisson_blocked(state: dict, layout: TPBlockedLayout, a0, b0, *,
                             mesh: Mesh, precision: str = "high") -> dict:
    """One plain Poisson-MF CAVI iteration, row-sharded, K1 and K2 inside
    the ring: user block, refresh, item block."""
    from pmf_tpu_torch.models.poisson_mf import RATE_FLOOR, _prior_where

    K = state["a_theta"].shape[1]
    lo = layout
    E_theta = state["a_theta"] / state["b_theta"]
    E_beta = state["a_beta"] / state["b_beta"]

    def block(E_self, E_other, buckets, self_perm, other_perm, counts):
        s_alloc, s_other = _poisson_block(E_self, E_other, buckets, self_perm,
                                          other_perm, K, RATE_FLOOR, precision, mesh)
        has = (counts > 0)[:, None]
        return _prior_where(has, s_alloc, a0), _prior_where(has, s_other, b0)

    a_t, b_t = block(E_theta, E_beta, lo.by_user, lo.u_new_of_old, lo.i_new_of_old,
                     lo.user_counts)
    E_theta = a_t / b_t
    a_b, b_b = block(E_beta, E_theta, lo.by_item, lo.i_new_of_old, lo.u_new_of_old,
                     lo.item_counts)
    return {"a_theta": a_t, "b_theta": b_t, "a_beta": a_b, "b_beta": b_b}


def tp_sweep_poisson_ext_blocked(state: dict, layout: TPBlockedLayout, a0, b0, *,
                                 mesh: Mesh, precision: str = "high") -> dict:
    """One extended Poisson-MF CAVI iteration, row-sharded, in the
    reference's two-ring form a side.  The rotating table is the owner's
    [E | s] record (``_tail.record_rows``).  Pass 1: K1 "cavi" on the
    unscaled factors gives the allocation, K1 "cavi" on the scalar-scaled
    table its S_other half, the scalar-weighted rate; the tiers add K2's
    allocation and M @ (s * E).  Pass 2, against the updated factor rows:
    K1 "raw" on the scaled table, whose row sums are sum_e s_e <e_new,
    e_o>, and the tiers' e_new * (M @ (s * E)).  The scalar's shape uses
    the layout's per-row rating sums."""
    from pmf_tpu_torch.models.poisson_mf import RATE_FLOOR, _prior_where
    from pmf_tpu_torch.ops.cavi_edge import tail_edge_stats
    from pmf_tpu_torch.ops.dense_head import head_products, poisson_head_stats

    K = state["a_theta"].shape[1]
    lo = layout

    def scaled(T):
        return padded_rows(T[:, K : K + 1] * T[:, :K])

    def ext_block(E_self, E_other, s_other, buckets, self_perm, other_perm, counts, sx):
        t_self = new_space_rows(E_self, self_perm)
        records = record_rows(E_other, s_other, other_perm)
        acc = t_self.new_zeros((t_self.shape[0], 2 * K))  # [S_alloc | S_wother]

        def body1(s, tabs):
            (T,) = tabs
            b = buckets[s]
            p = b.tail
            band = b.self_rows(t_self)
            sT = scaled(T)
            alloc = tail_edge_stats(band, padded_rows(T[:, :K]), p.row_ptr, p.other, p.x,
                                    RATE_FLOOR, K=K, long_rows=p.long_rows)
            wother = tail_edge_stats(band, sT, p.row_ptr, p.other, p.x, RATE_FLOOR,
                                     K=K, long_rows=p.long_rows)
            b.add(acc, torch.cat([alloc[:, :K], wother[:, K:]], dim=1))
            for tier in b.head:
                sa, _ = poisson_head_stats(_tier_rows(t_self, tier, K),
                                           _tier_cols(T, tier, K), tier, RATE_FLOOR,
                                           precision)
                sw, _ = head_products(tier, _tier_cols(sT, tier, K), None, precision)
                _add(acc, torch.cat([sa, sw.to(sa.dtype)], dim=1), tier.row_start)

        ring([records], body1, mesh)
        (acc,) = sum_dp(mesh, acc)
        acc = acc[self_perm].to(E_self.dtype)
        has = (counts > 0)[:, None]
        a_fac = _prior_where(has, acc[:, :K], a0)
        b_fac = _prior_where(has, acc[:, K:], b0)

        t_new = new_space_rows(a_fac / b_fac, self_perm)
        acc2 = t_new.new_zeros((t_new.shape[0], K))

        def body2(s, tabs):
            (T,) = tabs
            b = buckets[s]
            p = b.tail
            sT = scaled(T)
            raw = tail_edge_stats(b.self_rows(t_new), sT, p.row_ptr, p.other, None,
                                  mode="raw", K=K, long_rows=p.long_rows)
            b.add(acc2, raw[:, :K])
            for tier in b.head:
                sw, _ = head_products(tier, _tier_cols(sT, tier, K), None, precision)
                _add(acc2, _tier_rows(t_new, tier, K) * sw.to(t_new.dtype),
                     tier.row_start)

        ring([records], body2, mesh)
        (acc2,) = sum_dp(mesh, acc2)
        s_sdot = torch.sum(acc2, dim=1)[self_perm].to(E_self.dtype)
        has1 = counts > 0
        return (a_fac, b_fac, _prior_where(has1, sx, a0),
                _prior_where(has1, s_sdot, b0))

    E_theta = state["a_theta"] / state["b_theta"]
    E_beta = state["a_beta"] / state["b_beta"]
    E_psi = state["a_psi"] / state["b_psi"]
    a_t, b_t, a_phi, b_phi = ext_block(E_theta, E_beta, E_psi, lo.by_user,
                                       lo.u_new_of_old, lo.i_new_of_old,
                                       lo.user_counts, lo.x_sum_user)
    E_theta = a_t / b_t
    E_phi = a_phi / b_phi
    a_b, b_b, a_psi, b_psi = ext_block(E_beta, E_theta, E_phi, lo.by_item,
                                       lo.i_new_of_old, lo.u_new_of_old,
                                       lo.item_counts, lo.x_sum_item)
    return {"a_theta": a_t, "b_theta": b_t, "a_beta": a_b, "b_beta": b_b,
            "a_phi": a_phi, "b_phi": b_phi, "a_psi": a_psi, "b_psi": b_psi}


def _pass(buckets, tables, width, launch, n_self, like, mesh):
    """One ring pass of a pass-through Gaussian kernel: ``launch(bucket,
    tables)`` gives the (pieces, width) statistics of a bucket's tail.
    Returns the (n_self, width) accumulator in permuted order, summed over
    "data"."""
    acc = like.new_zeros((n_self, width))

    def body(s, tabs):
        b = buckets[s]
        b.add(acc, launch(b, tabs))

    ring(tables, body, mesh)
    (acc,) = sum_dp(mesh, acc)
    return acc


def tp_sweep_gaussian_blocked(state: dict, layout: TPBlockedLayout, sigma2,
                              eta_theta2, eta_beta2, eta_bias2, *, use_bias: bool,
                              covariance: str, mesh: Mesh, precision: str = "high",
                              bias_update: str = "exact") -> dict:
    """One Gaussian CAVI iteration, row-sharded, with the Gaussian tail
    kernels inside the rings, in the reference's block order theta -> beta
    -> b_user -> b_item (``bias_update="lagged"``: theta -> b_user -> beta
    -> b_item, the bias statistics taken by K3 on the factor passes, 2 ring
    passes an iteration).  The factor pass rotates K3's [m | b | tri(V +
    m m^T)] records (``ops.gaussian_edge.factor_table``), the diag pass the
    [m | b] records and v + m^2, the bias pass the [m | b] records; every
    per-self-row term and the row solves (batched Cholesky) apply locally
    after the ring.  ``precision`` is accepted for the engines' names: the
    layout has no head, and the tail kernels run in float32."""
    if any(b.head for b in layout.by_user + layout.by_item):
        raise ValueError("the Gaussian TP blocked ring does not consume a dense head; "
                         "build the TP layout with head=None for this family")
    if bias_update not in ("exact", "lagged"):
        raise ValueError(f"unknown bias_update {bias_update!r}")
    full = covariance == "full"
    lagged = use_bias and bias_update == "lagged"
    if lagged and not full:
        raise ValueError("bias_update='lagged' requires covariance='full' in the TP "
                         "blocked engine (the diag kernel carries no bias-stat payload)")
    from pmf_tpu_torch.models.gaussian_mf import (
        _bias_block_lagged, _bias_update, _finish_diag, _finish_factor)
    from pmf_tpu_torch.ops.gaussian_edge import (
        bias_tail_stats, diag_tail_stats, factor_table, factor_tail_of, tri_size,
        unpack_tri)
    from pmf_tpu_torch.ops.solve import batched_psd_inverse

    lo = layout
    m_t, V_t = state["m_theta"], state["V_theta"]
    m_b, V_b = state["m_beta"], state["V_beta"]
    b_u, b_i = state["b_user"], state["b_item"]
    K = m_t.shape[1]
    T = tri_size(K)

    def bias_col(b):
        return b if use_bias else torch.zeros_like(b)

    def factor_block(m_self, V_self, m_other, V_other, b_self, b_other, buckets,
                     self_perm, other_perm, other_o2n, counts, eta2):
        n_self = m_self.shape[0]
        if not full:
            mb_s = record_rows(m_self, bias_col(b_self), self_perm)
            tabs = [record_rows(m_other, bias_col(b_other), other_perm),
                    new_space_rows(torch.addcmul(V_other, m_other, m_other), other_perm)]
            acc = _pass(buckets, tabs, 3 * K, lambda b, t: diag_tail_stats(
                b.self_rows(mb_s), t[0], t[1], b.tail.row_ptr, b.tail.other, b.tail.x,
                K=K, long_rows=b.tail.long_rows), n_self, m_self, mesh)
            out = acc[self_perm].to(m_self.dtype)
            return _finish_diag(m_self, V_self, out[:, :K], out[:, K : 2 * K],
                                out[:, 2 * K :], counts, eta2, sigma2), None
        A_flat = (V_other + m_other[:, :, None] * m_other[:, None, :]).reshape(-1, K * K)
        aug = factor_table(m_other, bias_col(b_other), A_flat, other_o2n)
        acc = _pass(buckets, [aug], 2 * K + T + (2 if lagged else 0),
                    lambda b, t: factor_tail_of(t[0], b.tail, K, lagged),
                    n_self, m_self, mesh)
        out = acc[self_perm].to(m_self.dtype)
        S_w, S_m = out[:, :K], out[:, K : 2 * K]
        if use_bias:
            S_w = S_w - b_self[:, None] * S_m
        m_new, V_new = _finish_factor(m_self, V_self, S_w, unpack_tri(out[:, 2 * K :
                                                                          2 * K + T], K),
                                      counts, eta2, sigma2, batched_psd_inverse)
        lag = (S_m, out[:, 2 * K + T], out[:, 2 * K + T + 1]) if lagged else None
        return (m_new, V_new), lag

    def bias_block(b_self, b_other, m_self, m_other, buckets, self_perm, other_perm,
                   counts):
        mb = record_rows(m_other, b_other, other_perm)
        acc = _pass(buckets, [mb], K + 2, lambda b, t: bias_tail_stats(
            t[0], b.tail.row_ptr, b.tail.other, b.tail.x, K=K,
            long_rows=b.tail.long_rows), m_self.shape[0], m_self, mesh)
        out = acc[self_perm].to(m_self.dtype)
        s = out[:, K + 1] - out[:, K] - torch.sum(m_self * out[:, :K], dim=1)
        return _bias_update(b_self, s, counts, eta_bias2, sigma2)

    (m_t, V_t), lag = factor_block(m_t, V_t, m_b, V_b, b_u, b_i, lo.by_user,
                                   lo.u_new_of_old, lo.i_new_of_old, lo.i_old_of_new,
                                   lo.user_counts, eta_theta2)
    if lagged:
        b_u = _bias_block_lagged(b_u, m_t, *lag, lo.user_counts, eta_bias2, sigma2)
    (m_b, V_b), lag = factor_block(m_b, V_b, m_t, V_t, b_i, b_u, lo.by_item,
                                   lo.i_new_of_old, lo.u_new_of_old, lo.u_old_of_new,
                                   lo.item_counts, eta_beta2)
    if lagged:
        b_i = _bias_block_lagged(b_i, m_b, *lag, lo.item_counts, eta_bias2, sigma2)
    elif use_bias:
        b_u = bias_block(b_u, b_i, m_t, m_b, lo.by_user, lo.u_new_of_old,
                         lo.i_new_of_old, lo.user_counts)
        b_i = bias_block(b_i, b_u, m_b, m_t, lo.by_item, lo.i_new_of_old,
                         lo.u_new_of_old, lo.item_counts)
    return {"m_theta": m_t, "V_theta": V_t, "m_beta": m_b, "V_beta": V_b,
            "b_user": b_u, "b_item": b_i}
