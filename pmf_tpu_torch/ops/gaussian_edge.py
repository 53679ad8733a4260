"""Gaussian CAVI edge passes over the hybrid layout.

The Gaussian coordinate blocks need, per self row, sums over its edges
of other-row quantities (``pmf_tpu/ops/pallas/gaussian_edge.py``):

    factor pass (K3)  [sum m_o (x - b_o) | sum m_o | sum triu(V_o + m_o m_o^T)
                       (| sum x | sum b_o)]
    bias pass (K5)    [sum m_o | sum b_o | sum x]
    diag pass (K6)    [sum m_o (resid - <m_s, m_o>) | sum (v_o + m_o^2) | sum m_o^2]

``gaussian_{factor,bias,diag}_stats`` have the JAX functions' call shapes
and return the statistics in the original row order.  Each permutes its
other-row table into count-reordered space, runs its tail kernel over the
direction's CSR tail, adds each dense head tier's linear products
(``ops.dense_head.head_products{,_t}``) onto the same columns, and maps
the result back.  The second moment is symmetric, so only its K(K+1)/2
upper triangle rides the pass (``pack_tri`` / ``unpack_tri``).  Their
``precision`` ("fast" or "high") sets the head products' bf16 parts
only: K3, K5 and K6 run in float32 at every precision (they gather
padded float32 records from L2; fewer parts would save them nothing).

``factor_tail_stats``, ``bias_tail_stats`` and ``diag_tail_stats`` wrap
the kernels of ``csrc/gaussian_edge.cu``: on CUDA tensors they launch (or
raise), on CPU tensors they run their ``*_plain`` versions.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from pmf_tpu_torch.data.blocked import TailCSR
from pmf_tpu_torch.ops import _build
from pmf_tpu_torch.ops._tail import (
    add_heads as _add_heads,
    band_rows,
    check_head as _check_head,
    check_long_rows as _check_long_rows,
    check_padded_tables as _check_padded_tables,
    check_tail_args as _check_tail_args,
    edges as _edges,
    head_rows as _head_rows,
    padded_rows as _padded_rows,
    products as _products,
    record_rows as record_table,
    row_chunks as _row_chunks,
    scattered_rows as _scattered_rows,
    tail_windows,
    unband,
    window_args,
)

FACTOR_LAUNCHES = _build.LaunchCounter()
BIAS_LAUNCHES = _build.LaunchCounter()
DIAG_LAUNCHES = _build.LaunchCounter()
# Past K = 30 the factor pass cuts its K + 1 + K(K+1)/2 record floats into
# chunks of 512 on grid.y; past K = 128 one of two wide forms walks them
# (factor_plan, csrc/gaussian_edge.cu's host plan block: change them
# together).  The bias and diag passes are row-group kernels
# (csrc/tail_groups.cuh).
FACTOR_WHOLE_RECORD_MAX_K = 30  # csrc/gaussian_edge.cu: kWholeRecordMaxK
FACTOR_CHUNK = 512  # record floats a chunk past it (kChunkNV float4 loads a lane)
FACTOR_NARROW_MAX_K = 128  # kNarrowMaxK: the factors in the chunk's first load
FACTOR_EDGES = 4  # kEdges: edges in flight a warp to K = 128
FACTOR_SLAB_MAX_CHUNK = 512  # kSlabMaxChunk: the slab form's widest chunk
FACTOR_SLAB_MIN_CHUNK = 64  # kSlabMinChunk: and its narrowest (8 sectors)
FACTOR_SLAB_L2_DIV = 1  # kSlabL2Div: the column slab fills at most the L2
FACTOR_SLAB_NV = 4  # kSlabNV: float4s a lane a record chunk (chunk / 16 lanes a row)
FACTOR_SLAB_EDGES = 2  # kSlabEdges: edges in flight a row
FACTOR_GROUP_ROWS = 32  # kGroupRows: self rows a CTA of the group form
FACTOR_GROUP_CHUNK = 128  # kGroupChunk: record floats a chunk there
FACTOR_GROUP_SLOTS = 64  # kGroupSlots: other records a window of shared memory
FACTOR_GROUP_EDGES = 4  # kGroupEdges: edges in flight a warp there
FACTOR_GROUP_STAGES = 2  # kGroupStages: windows in the shared-memory ring
FACTOR_GROUP_CTAS = 3  # kGroupCtas: CTAs an SM, the launch bound
FACTOR_GROUP_MIN_REUSE_X4 = 8  # kGroupMinReuseX4: the group form from 2 edges a pair
# The L2 of an H100 (torch.cuda.get_device_properties().L2_cache_size),
# the plan's default where no card is asked.
H100_L2_BYTES = 50 * 1024 * 1024
FACTOR_FORMS = ("whole", "chunked", "slab", "group")  # the C enum FactorForm


def tri_size(k: int) -> int:
    return k * (k + 1) // 2


@functools.lru_cache(maxsize=None)
def _tri_indices(k: int, device: torch.device):
    """(flat upper-triangle indices into K*K, and the K*K -> tri map) on
    ``device``, made once: a copy from host memory to the card waits for
    the card, so it must not happen on every pass."""
    flat, full = [], [0] * (k * k)
    t = 0
    for a in range(k):
        for b in range(a, k):
            full[a * k + b] = full[b * k + a] = t
            flat.append(a * k + b)
            t += 1
    return (torch.tensor(flat, device=device), torch.tensor(full, device=device))


def pack_tri(A_flat: torch.Tensor, k: int) -> torch.Tensor:
    """(R, K*K) symmetric rows -> (R, K(K+1)/2) upper-triangle columns."""
    flat, _ = _tri_indices(k, A_flat.device)
    return A_flat.index_select(1, flat)


def unpack_tri(S_tri: torch.Tensor, k: int) -> torch.Tensor:
    """(R, K(K+1)/2) -> full symmetric (R, K, K)."""
    _, full = _tri_indices(k, S_tri.device)
    return S_tri.index_select(1, full).reshape(-1, k, k)


# ------------------------------------------------------------------ K3 --

def factor_stride(k: int) -> int:
    """K3's record width in the table: K + 1 + K(K+1)/2 floats rounded up
    to 4, so that every record starts on 16 bytes (the kernel's float4
    loads); the plain version ignores the pad columns."""
    return -(-(k + 1 + tri_size(k)) // 4) * 4


def factor_boundary_ks() -> list:
    """The first K of each form of K3: the whole record in a warp's loads,
    chunks of FACTOR_CHUNK floats on grid.y, the wide forms (``factor_plan``:
    their chunk and form follow the data, not K), and b_o past the first
    chunk of the slab form's widest (K + 1 > FACTOR_SLAB_MAX_CHUNK).  The
    tests and chip_smoke.py hold K3 on both sides of each."""
    return [1, FACTOR_WHOLE_RECORD_MAX_K + 1, FACTOR_NARROW_MAX_K + 1,
            FACTOR_SLAB_MAX_CHUNK]


def factor_plan(k: int, n_other: int, nnz: int = 0, pairs: int = 0,
                l2_bytes: int = H100_L2_BYTES) -> dict:
    """K3's form and geometry (``csrc/gaussian_edge.cu``'s ``factor_plan``)
    for ``k`` factors over a table of ``n_other`` records and a CSR of
    ``nnz`` edges with ``pairs`` distinct (group of FACTOR_GROUP_ROWS self
    rows, other row) pairs (0: not counted), on a card of ``l2_bytes`` of
    L2.  ``form``: "whole" (K <= 30, one warp a row and its whole record),
    "chunked" (K <= 128, chunks of 512 floats); past K = 128 "group" where
    the CSR has at least FACTOR_GROUP_MIN_REUSE_X4 / 4 edges a pair, else
    "slab".  ``chunk``: record floats a chunk (the slab form's widest of
    512 .. 64 whose column slab, n_other x chunk floats, fills at most 1 /
    FACTOR_SLAB_L2_DIV of L2, FACTOR_SLAB_NV float4s a lane); ``lanes`` a
    self row, ``edges`` in flight, ``rows`` a CTA, ``smem_bytes`` a CTA,
    ``chunks`` a record."""
    _build.check_k(k, "factor kernel")
    stride = factor_stride(k)
    if k <= FACTOR_WHOLE_RECORD_MAX_K:
        form, chunk, lanes, edges, rows, smem = ("whole", -(-stride // 128) * 128, 32,
                                                 FACTOR_EDGES, 8, 0)
    elif k <= FACTOR_NARROW_MAX_K:
        form, chunk, lanes, edges, rows, smem = "chunked", FACTOR_CHUNK, 32, FACTOR_EDGES, 8, 0
    elif pairs > 0 and 4 * nnz >= FACTOR_GROUP_MIN_REUSE_X4 * pairs:
        form, chunk, lanes, edges = "group", FACTOR_GROUP_CHUNK, 32, FACTOR_GROUP_EDGES
        rows = FACTOR_GROUP_ROWS
        smem = FACTOR_GROUP_STAGES * FACTOR_GROUP_SLOTS * (FACTOR_GROUP_CHUNK + 1) * 4
    else:
        chunk = FACTOR_SLAB_MAX_CHUNK
        while (chunk > FACTOR_SLAB_MIN_CHUNK
               and n_other * chunk * 4 > l2_bytes // FACTOR_SLAB_L2_DIV):
            chunk //= 2
        lanes = chunk // (4 * FACTOR_SLAB_NV)
        form, edges, rows, smem = "slab", FACTOR_SLAB_EDGES, 8 * (32 // lanes), 0
    return dict(form=form, chunk=chunk, lanes=lanes, edges=edges, rows=rows,
                smem_bytes=smem, chunks=-(-stride // chunk), stride=stride)


@dataclasses.dataclass(frozen=True)
class FactorSchedule:
    """The group form's schedule of one CSR (``build_factor_schedule``):
    its self rows in groups of FACTOR_GROUP_ROWS, each group's distinct
    other rows ascending (``gp_other`` from ``gp_ptr[g]``) cut into windows
    of FACTOR_GROUP_SLOTS (the group's first at ``gw_ptr[g]``), and the
    edges ordered by (group, window, row, slot), so that each row sums its
    edges in the order of their other ids: ``e_slot`` the edge's slot in its
    window, ``e_x`` its rating, and row r's edges of window w from
    ``w_off[w * FACTOR_GROUP_ROWS + r]``.  ``pairs``: the distinct (group,
    other) pairs; the arrays are None where the plan takes the slab form.
    ``key``: the CSR's tensors it was built from."""

    pairs: int
    nnz: int
    rows: int
    n_other: int
    key: tuple
    geometry: tuple = (FACTOR_GROUP_ROWS, FACTOR_GROUP_SLOTS)  # (rows a group, slots a window)
    gp_other: torch.Tensor | None = None
    gp_ptr: torch.Tensor | None = None
    gw_ptr: torch.Tensor | None = None
    w_off: torch.Tensor | None = None
    e_slot: torch.Tensor | None = None
    e_x: torch.Tensor | None = None

    @property
    def grouped(self) -> bool:
        return self.e_slot is not None

    def arrays(self) -> tuple:
        return (self.gp_other, self.gp_ptr, self.gw_ptr, self.w_off, self.e_slot, self.e_x)


def _csr_key(row_ptr, other, x) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape)) for t in (row_ptr, other, x))


def _self_rows(row_ptr, nnz: int) -> torch.Tensor:
    """Each edge's self row."""
    return torch.repeat_interleave(torch.arange(row_ptr.shape[0] - 1, device=row_ptr.device),
                                   row_ptr[1:] - row_ptr[:-1], output_size=nnz)


def group_pairs(row_ptr, other, n_other: int) -> int:
    """The distinct (group of FACTOR_GROUP_ROWS consecutive self rows, other
    row) pairs of a CSR: the records the group form stages, each once."""
    if other.shape[0] == 0:
        return 0
    g = _self_rows(row_ptr, other.shape[0]) // FACTOR_GROUP_ROWS
    return int(torch.unique(g * n_other + other.long()).numel())


def build_factor_schedule(row_ptr, other, x, n_other: int,
                          grouped: bool | None = None) -> FactorSchedule:
    """The group form's schedule of a CSR (``FactorSchedule``), on its
    device, by sorts alone (the same arrays on every run).  ``grouped``
    None: the arrays where ``factor_plan`` takes the group form past
    K = 128 (enough edges a pair), only the pair count elsewhere; True or
    False builds them or not whatever the count."""
    G, S = FACTOR_GROUP_ROWS, FACTOR_GROUP_SLOTS
    rows, nnz, dev = row_ptr.shape[0] - 1, other.shape[0], row_ptr.device
    key = _csr_key(row_ptr, other, x)
    if nnz == 0:
        return FactorSchedule(0, 0, rows, n_other, key, (G, S))
    row = _self_rows(row_ptr, nnz)
    g = row // G
    uk, inv = torch.unique(g * n_other + other.long(), sorted=True, return_inverse=True)
    pairs = int(uk.numel())
    if grouped is None:
        grouped = factor_plan(FACTOR_NARROW_MAX_K + 1, n_other, nnz, pairs)["form"] == "group"
    if not grouped:
        return FactorSchedule(pairs, nnz, rows, n_other, key, (G, S))
    n_groups = -(-rows // G)
    ug = uk // n_other
    gp_ptr = torch.searchsorted(ug, torch.arange(n_groups + 1, device=dev))
    slot = inv - gp_ptr[g]
    n_win = (gp_ptr[1:] - gp_ptr[:-1] + S - 1) // S
    gw_ptr = torch.cat([n_win.new_zeros(1), torch.cumsum(n_win, 0)])
    n_windows = int(gw_ptr[-1])
    cell = (gw_ptr[g] + slot // S) * G + (row - g * G)  # (window, row in the group)
    perm = torch.sort(cell * S + slot % S, stable=True).indices
    counts = torch.bincount(cell, minlength=n_windows * G)
    w_off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return FactorSchedule(
        pairs, nnz, rows, n_other, key, (G, S), gp_other=(uk - ug * n_other).int(),
        gp_ptr=gp_ptr.long(), gw_ptr=gw_ptr.int(), w_off=w_off.long(),
        e_slot=(slot % S)[perm].int(), e_x=x[perm].float().contiguous())


def factor_schedule(p: TailCSR) -> FactorSchedule:
    """``build_factor_schedule`` of a layout's CSR, built once and kept on
    the TailCSR beside its ``long_rows`` (not a field: ``band_of`` and
    ``dataclasses.replace`` do not carry it to another CSR)."""
    s = p.__dict__.get("_factor_schedule")
    if s is None:
        s = build_factor_schedule(p.row_ptr, p.other, p.x, p.n_other)
        object.__setattr__(p, "_factor_schedule", s)
    return s


def factor_reckoning(p: TailCSR, K: int, with_bias_stats: bool = False,
                     l2_bytes: int = H100_L2_BYTES) -> dict:
    """K3's bytes, each with the edges' ids and ratings read and the output
    written once: ``per_edge`` gathers a record an edge (the 32-byte
    sectors it spans), ``table_once`` reads the table once, ``grouped``
    reads each distinct (group, other row) pair's record once (the group
    form's staging, ``group_pairs``); ``csr_rereads``: the bytes of ids and
    ratings that the slab form's chunks after the first read again, at the
    chunk ``factor_plan`` gives this table.  Reductions over the edges, on
    their device."""
    T = tri_size(K)
    rec = 4 * (K + 1 + T)
    row_out = 4 * (2 * K + T + (2 if with_bias_stats else 0))
    edge_bytes = 4 + p.x.element_size()
    fixed = p.nnz * edge_bytes + p.n_self * row_out
    off = (p.other.long() * (4 * factor_stride(K))) % 32
    sectors = int(torch.sum((off + rec + 31) // 32))
    slab = factor_plan(max(K, FACTOR_NARROW_MAX_K + 1), p.n_other, l2_bytes=l2_bytes)
    chunks = -(-factor_stride(K) // slab["chunk"])
    return {"per_edge": fixed + 32 * sectors, "table_once": fixed + p.n_other * rec,
            "grouped": fixed + group_pairs(p.row_ptr, p.other, p.n_other) * rec,
            "csr_rereads": p.nnz * edge_bytes * (chunks - 1)}


def factor_tail_stats_plain(aug, row_ptr, other, x, K: int,
                            with_bias_stats: bool = False,
                            max_edges: int | None = None) -> torch.Tensor:
    """Plain K3: aug (n_other, >= K+1+T) = [m | b | tri | pad] -> (n_self,
    2K+T(+2)) [sum m(x-b) | sum m | sum tri (| sum x | sum b)] in aug's
    dtype; pad columns past K+1+T are ignored.  ``max_edges`` bounds the
    edges whose temporaries exist at once."""
    T = tri_size(K)
    n_self = row_ptr.shape[0] - 1
    w_out = 2 * K + T + (2 if with_bias_stats else 0)
    out = torch.zeros((n_self, w_out), dtype=aug.dtype, device=aug.device)
    for r0, r1 in _row_chunks(row_ptr, max_edges):
        local, o, sl = _edges(row_ptr, other, r0, r1)
        g = aug[o]
        xv = x[sl].to(aug.dtype)
        m, b = g[:, :K], g[:, K]
        cols = [m * (xv - b)[:, None], m, g[:, K + 1 : K + 1 + T]]
        if with_bias_stats:
            cols += [xv[:, None], b[:, None]]
        out[r0:r1].index_add_(0, local, torch.cat(cols, dim=1))
    return out


@functools.lru_cache(maxsize=None)
def device_l2_bytes(device: torch.device) -> int:
    """The card's L2 in bytes, factor_plan's input."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def factor_tail_stats(aug, row_ptr, other, x, K: int,
                      with_bias_stats: bool = False,
                      schedule: FactorSchedule | None = None) -> torch.Tensor:
    """K3: the factor tail pass.  CUDA tensors launch the kernel, on a
    table padded to ``factor_stride(K)`` columns (``factor_table``), in the
    form ``factor_plan`` gives; past K = 128 it reads ``schedule`` (the
    CSR's ``build_factor_schedule``, kept by ``factor_schedule`` on a
    layout's TailCSR; built here when None).  CPU tensors run the plain
    version, which also takes an unpadded table."""
    if not aug.is_cuda:
        return factor_tail_stats_plain(aug, row_ptr, other, x, K, with_bias_stats)
    _build.check_k(K, "factor kernel")
    stride = factor_stride(K)
    if aug.dim() != 2 or aug.shape[1] != stride:
        raise ValueError(f"aug must be (n_other, {stride}): [m | b | tri] padded to "
                         f"factor_stride(K)")
    n_self = row_ptr.shape[0] - 1
    _check_tail_args([("aug", aug)], row_ptr, other, x, n_self)
    if aug.data_ptr() % 16:
        raise ValueError("aug must start on 16 bytes")
    if K > FACTOR_NARROW_MAX_K and schedule is None:
        schedule = build_factor_schedule(row_ptr, other, x, aug.shape[0])
    return launch_factor(aug, row_ptr, other, x, K, with_bias_stats, schedule)


def factor_tail_of(aug, p: TailCSR, K: int, with_bias_stats: bool = False) -> torch.Tensor:
    """``factor_tail_stats`` over a layout's CSR ``p``, reading its kept
    schedule (``factor_schedule``) where the card runs a wide form."""
    wide = aug.is_cuda and K > FACTOR_NARROW_MAX_K
    return factor_tail_stats(aug, p.row_ptr, p.other, p.x, K, with_bias_stats,
                             schedule=factor_schedule(p) if wide else None)


def launch_factor(aug, row_ptr, other, x, K: int, with_bias_stats: bool,
                  schedule: FactorSchedule | None, pairs: int | None = None,
                  l2: int | None = None) -> torch.Tensor:
    """Launch K3 on checked CUDA tensors in the form ``factor_plan`` gives
    for its inputs: the table's rows, the edges, ``pairs`` (the schedule's
    count when None; past K = 128 a schedule must be given) and ``l2``
    bytes (the card's when None).  A phase that times the forms side by
    side passes the plan other inputs."""
    T = tri_size(K)
    stride = factor_stride(K)
    n_self, n_other, nnz = row_ptr.shape[0] - 1, aug.shape[0], other.shape[0]
    arrays, slabs = (None,) * 6, None
    if K > FACTOR_NARROW_MAX_K:
        if schedule.key != _csr_key(row_ptr, other, x) or schedule.n_other != n_other:
            raise ValueError("schedule was built for another CSR or table")
        pairs = schedule.pairs if pairs is None else pairs
    _build.load_library()  # a failed build raises before the card is asked
    l2 = device_l2_bytes(aug.device) if l2 is None else l2
    if K > FACTOR_NARROW_MAX_K:
        plan = factor_plan(K, n_other, nnz, pairs, l2)
        if plan["form"] == "group":
            if not schedule.grouped or schedule.geometry != (plan["rows"], FACTOR_GROUP_SLOTS):
                raise ValueError("the group form needs the schedule's arrays at its "
                                 "geometry")
            arrays = schedule.arrays()
        slabs = aug.new_empty(plan["chunks"] * max(n_other, 1) * plan["chunk"])
    out = torch.empty((n_self, 2 * K + T + (2 if with_bias_stats else 0)),
                      dtype=torch.float32, device=aug.device)
    _build.launch("pmf_gauss_factor", FACTOR_LAUNCHES, aug.device, aug, stride, row_ptr,
                  other, x, n_self, K, int(with_bias_stats), n_other, nnz, pairs or 0, l2,
                  *arrays, slabs, out)
    return out


# ------------------------------------------------------------------ K5 --

def bias_tail_stats_plain(mb_other, row_ptr, other, x, K: int | None = None,
                          max_edges: int | None = None) -> torch.Tensor:
    """Plain K5: (n_self, K+2) [sum m_o | sum b_o | sum x] per self row of
    the CSR tail from the [m | b] table, in its dtype; columns past K + 1
    (K = its width less one when None) are ignored."""
    K = mb_other.shape[1] - 1 if K is None else K
    mb_other = mb_other[:, : K + 1]
    n_self = row_ptr.shape[0] - 1
    out = torch.zeros((n_self, K + 2), dtype=mb_other.dtype, device=mb_other.device)
    for r0, r1 in _row_chunks(row_ptr, max_edges):
        local, o, sl = _edges(row_ptr, other, r0, r1)
        payload = torch.cat([mb_other[o], x[sl].to(mb_other.dtype)[:, None]], dim=1)
        out[r0:r1].index_add_(0, local, payload)
    return out


def bias_tail_stats(mb_other, row_ptr, other, x, K: int | None = None,
                    long_rows: int = 0, windows=None) -> torch.Tensor:
    """K5: the bias tail pass at ``K`` factors (the table's width less one
    when None).  CUDA tensors launch the kernel, on the [m | b] table padded
    to ``tail_stride(K + 1)`` columns (``record_table``), giving each of the
    first ``long_rows`` rows a whole warp (``TailCSR.long_rows``), the sum
    form walking ``windows`` (``_tail.tail_windows`` of the same CSR) where
    given; CPU tensors run the plain version, which ignores columns past
    K + 1."""
    if not mb_other.is_cuda:
        return bias_tail_stats_plain(mb_other, row_ptr, other, x, K)
    K = mb_other.shape[1] - 1 if K is None else K
    _build.check_k(K, "bias kernel")
    n_self = row_ptr.shape[0] - 1
    _check_tail_args([("mb_other", mb_other)], row_ptr, other, x, n_self)
    _check_padded_tables(K, [("mb_other", mb_other)], "K5")
    _check_long_rows(long_rows, n_self)
    out = torch.empty((n_self, K + 2), dtype=torch.float32, device=mb_other.device)
    _build.launch("pmf_gauss_bias", BIAS_LAUNCHES, mb_other.device, mb_other, row_ptr,
                  other, x, n_self, long_rows, K,
                  *window_args(windows, n_self, K + 2, mb_other.device), out)
    return out


# ------------------------------------------------------------------ K6 --

def diag_tail_stats_plain(mb_self, mb_other, sq_other, row_ptr, other, x,
                          K: int | None = None,
                          max_edges: int | None = None) -> torch.Tensor:
    """Plain K6: (n_self, 3K) [sum m_o (x - b_s - b_o - <m_s, m_o>) |
    sum sq_o | sum m_o^2] per self row of the CSR tail, from the [m | b]
    tables and sq_o = v_o + m_o^2, in mb_other's dtype; columns past K + 1
    (K + 1 = mb_self's width when None; sq_other's past K) are ignored."""
    K = mb_self.shape[1] - 1 if K is None else K
    m_s, b_s = mb_self[:, :K], mb_self[:, K]
    m_other, b_other, sq_other = mb_other[:, :K], mb_other[:, K], sq_other[:, :K]
    n_self = row_ptr.shape[0] - 1
    out = torch.zeros((n_self, 3 * K), dtype=mb_other.dtype, device=mb_other.device)
    for r0, r1 in _row_chunks(row_ptr, max_edges):
        local, o, sl = _edges(row_ptr, other, r0, r1)
        m_o = m_other[o]
        pred = torch.sum(m_s[r0:r1][local] * m_o, dim=1)
        resid = x[sl].to(m_o.dtype) - b_s[r0:r1][local] - b_other[o]
        payload = torch.cat([m_o * (resid - pred)[:, None], sq_other[o], m_o * m_o],
                            dim=1)
        out[r0:r1].index_add_(0, local, payload)
    return out


def diag_tail_stats(mb_self, mb_other, sq_other, row_ptr, other, x,
                    K: int | None = None, long_rows: int = 0) -> torch.Tensor:
    """K6: the diag tail pass at ``K`` factors (mb_self's width less one
    when None): the register form to K = 127, the ring form from 128 to 511,
    the wide form past it (``_tail.launch_plan(K, "K6")``).  CUDA tensors
    launch the kernel, on the [m | b] tables
    padded to ``tail_stride(K + 1)`` columns (``record_table``) and sq_other
    padded to ``tail_stride(K)``, giving each of the first ``long_rows``
    rows a whole warp; CPU tensors run the plain version, which ignores pad
    columns."""
    if not mb_self.is_cuda:
        return diag_tail_stats_plain(mb_self, mb_other, sq_other, row_ptr, other, x, K)
    K = mb_self.shape[1] - 1 if K is None else K
    _build.check_k(K, "diag kernel")
    n_self = row_ptr.shape[0] - 1
    _check_tail_args([("mb_self", mb_self), ("mb_other", mb_other),
                      ("sq_other", sq_other)], row_ptr, other, x, n_self)
    _check_padded_tables(K, [("mb_self", mb_self), ("mb_other", mb_other)], "K6")
    _check_padded_tables(K, [("sq_other", sq_other)])
    if mb_self.shape[0] != n_self or sq_other.shape[0] != mb_other.shape[0]:
        raise ValueError("mb_self rows must match the CSR, sq_other rows mb_other's")
    _check_long_rows(long_rows, n_self)
    out = torch.empty((n_self, 3 * K), dtype=torch.float32, device=mb_other.device)
    _build.launch("pmf_gauss_diag", DIAG_LAUNCHES, mb_other.device, mb_self, mb_other,
                  sq_other, row_ptr, other, x, n_self, long_rows, K, out)
    return out


# ------------------------------------------------------- head + wrappers --

def _x_sum(tier, head_side):
    return tier.x_sum_user if head_side == "user" else tier.x_sum_item[: tier.hi]


def _gauss_head_out(tier, aug, K, T, with_bias_stats, head_side, precision):
    """One tier's contribution in K3's column layout
    [S_w' | S_m | triA (| S_x | S_b)] (S_w' without the b_self term, like
    the kernel).  ``aug`` is the new-space [m | b | tri] table (b zero
    without biases)."""
    a = _head_rows(aug, tier, head_side)
    m_h, b_h, tri_h = a[:, :K], a[:, K : K + 1], a[:, K + 1 : K + 1 + T]
    tab = torch.cat([m_h, b_h * m_h, tri_h, b_h], dim=1)
    start, mp, xp = _products(tier, tab, m_h, head_side, precision)
    cols = [xp - mp[:, K : 2 * K], mp[:, :K], mp[:, 2 * K : 2 * K + T]]
    if with_bias_stats:
        cols += [_x_sum(tier, head_side)[:, None].to(mp.dtype), mp[:, -1:]]
    return start, torch.cat(cols, dim=1)


def factor_table(m, b, A_flat, rows=None) -> torch.Tensor:
    """K3's table [m | b | triu(A) | 0 pad], ``factor_stride(K)`` columns,
    of rows ``rows`` of the inputs (all when None).  The packed triangle
    is gathered by rows straight into its columns of the padded table:
    two copies of the wide part (pack, permute), where packing, joining
    and permuting took three."""
    K = m.shape[1]
    T = tri_size(K)
    flat, _ = _tri_indices(K, A_flat.device)
    n = m.shape[0] if rows is None else rows.shape[0]
    out = m.new_empty((n, factor_stride(K)))
    if rows is None:
        torch.index_select(A_flat, 1, flat, out=out[:, K + 1 : K + 1 + T])
    else:
        m, b = m.index_select(0, rows), b.index_select(0, rows)
        torch.index_select(A_flat.index_select(1, flat), 0, rows,
                           out=out[:, K + 1 : K + 1 + T])
    out[:, :K] = m
    out[:, K] = b
    out[:, K + 1 + T :] = 0
    return out


def gaussian_factor_stats(m_other, V_other, b_self, b_other, p: TailCSR,
                          use_bias: bool = True, with_bias_stats: bool = False,
                          head=None, head_side: str = "user", precision: str = "high"):
    """(S_w (n_self, K), S_A (n_self, K, K)) for one factor block, with
    S_w = sum m_o (x [- b_s - b_o]) and S_A = sum (V_o + m_o m_o^T).  With
    ``with_bias_stats`` also (S_m, S_x, S_b): the per-row sums of m_o, x
    and b_o that the lagged bias block reads.  ``head``: the layout's
    DenseHead tiers (their edges are not in ``p``); ``head_side`` says
    whether self rows are the head's user axis ("user") or item axis."""
    if with_bias_stats and not use_bias:
        raise ValueError("with_bias_stats requires use_bias=True")
    K = m_other.shape[1]
    T = tri_size(K)
    A_flat = (V_other + m_other[:, :, None] * m_other[:, None, :]).reshape(-1, K * K)
    b_col = b_other if use_bias else torch.zeros_like(b_other)
    aug = factor_table(m_other, b_col, A_flat,
                       p.other_old_of_new if p.reordered else None)
    del A_flat
    heads = _check_head(p, head)
    out = unband(factor_tail_of(aug, p, K, with_bias_stats), p)
    out = _add_heads(out, [_gauss_head_out(t, aug, K, T, with_bias_stats,
                                           head_side, precision) for t in heads])
    if p.reordered:
        out = out[p.self_new_of_old]
    S_w = out[:, :K]
    S_m = out[:, K : 2 * K]
    if use_bias:
        # sum m_o (x - b_s - b_o) = sum m_o (x - b_o) - b_s sum m_o
        S_w = S_w - b_self[:, None] * S_m
    S_A = unpack_tri(out[:, 2 * K : 2 * K + T], K)
    if with_bias_stats:
        return S_w, S_A, S_m, out[:, 2 * K + T], out[:, 2 * K + T + 1]
    return S_w, S_A


def gaussian_bias_stats(m_self, m_other, b_other, p: TailCSR, head=None,
                        head_side: str = "user", precision: str = "high") -> torch.Tensor:
    """s (n_self,): per-row sums of bias residuals
    sum (x - b_o - <m_s, m_o>), assembled from the pass-through sums
    [sum m_o | sum b_o | sum x] (K5 on the tail, linear products on the
    head).  K5 reads [m_other | b_other] scattered into new space as a
    table of ``tail_stride(K + 1)`` columns (``record_table``); the head
    products see its K + 1 real columns only."""
    K = m_self.shape[1]
    heads = _check_head(p, head)
    mb = record_table(m_other, b_other, p.other_new_of_old if p.reordered else None)
    out = unband(bias_tail_stats(mb, p.row_ptr, p.other, p.x, K=K, long_rows=p.long_rows,
                                 windows=tail_windows(p, K, "K5")), p)
    head_outs = []
    for tier in heads:
        start, mp, _ = _products(tier, _head_rows(mb[:, : K + 1], tier, head_side),
                                 None, head_side, precision)
        head_outs.append((start, torch.cat(
            [mp, _x_sum(tier, head_side)[:, None].to(mp.dtype)], dim=1)))
    out = _add_heads(out, head_outs)
    if p.reordered:
        out = out[p.self_new_of_old]
    S_m, S_b, S_x = out[:, :K], out[:, K], out[:, K + 1]
    return S_x - S_b - torch.sum(m_self * S_m, dim=1)


def _diag_head_out(tier, m_o, sq_o, b_o, m_s, b_s, head_side, precision):
    """One tier's [S_mr | S_sq | S_mm] from the new-space tables' real
    columns (b zero without biases).  The cross term sum m_o <m_s, m_o> is
    unpack(M @ tri(m_o m_o^T)) @ m_s, linear in per-other payloads."""
    K = m_o.shape[1]
    m_h, sq_h = _head_rows(m_o, tier, head_side), _head_rows(sq_o, tier, head_side)
    b_h = _head_rows(b_o[:, None], tier, head_side)
    tri_mm = pack_tri((m_h[:, :, None] * m_h[:, None, :]).reshape(-1, K * K), K)
    tab = torch.cat([m_h, b_h * m_h, sq_h, m_h * m_h, tri_mm], dim=1)
    start, mp, xp = _products(tier, tab, m_h, head_side, precision)
    rows = slice(start, start + mp.shape[0])
    m_s, b_s = m_s[rows].to(mp.dtype), b_s[rows].to(mp.dtype)
    pred_term = torch.einsum("rkl,rl->rk", unpack_tri(mp[:, 4 * K :], K), m_s)
    S_mr = xp - pred_term - b_s[:, None] * mp[:, :K] - mp[:, K : 2 * K]
    return start, torch.cat([S_mr, mp[:, 2 * K : 3 * K], mp[:, 3 * K : 4 * K]],
                            dim=1)


def gaussian_diag_stats(m_other, v_other, m_self, b_self, b_other, p: TailCSR,
                        use_bias: bool = True, head=None,
                        head_side: str = "user", precision: str = "high"):
    """(S_mr, S_sq, S_mm), each (n_self, K), for one diag-covariance
    factor block: S_mr = sum m_o (resid - <m_s, m_o>) with resid =
    x [- b_s - b_o], S_sq = sum (v_o + m_o^2), S_mm = sum m_o^2.  K6 reads
    the [m | b] records of both sides (``record_table``) and sq_other =
    v_other + m_other^2 (``tail_stride(K)`` columns), each scattered into
    new space as its padded table; the head products see the real columns
    only."""
    K = m_other.shape[1]
    heads = _check_head(p, head)
    if not use_bias:
        b_self, b_other = b_self.new_zeros(b_self.shape), b_other.new_zeros(b_other.shape)
    mb_s = record_table(m_self, b_self, p.self_new_of_old if p.reordered else None)
    mb_o = record_table(m_other, b_other, p.other_new_of_old if p.reordered else None)
    sq_o = _padded_rows(torch.addcmul(v_other, m_other, m_other))
    if p.reordered:
        sq_o = _scattered_rows(sq_o, p.other_new_of_old)
    out = unband(diag_tail_stats(band_rows(mb_s, p), mb_o, sq_o, p.row_ptr, p.other,
                                 p.x, K=K, long_rows=p.long_rows), p)
    out = _add_heads(out, [_diag_head_out(t, mb_o[:, :K], sq_o[:, :K], mb_o[:, K],
                                          mb_s[:, :K], mb_s[:, K], head_side,
                                          precision)
                           for t in heads])
    if p.reordered:
        out = out[p.self_new_of_old]
    return out[:, :K], out[:, K : 2 * K], out[:, 2 * K :]
