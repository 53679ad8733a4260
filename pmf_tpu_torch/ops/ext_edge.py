"""Extended-Poisson CAVI edge passes over the hybrid layout.

The extended model adds scalar activity factors, x ~ Poisson(phi_u psi_i
theta_u^T beta_i).  Each coordinate block needs, per self row, with s the
other side's scalar expectations:

    S_alloc_k  = sum_e x_e * e_self_k e_other_k / max(<e_self, e_other>, floor)
    S_wother_k = sum_e s_e * e_other_k               (factor rate)
    S_sdot     = sum_e s_e * <e_self_NEW, e_other>   (scalar rate, taken with
                 the freshly updated self rows)

Two passes per block: ``ext_factor_stats`` gives (S_alloc, S_wother), the
rows update, then ``ext_scalar_stats`` gives S_sdot -- the same functions
as the JAX package's ``pmf_tpu/ops/pallas/ext_edge.py``.  Each runs its
tail kernel over the direction's CSR tail in count-reordered space, adds
each dense head tier's statistics (``ops.dense_head``) and maps the result
back to the original row order.  Both tail kernels read the other side as
one [e | s] record a row (``es_record``, s in column K, padded to
``_tail.tail_stride(K + 1)`` columns) and the self rows padded to
``tail_stride(K)``, each scattered into new space by
``TailCSR.*_new_of_old``.  ``ext_factor_stats(..., keep_tables=True)``
also returns what the scalar pass of the same block reads again
(``FactorTables``: the records and each head tier's S_wother product),
so that pass permutes neither E_other nor s_other and makes no head
product of its own.  ``precision`` ("fast" or "high") reaches the
head (K2's instance and the head products) only: K7 and K8 run in float32
at every precision, gathering padded float32 records from L2, where fewer
bf16 parts would save nothing.

``ext_factor_tail`` (K7) and ``ext_scalar_tail`` (K8) wrap the kernels of
``csrc/ext_edge.cu``, modes of K1's row-group kernel
(``csrc/tail_groups.cuh``, geometry ``_tail.launch_plan``): on CUDA
tensors they launch (or raise), on the padded tables with K given apart;
on CPU tensors they run their ``*_plain`` versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pmf_tpu_torch.data.blocked import TailCSR
from pmf_tpu_torch.ops import _build
from pmf_tpu_torch.ops._tail import (
    add_heads,
    band_rows,
    check_head,
    check_long_rows,
    check_padded_tables,
    check_tail_args,
    edges,
    head_out,
    head_rows,
    head_tables,
    new_space_rows,
    products,
    record_rows as es_record,
    row_chunks,
    unband,
)
from pmf_tpu_torch.ops.dense_head import ext_head_stats, ext_head_stats_t

RATE_FLOOR = 1e-10
FACTOR_LAUNCHES = _build.LaunchCounter()
SCALAR_LAUNCHES = _build.LaunchCounter()


def ext_factor_tail_plain(e_self, es_other, row_ptr, other, x,
                          rate_floor: float = RATE_FLOOR,
                          max_edges: int | None = None,
                          K: int | None = None) -> torch.Tensor:
    """Plain K7: (n_self, 2K) [sum x e_s*e_o / max(<e_s, e_o>, floor) |
    sum s_o e_o] per self row of the CSR tail, from the [e | s] records
    ``es_other`` (s in column K), in the tables' dtype.  ``max_edges``
    bounds the edges whose temporaries exist at once; columns of e_self
    past ``K`` (its width when None) and of the records past K + 1 are
    ignored."""
    K = e_self.shape[1] if K is None else K
    e_self, e_other, s_other = e_self[:, :K], es_other[:, :K], es_other[:, K]
    n_self = e_self.shape[0]
    out = torch.zeros((n_self, 2 * K), dtype=e_self.dtype, device=e_self.device)
    for r0, r1 in row_chunks(row_ptr, max_edges):
        local, o, sl = edges(row_ptr, other, r0, r1)
        g_self = e_self[r0:r1][local]
        g_other = e_other[o]
        dot = torch.clamp_min(torch.sum(g_self * g_other, dim=1), rate_floor)
        alloc = (x[sl].to(e_self.dtype) / dot)[:, None] * g_self * g_other
        out[r0:r1].index_add_(
            0, local, torch.cat([alloc, s_other[o][:, None] * g_other], dim=1))
    return out


def ext_scalar_tail_plain(e_self_new, es_other, row_ptr, other,
                          max_edges: int | None = None,
                          K: int | None = None) -> torch.Tensor:
    """Plain K8: (n_self,) sum s_o <e_self_new, e_o> per self row of the
    CSR tail, from the [e | s] records ``es_other`` (s in column K), in the
    tables' dtype (no floor); columns of e_self_new past ``K`` (its width
    when None) and of the records past K + 1 are ignored."""
    K = e_self_new.shape[1] if K is None else K
    e_self_new, e_other, s_other = e_self_new[:, :K], es_other[:, :K], es_other[:, K]
    n_self = e_self_new.shape[0]
    out = torch.zeros((n_self,), dtype=e_self_new.dtype, device=e_self_new.device)
    for r0, r1 in row_chunks(row_ptr, max_edges):
        local, o, _ = edges(row_ptr, other, r0, r1)
        dot = torch.sum(e_self_new[r0:r1][local] * e_other[o], dim=1)
        out[r0:r1].index_add_(0, local, s_other[o] * dot)
    return out


def _check_cuda_args(name, e_self, es_other, row_ptr, other, x, K, long_rows):
    """Raise on what K7 and K8 do not take on the card: K below 1;
    self rows not padded to ``tail_stride(K)`` or records not
    padded to ``tail_stride(K + 1)``, or not starting on 16 bytes; the
    tail's arguments (``_tail.check_tail_args``); ``long_rows``."""
    _build.check_k(K, "extended tail kernels")
    check_tail_args([(name, e_self), ("es_other", es_other)], row_ptr, other, x,
                    e_self.shape[0])
    check_padded_tables(K, [(name, e_self)])
    check_padded_tables(K, [("es_other", es_other)], "K7")
    check_long_rows(long_rows, e_self.shape[0])


def ext_factor_tail(e_self, es_other, row_ptr, other, x,
                    rate_floor: float = RATE_FLOOR, K: int | None = None,
                    long_rows: int = 0) -> torch.Tensor:
    """K7: the extended factor tail pass at ``K`` factors (e_self's width
    when None) from the [e | s] records ``es_other``.  CUDA tensors launch
    the kernel, on self rows of ``tail_stride(K)`` columns and records of
    ``tail_stride(K + 1)`` (``es_record``), giving each of the first
    ``long_rows`` rows a whole warp (``TailCSR.long_rows``); CPU tensors run
    the plain version, which ignores pad columns."""
    if not e_self.is_cuda:
        return ext_factor_tail_plain(e_self, es_other, row_ptr, other, x, rate_floor,
                                     K=K)
    K = e_self.shape[1] if K is None else K
    _check_cuda_args("e_self", e_self, es_other, row_ptr, other, x, K, long_rows)
    n_self = e_self.shape[0]
    out = torch.empty((n_self, 2 * K), dtype=torch.float32, device=e_self.device)
    _build.launch("pmf_ext_factor", FACTOR_LAUNCHES, e_self.device, e_self, es_other,
                  row_ptr, other, x, n_self, long_rows, K, rate_floor, out)
    return out


def ext_scalar_tail(e_self_new, es_other, row_ptr, other, K: int | None = None,
                    long_rows: int = 0) -> torch.Tensor:
    """K8: the scalar-rate tail pass at ``K`` factors (e_self_new's width
    when None) from the [e | s] records ``es_other``.  CUDA tensors launch
    the kernel, on tables padded as K7's, giving each of the first
    ``long_rows`` rows a whole warp; CPU tensors run the plain version,
    which ignores pad columns."""
    if not e_self_new.is_cuda:
        return ext_scalar_tail_plain(e_self_new, es_other, row_ptr, other, K=K)
    K = e_self_new.shape[1] if K is None else K
    _check_cuda_args("e_self_new", e_self_new, es_other, row_ptr, other, None, K,
                     long_rows)
    n_self = e_self_new.shape[0]
    out = torch.empty((n_self,), dtype=torch.float32, device=e_self_new.device)
    _build.launch("pmf_ext_scalar", SCALAR_LAUNCHES, e_self_new.device, e_self_new,
                  es_other, row_ptr, other, n_self, long_rows, K, out)
    return out


@dataclass
class FactorTables:
    """What ``ext_factor_stats`` built in new space that the scalar pass of
    the same block reads again: ``records``, the other side's [e | s]
    records (``es_record``), and ``sw``, each head tier's (start row,
    S_wother head statistic M-product of s * E_other, cut to the self
    rows)."""
    records: torch.Tensor
    sw: list


def _s_tab(records, K, tier, head_side):
    """s * E_other over the tier's other rows, as the head product takes it
    (from the records' real columns)."""
    return (head_rows(records[:, K], tier, head_side)[:, None]
            * head_rows(records[:, :K], tier, head_side))


def ext_factor_stats(E_self, E_other, s_other, p: TailCSR,
                     rate_floor: float = RATE_FLOOR, head=None,
                     head_side: str = "user", keep_tables: bool = False,
                     precision: str = "high"):
    """(S_alloc, S_wother), both (n_self, K), in the original row order.
    ``head``: the layout's DenseHead tiers (their edges are not in ``p``);
    ``head_side`` says whether self rows are the head's user axis ("user",
    by_user pass) or item axis.  The scalars follow the pass's other axis.
    With ``keep_tables``, also the ``FactorTables`` that
    ``ext_scalar_stats`` of the same block takes as ``factor``."""
    K = E_self.shape[1]
    heads = check_head(p, head)
    t_self = new_space_rows(E_self, p.self_new_of_old if p.reordered else None)
    records = es_record(E_other, s_other, p.other_new_of_old if p.reordered else None)
    acc = unband(ext_factor_tail(band_rows(t_self, p), records, p.row_ptr, p.other,
                                 p.x, rate_floor, K=K, long_rows=p.long_rows), p)
    fn = ext_head_stats if head_side == "user" else ext_head_stats_t
    head_outs, sw = [], []
    for tier in heads:
        theta_h, beta_h = head_tables(t_self[:, :K], records[:, :K], tier, head_side)
        s_alloc, sw_h = fn(theta_h, beta_h, _s_tab(records, K, tier, head_side), tier,
                           rate_floor, precision)
        head_outs.append(head_out(tier, head_side, (s_alloc, sw_h)))
        sw.append((tier.row_start, sw_h) if head_side == "user" else (0, sw_h[: tier.hi]))
    acc = add_heads(acc, head_outs)
    if p.reordered:
        acc = acc[p.self_new_of_old]
    if keep_tables:
        return acc[:, :K], acc[:, K:], FactorTables(records, sw)
    return acc[:, :K], acc[:, K:]


def ext_scalar_stats(E_self_new, E_other, s_other, p: TailCSR, head=None,
                     head_side: str = "user",
                     factor: FactorTables | None = None,
                     precision: str = "high") -> torch.Tensor:
    """S_sdot (n_self,): sum_e s_other_e * <E_self_new, E_other>, in the
    original row order.  The head part reuses the linear product:
    rowsum(E_self_new * (M @ (s * E_other))).  ``factor``: what
    ``ext_factor_stats(..., keep_tables=True)`` of the same block built
    from the same ``E_other`` and ``s_other``; then neither is permuted
    again and each tier's product is the factor pass's S_wother one, the
    same call on the same inputs.  Without it, both are built here."""
    K = E_self_new.shape[1]
    heads = check_head(p, head)
    if factor is None:
        records = es_record(E_other, s_other,
                            p.other_new_of_old if p.reordered else None)
        factor = FactorTables(records, [
            products(tier, _s_tab(records, K, tier, head_side), None, head_side,
                     precision)[:2]
            for tier in heads])
    e_self = new_space_rows(E_self_new, p.self_new_of_old if p.reordered else None)
    acc = unband(ext_scalar_tail(band_rows(e_self, p), factor.records, p.row_ptr,
                                 p.other, K=K, long_rows=p.long_rows), p)
    acc = add_heads(acc, [
        (start, torch.sum(e_self[start : start + sw.shape[0], :K] * sw, dim=1))
        for start, sw in factor.sw])
    if p.reordered:
        acc = acc[p.self_new_of_old]
    return acc
