"""Poisson/HPF CAVI edge pass over the hybrid layout.

``poisson_edge_stats`` permutes the factor tables into count-reordered
space, runs the sparse-tail kernel (K1, ``csrc/cavi_edge.cu``) over the
direction's CSR tail, adds each dense head tier's statistics
(``ops.dense_head``, kernel K2) and maps the result back to the original
row order — the same function as the JAX package's
``pmf_tpu/ops/pallas/cavi_edge.py::poisson_edge_stats`` in mode "cavi".
Its ``precision`` ("fast" or "high", ``models.base.BLOCKED_PRECISION``)
reaches the head only.  K1 runs in float32 at every precision: it gathers
padded float32 rows from L2, and fewer bf16 parts (the reference's
one-hot gather planes) would save it nothing.

``tail_edge_stats`` is K1's wrapper: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs ``tail_edge_stats_plain``,
the same function in plain PyTorch.  Its ``mode="raw"`` (the reference
kernel's second mode, which the tensor-parallel extended-Poisson scalar
pass reads) drops the rating and the rate: ``[sum e_s*e_o | sum e_o]``.
On the card K1 takes its tables padded to ``_tail.tail_stride(K)``
columns (``_tail.tail_tables`` pads them and scatters them into new
space) and K given apart; its row-group geometry is ``_tail.launch_plan``.
"""

from __future__ import annotations

import torch

from pmf_tpu_torch.data.blocked import TailCSR
from pmf_tpu_torch.ops import _build
from pmf_tpu_torch.ops._tail import (
    GROUP_MAX_K,
    add_heads,
    band_rows,
    check_head,
    check_long_rows,
    check_padded_tables,
    check_tail_args,
    head_out,
    head_tables,
    tail_tables,
    unband,
)
from pmf_tpu_torch.ops.dense_head import poisson_head_stats, poisson_head_stats_t

RATE_FLOOR = 1e-10
TAIL_LAUNCHES = _build.LaunchCounter()
TAIL_RAW_LAUNCHES = _build.LaunchCounter()
MODES = ("cavi", "raw")
MAX_K = GROUP_MAX_K  # at most 32 float4 words a row


def tail_edge_stats_plain(e_self: torch.Tensor, e_other: torch.Tensor,
                          row_ptr: torch.Tensor, other: torch.Tensor,
                          x: torch.Tensor | None,
                          rate_floor: float = RATE_FLOOR, mode: str = "cavi",
                          K: int | None = None) -> torch.Tensor:
    """(n_self, 2K) [sum x e_s*e_o / max(<e_s, e_o>, floor) | sum e_o] per
    self row of the CSR tail, in the tables' dtype.  ``mode="raw"``:
    [sum e_s*e_o | sum e_o], and ``x`` may be None.  Columns of the tables
    past ``K`` (their width when None) are ignored."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} {MODES}")
    K = e_self.shape[1] if K is None else K
    e_self, e_other = e_self[:, :K], e_other[:, :K]
    n_self = e_self.shape[0]
    counts = row_ptr[1:] - row_ptr[:-1]
    self_ids = torch.repeat_interleave(
        torch.arange(n_self, device=e_self.device), counts)
    g_self = e_self[self_ids]
    g_other = e_other[other.long()]
    alloc = g_self * g_other
    if mode == "cavi":
        rate = torch.clamp_min(torch.sum(alloc, dim=1), rate_floor)
        alloc = (x.to(e_self.dtype) / rate)[:, None] * g_self * g_other
    out = torch.zeros((n_self, 2 * K), dtype=e_self.dtype, device=e_self.device)
    out.index_add_(0, self_ids, torch.cat([alloc, g_other], dim=1))
    return out


def tail_edge_stats(e_self: torch.Tensor, e_other: torch.Tensor,
                    row_ptr: torch.Tensor, other: torch.Tensor,
                    x: torch.Tensor | None, rate_floor: float = RATE_FLOOR,
                    mode: str = "cavi", K: int | None = None,
                    long_rows: int = 0) -> torch.Tensor:
    """K1: the tail pass at ``K`` factors (the tables' width when None).
    CUDA tensors launch the kernel, on tables of ``tail_stride(K)``
    columns, giving each of the first ``long_rows`` rows a whole warp
    (``TailCSR.long_rows``); CPU tensors run the plain version, which
    ignores columns past K.  ``mode="raw"`` reads no ratings (``x`` may be
    None) and counts its launches in ``TAIL_RAW_LAUNCHES``."""
    if not e_self.is_cuda:
        return tail_edge_stats_plain(e_self, e_other, row_ptr, other, x,
                                     rate_floor, mode, K)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} {MODES}")
    raw = mode == "raw"
    K = e_self.shape[1] if K is None else K
    if not 1 <= K <= MAX_K:
        raise ValueError(f"tail kernel needs 1 <= K <= {MAX_K}, got K={K}")
    check_tail_args([("e_self", e_self), ("e_other", e_other)], row_ptr, other,
                    None if raw else x, e_self.shape[0])
    check_padded_tables(K, [("e_self", e_self), ("e_other", e_other)])
    n_self = e_self.shape[0]
    check_long_rows(long_rows, n_self)
    out = torch.empty((n_self, 2 * K), dtype=torch.float32, device=e_self.device)
    if raw:
        _build.launch("pmf_cavi_edge_raw", TAIL_RAW_LAUNCHES, e_self.device,
                      e_self, e_other, row_ptr, other, n_self, long_rows, K, out)
    else:
        _build.launch("pmf_cavi_edge", TAIL_LAUNCHES, e_self.device, e_self,
                      e_other, row_ptr, other, x, n_self, long_rows, K, rate_floor,
                      out)
    return out


def poisson_edge_stats(e_self: torch.Tensor, e_other: torch.Tensor,
                       p: TailCSR, rate_floor: float = RATE_FLOOR,
                       head=None, head_side: str = "user", precision: str = "high"):
    """(S_alloc, S_other), both (n_self, K), in the original row order:
    S_alloc[r] = sum over r's edges of x * e_self[r] * e_other[o] / rate,
    S_other[r] = sum of e_other[o].  ``head``: the layout's DenseHead tiers
    (their edges are not in ``p``); ``head_side`` says whether self rows
    are the head's user axis ("user", by_user pass) or item axis.  ``p``
    may be a band of the direction (``data.blocked.band_of``): the tail
    rows outside it are zero, and ``head`` is then the band's tiers."""
    K = e_self.shape[1]
    heads = check_head(p, head)
    t_self, t_other = tail_tables(e_self, e_other, p)
    acc = unband(tail_edge_stats(band_rows(t_self, p), t_other, p.row_ptr, p.other,
                                 p.x, rate_floor, K=K, long_rows=p.long_rows), p)
    e_self, e_other = t_self[:, :K], t_other[:, :K]
    fn = poisson_head_stats if head_side == "user" else poisson_head_stats_t
    acc = add_heads(acc, [
        head_out(tier, head_side, fn(*head_tables(e_self, e_other, tier, head_side),
                                     tier, rate_floor, precision))
        for tier in heads])
    if p.reordered:
        acc = acc[p.self_new_of_old]
    return acc[:, :K], acc[:, K:]
