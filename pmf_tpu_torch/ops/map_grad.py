"""HPF-MAP minibatch gradients of the Poisson NLL over segment CSRs.

Per edge (u, i, x) of a batch, with the softplus'd tables ``[theta | xi]``
and ``[beta | eta]`` (K+1 columns, the last ignored by the dot):

    lam = max(<theta_u, beta_i>, floor)
    w   = 1 - x / lam        (0 where the dot fell below the floor)
    nll = lam - x log lam

and per row the sums the dense part of the step needs:

    user rows  [sum w * beta_i | count | sum nll]    (n_users, K+2)
    item rows  [sum w * theta_u | count]             (n_items, K+1)

the same function as the JAX package's ``pmf_tpu/ops/pallas/map_grad.py``.
The gradients are with respect to the softplus'd tables; the caller owns
the softplus chain rule, the prior terms (weighted through ``count``) and
Adam.

``map_grad_rows`` is K9's wrapper (``csrc/map_grad.cu``) for ONE direction
of one segment stored as a small CSR over the rows that occur in it: on
CUDA tensors it launches the kernel (or raises), on CPU tensors it runs
``map_grad_rows_plain``.  It ADDS into ``out``: the segments of one step
share rows.  In the kernel one warp takes one row's run with one lane per
edge: each lane keeps K partial sums in registers (K <= 32), a
reduce-scatter leaves factor k's total in lane k, which adds it to the
row, and lane 0 adds the row's count (its CSR run length) and the
warp-reduced nll sum.  ``map_grad_plain`` is the plain version of a whole
step over a COO batch.
"""

from __future__ import annotations

import torch

from pmf_tpu_torch.ops import _build
from pmf_tpu_torch.ops._tail import check_tail_args

MAP_GRAD_LAUNCHES = _build.LaunchCounter()
MAX_K = 32  # the reduce-scatter leaves factor k's sum in lane k


def _edge_terms(g_self, g_other, x, lam_floor):
    """(w, nll) per edge from the gathered K-column rows."""
    dot = torch.sum(g_self * g_other, dim=1)
    lam = torch.clamp_min(dot, lam_floor)
    x = x.to(g_self.dtype)
    w = torch.where(dot >= lam_floor, 1.0 - x / lam, torch.zeros_like(lam))
    return w, lam - x * torch.log(lam)


def map_grad_plain(u_sp: torch.Tensor, i_sp: torch.Tensor, u_ids: torch.Tensor,
                   i_ids: torch.Tensor, x: torch.Tensor, lam_floor: float):
    """Plain version of one step over a COO batch (ids in the tables' row
    space): (user accumulator (n_users, K+2), item accumulator
    (n_items, K+1)), in the tables' dtype."""
    K = u_sp.shape[1] - 1
    u, i = u_ids.long(), i_ids.long()
    theta, beta = u_sp[u, :K], i_sp[i, :K]
    w, nll = _edge_terms(theta, beta, x, lam_floor)
    ones = torch.ones_like(w)
    acc_u = torch.zeros((u_sp.shape[0], K + 2), dtype=u_sp.dtype, device=u_sp.device)
    acc_i = torch.zeros((i_sp.shape[0], K + 1), dtype=i_sp.dtype, device=i_sp.device)
    acc_u.index_add_(0, u, torch.cat([w[:, None] * beta, ones[:, None],
                                      nll[:, None]], dim=1))
    acc_i.index_add_(0, i, torch.cat([w[:, None] * theta, ones[:, None]], dim=1))
    return acc_u, acc_i


def map_grad_rows_plain(self_tab, other_tab, rows, row_ptr, other, x,
                        lam_floor: float, with_nll: bool, out) -> None:
    """Plain K9: add one segment's sums of one direction into ``out``."""
    K = self_tab.shape[1] - 1
    counts = row_ptr[1:] - row_ptr[:-1]
    r = torch.repeat_interleave(rows.long(), counts)
    g_self, g_other = self_tab[r, :K], other_tab[other.long(), :K]
    w, nll = _edge_terms(g_self, g_other, x, lam_floor)
    cols = [w[:, None] * g_other, torch.ones_like(w)[:, None]]
    if with_nll:
        cols.append(nll[:, None])
    out.index_add_(0, r, torch.cat(cols, dim=1).to(out.dtype))


def _check_cuda_args(self_tab, other_tab, rows, row_ptr, other, x, with_nll, out):
    if self_tab.dim() != 2 or not 1 <= self_tab.shape[1] - 1 <= MAX_K:
        raise ValueError(f"map-grad kernel needs 1 <= K <= {MAX_K} (tables carry "
                         f"K+1 columns), got shape {tuple(self_tab.shape)}")
    check_tail_args([("self_tab", self_tab), ("other_tab", other_tab),
                     ("out", out)], row_ptr, other, x, rows.shape[0])
    if other_tab.dim() != 2 or other_tab.shape[1] != self_tab.shape[1]:
        raise ValueError("self_tab and other_tab differ in K")
    if rows.dtype != torch.int32 or not rows.is_contiguous() \
            or rows.device != row_ptr.device:
        raise TypeError("rows must be contiguous int32 on the tables' device")
    width = self_tab.shape[1] + int(with_nll)
    if out.shape != (self_tab.shape[0], width):
        raise ValueError(f"out must be ({self_tab.shape[0]}, {width}), got "
                         f"{tuple(out.shape)}")


def map_grad_rows(self_tab: torch.Tensor, other_tab: torch.Tensor,
                  rows: torch.Tensor, row_ptr: torch.Tensor, other: torch.Tensor,
                  x: torch.Tensor, lam_floor: float, with_nll: bool,
                  out: torch.Tensor) -> None:
    """K9: one direction of one segment, added into ``out``.  ``rows``
    (n_rows,) int32 are the self rows that occur in the segment, each
    once; ``row_ptr`` (n_rows + 1,) int64 their runs in ``other`` / ``x``.
    CUDA tensors launch the kernel; CPU tensors run the plain version.  An
    empty segment launches nothing."""
    if not self_tab.is_cuda:
        map_grad_rows_plain(self_tab, other_tab, rows, row_ptr, other, x,
                            lam_floor, with_nll, out)
        return
    _check_cuda_args(self_tab, other_tab, rows, row_ptr, other, x, with_nll, out)
    n_rows = rows.shape[0]
    if n_rows == 0:
        return
    _build.launch("pmf_map_grad", MAP_GRAD_LAUNCHES, self_tab.device, self_tab,
                  other_tab, rows, row_ptr, other, x, n_rows,
                  self_tab.shape[1] - 1, lam_floor, int(with_nll), out)


def map_grad_step(u_sp: torch.Tensor, i_sp: torch.Tensor, layout, seg_ids,
                  lam_floor: float):
    """The two accumulators of one Adam step over the layout's segments
    ``seg_ids`` (host integers): zeroed, then each segment's user and item
    direction added in turn."""
    K = u_sp.shape[1] - 1
    acc_u = torch.zeros((u_sp.shape[0], K + 2), dtype=u_sp.dtype, device=u_sp.device)
    acc_i = torch.zeros((i_sp.shape[0], K + 1), dtype=i_sp.dtype, device=i_sp.device)
    for s in seg_ids:
        map_grad_rows(u_sp, i_sp, *layout.by_user.segs[s], lam_floor, True, acc_u)
        map_grad_rows(i_sp, u_sp, *layout.by_item.segs[s], lam_floor, False, acc_i)
    return acc_u, acc_i
