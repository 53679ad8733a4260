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
back to the original row order.  ``ext_factor_stats`` gathers the self
and other factor tables into new space padded to ``_tail.tail_stride(K)``
columns (``_tail.tail_tables``) and the scalars unpadded;
``ext_scalar_stats`` permutes its three tables unpadded.

``ext_factor_tail`` (K7) and ``ext_scalar_tail`` (K8) wrap the kernels of
``csrc/ext_edge.cu``: on CUDA tensors they launch (or raise), on CPU
tensors they run their ``*_plain`` versions.  K7 is K1's row-group kernel
(``csrc/tail_groups.cuh``, geometry ``_tail.launch_plan``) and takes the
padded tables and K given apart.
"""

from __future__ import annotations

import torch

from pmf_tpu_torch.data.blocked import TailCSR
from pmf_tpu_torch.ops import _build
from pmf_tpu_torch.ops._tail import (
    GROUP_MAX_K,
    add_heads,
    check_head,
    check_long_rows,
    check_padded_tables,
    check_tail_args,
    edges,
    head_out,
    head_rows,
    head_tables,
    products,
    row_chunks,
    tail_tables,
)
from pmf_tpu_torch.ops.dense_head import ext_head_stats, ext_head_stats_t

RATE_FLOOR = 1e-10
FACTOR_LAUNCHES = _build.LaunchCounter()
SCALAR_LAUNCHES = _build.LaunchCounter()
MAX_K = GROUP_MAX_K  # K8: ceil(K / 32) <= 4 factors a lane


def ext_factor_tail_plain(e_self, e_other, s_other, row_ptr, other, x,
                          rate_floor: float = RATE_FLOOR,
                          max_edges: int | None = None,
                          K: int | None = None) -> torch.Tensor:
    """Plain K7: (n_self, 2K) [sum x e_s*e_o / max(<e_s, e_o>, floor) |
    sum s_o e_o] per self row of the CSR tail, in the tables' dtype.
    ``max_edges`` bounds the edges whose temporaries exist at once; columns
    of the tables past ``K`` (their width when None) are ignored."""
    K = e_self.shape[1] if K is None else K
    e_self, e_other = e_self[:, :K], e_other[:, :K]
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


def ext_scalar_tail_plain(e_self_new, e_other, s_other, row_ptr, other,
                          max_edges: int | None = None) -> torch.Tensor:
    """Plain K8: (n_self,) sum s_o <e_self_new, e_o> per self row of the
    CSR tail, in the tables' dtype (no floor)."""
    n_self = e_self_new.shape[0]
    out = torch.zeros((n_self,), dtype=e_self_new.dtype, device=e_self_new.device)
    for r0, r1 in row_chunks(row_ptr, max_edges):
        local, o, _ = edges(row_ptr, other, r0, r1)
        dot = torch.sum(e_self_new[r0:r1][local] * e_other[o], dim=1)
        out[r0:r1].index_add_(0, local, s_other[o] * dot)
    return out


def _check_cuda_args(e_self, e_other, s_other, row_ptr, other, x):
    if e_self.dim() != 2 or not 1 <= e_self.shape[1] <= MAX_K:
        raise ValueError(f"extended tail kernels need 1 <= K <= {MAX_K}, got "
                         f"shape {tuple(e_self.shape)}")
    check_tail_args([("e_self", e_self), ("e_other", e_other),
                     ("s_other", s_other)], row_ptr, other, x, e_self.shape[0])
    if e_other.dim() != 2 or e_other.shape[1] != e_self.shape[1]:
        raise ValueError("e_self and e_other differ in K")
    if s_other.shape != (e_other.shape[0],):
        raise ValueError(f"s_other must be ({e_other.shape[0]},), got "
                         f"{tuple(s_other.shape)}")


def ext_factor_tail(e_self, e_other, s_other, row_ptr, other, x,
                    rate_floor: float = RATE_FLOOR, K: int | None = None,
                    long_rows: int = 0) -> torch.Tensor:
    """K7: the extended factor tail pass at ``K`` factors (the tables'
    width when None).  CUDA tensors launch the kernel, on tables of
    ``tail_stride(K)`` columns, giving each of the first ``long_rows`` rows
    a whole warp (``TailCSR.long_rows``); CPU tensors run the plain
    version, which ignores columns past K."""
    if not e_self.is_cuda:
        return ext_factor_tail_plain(e_self, e_other, s_other, row_ptr, other,
                                     x, rate_floor, K=K)
    K = e_self.shape[1] if K is None else K
    if not 1 <= K <= MAX_K:
        raise ValueError(f"extended tail kernels need 1 <= K <= {MAX_K}, got K={K}")
    _check_cuda_args(e_self, e_other, s_other, row_ptr, other, x)
    check_padded_tables(K, [("e_self", e_self), ("e_other", e_other)])
    n_self = e_self.shape[0]
    check_long_rows(long_rows, n_self)
    out = torch.empty((n_self, 2 * K), dtype=torch.float32, device=e_self.device)
    _build.launch("pmf_ext_factor", FACTOR_LAUNCHES, e_self.device, e_self,
                  e_other, s_other, row_ptr, other, x, n_self, long_rows, K,
                  rate_floor, out)
    return out


def ext_scalar_tail(e_self_new, e_other, s_other, row_ptr, other) -> torch.Tensor:
    """K8: the scalar-rate tail pass.  CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    if not e_self_new.is_cuda:
        return ext_scalar_tail_plain(e_self_new, e_other, s_other, row_ptr, other)
    _check_cuda_args(e_self_new, e_other, s_other, row_ptr, other, None)
    n_self, K = e_self_new.shape
    out = torch.empty((n_self,), dtype=torch.float32, device=e_self_new.device)
    _build.launch("pmf_ext_scalar", SCALAR_LAUNCHES, e_self_new.device,
                  e_self_new, e_other, s_other, row_ptr, other, n_self, K, out)
    return out


def _to_new_space(e_self, e_other, s_other, p: TailCSR):
    if not p.reordered:
        return e_self.contiguous(), e_other.contiguous(), s_other.contiguous()
    return (e_self[p.self_old_of_new], e_other[p.other_old_of_new],
            s_other[p.other_old_of_new])


def ext_factor_stats(E_self, E_other, s_other, p: TailCSR,
                     rate_floor: float = RATE_FLOOR, head=None,
                     head_side: str = "user"):
    """(S_alloc, S_wother), both (n_self, K), in the original row order.
    ``head``: the layout's DenseHead tiers (their edges are not in ``p``);
    ``head_side`` says whether self rows are the head's user axis ("user",
    by_user pass) or item axis.  The scalars follow the pass's other axis."""
    K = E_self.shape[1]
    heads = check_head(p, head)
    t_self, t_other = tail_tables(E_self, E_other, p)
    s_o = s_other[p.other_old_of_new] if p.reordered else s_other.contiguous()
    acc = ext_factor_tail(t_self, t_other, s_o, p.row_ptr, p.other, p.x, rate_floor,
                          K=K, long_rows=p.long_rows)
    e_self, e_other = t_self[:, :K], t_other[:, :K]
    fn = ext_head_stats if head_side == "user" else ext_head_stats_t
    head_outs = []
    for tier in heads:
        theta_h, beta_h = head_tables(e_self, e_other, tier, head_side)
        s_tab = (head_rows(s_o, tier, head_side)[:, None]
                 * (beta_h if head_side == "user" else theta_h))
        head_outs.append(head_out(
            tier, head_side, fn(theta_h, beta_h, s_tab, tier, rate_floor)))
    acc = add_heads(acc, head_outs)
    if p.reordered:
        acc = acc[p.self_new_of_old]
    return acc[:, :K], acc[:, K:]


def ext_scalar_stats(E_self_new, E_other, s_other, p: TailCSR, head=None,
                     head_side: str = "user") -> torch.Tensor:
    """S_sdot (n_self,): sum_e s_other_e * <E_self_new, E_other>, in the
    original row order.  The head part reuses the linear product:
    rowsum(E_self_new * (M @ (s * E_other)))."""
    heads = check_head(p, head)
    e_self, e_other, s_o = _to_new_space(E_self_new, E_other, s_other, p)
    acc = ext_scalar_tail(e_self, e_other, s_o, p.row_ptr, p.other)
    head_outs = []
    for tier in heads:
        s_tab = (head_rows(s_o, tier, head_side)[:, None]
                 * head_rows(e_other, tier, head_side))
        start, mp, _ = products(tier, s_tab, None, head_side)
        self_h = e_self[start : start + mp.shape[0]]
        head_outs.append((start, torch.sum(self_h * mp, dim=1)))
    acc = add_heads(acc, head_outs)
    if p.reordered:
        acc = acc[p.self_new_of_old]
    return acc
