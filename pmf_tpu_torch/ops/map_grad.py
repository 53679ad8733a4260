"""HPF-MAP minibatch gradients of the Poisson NLL, one step at a time.

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

``group_steps`` regroups one direction of the segment layout for a list
of segments taken ``mix`` at a time (an epoch's shuffle, or one step's
segments): one stable sort of the 64-bit key (step, self row) on the
tensors' device, so that a row's edges inside one step form one run
(ordered by the segments' place in the list, then by their order inside
the segment), and every run cut into pieces of at most ``PIECE`` edges.
``map_grad_pieces`` is kernel K9's wrapper (``csrc/map_grad.cu``) for one
direction of one step of such a grouping: on CUDA tensors it launches
the kernel (or raises), one launch for the whole step; on CPU tensors it
runs ``map_grad_pieces_plain``.  It STORES each row the step holds into
``out``, which the caller zeroes.  ``map_grad_grouped`` is the two
accumulators of one step, ``map_grad_step`` the same for any list of
segments, and ``map_grad_plain`` the plain version of a whole step over a
COO batch, the oracle of both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmf_tpu_torch.ops import _build

MAP_GRAD_LAUNCHES = _build.LaunchCounter()
WIDE_MAX_F = 8  # csrc/map_grad.cu: kWideMaxF, factors a lane of the register instances
PIECE = 128  # edges a piece at most: the longest walk of one warp (tuned, PERF.md PR 6)


def kernel_of(k: int) -> tuple:
    """The instance of ``csrc/map_grad.cu`` that takes ``k`` factors:
    ("lane", KMAX) one lane an edge up to K = 32, ("wide", F) F = ceil(K /
    32) factors a lane up to 32 WIDE_MAX_F, then ("general",), the sums
    kept in the stored row."""
    _build.check_k(k, "map-grad kernel")
    if k <= 32:
        return ("lane", 8 * -(-k // 8))
    if k <= 32 * WIDE_MAX_F:
        return ("wide", -(-k // 32))
    return ("general",)


def boundary_ks(k_max: int = 600) -> list:
    """The first K of each instance up to ``k_max``: the tests and
    chip_smoke.py hold K9 on both sides of each."""
    return [k for k in range(1, k_max + 1)
            if k == 1 or kernel_of(k) != kernel_of(k - 1)]


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


@dataclasses.dataclass(frozen=True)
class StepGroups:
    """One direction's edges grouped by (step, self row) and cut into
    pieces.  Piece p holds edges ``piece_ptr[p] .. piece_ptr[p + 1]`` of
    ``other`` / ``x`` for self row ``piece_row[p]``; its run (the row's
    edges in the step) is the ``piece_count[p]`` pieces from
    ``piece_first[p]`` on.  Step s owns pieces ``step_off[s] ..
    step_off[s + 1]``; ``step_edges`` (host) counts each step's edges."""

    other: torch.Tensor  # (E,) int32 other ids
    x: torch.Tensor  # (E,) ratings
    piece_ptr: torch.Tensor  # (n_pieces + 1,) int64
    piece_row: torch.Tensor  # (n_pieces,) int32
    piece_first: torch.Tensor  # (n_pieces,) int32
    piece_count: torch.Tensor  # (n_pieces,) int32
    step_off: torch.Tensor  # (n_steps + 1,) int32
    step_edges: np.ndarray  # (n_steps,) int64
    max_step_pieces: int  # the most pieces of any step (the launch's grid)
    n_runs: int
    scratch: torch.Tensor  # (max_step_pieces, K+2) float32 partial rows (card)
    counters: torch.Tensor  # (max_step_pieces,) int32 arrival counters, zeros

    @property
    def n_steps(self) -> int:
        return len(self.step_edges)

    @property
    def n_pieces(self) -> int:
        return self.piece_row.shape[0]


def group_steps(self_ids: torch.Tensor, other: torch.Tensor, x: torch.Tensor,
                seg_off: np.ndarray, seg_order, mix: int, n_self: int, K: int,
                piece: int = PIECE) -> StepGroups:
    """Group one direction's edges (segment order, ``seg_off`` the host
    offsets of the segments) for the segments ``seg_order`` (host ints),
    ``mix`` a step.  Segments not in the list are left out.  Runs on the
    tensors' device and waits for it twice: for the runs' count, and for
    the pieces of each step, which size the pieces, the launches and the
    scratch rows a card grouping carries (``K + 2`` floats each).  The
    sort key (step, self row) is 64 bits wide, or 32 where it fits."""
    dev = self_ids.device
    seg_order = np.asarray(seg_order, dtype=np.int64).reshape(-1)
    if len(seg_order) % mix:
        raise ValueError(f"{len(seg_order)} segments are not a multiple of mix={mix}")
    n_steps = len(seg_order) // mix
    seg_lens = np.diff(seg_off)[seg_order]
    step_edges = seg_lens.reshape(n_steps, mix).sum(axis=1)
    E = int(seg_lens.sum())
    lens = torch.from_numpy(seg_lens).to(dev)
    starts = torch.from_numpy(seg_off[:-1][seg_order]).to(dev)
    # The listed segments' edges, in list order.
    excl = torch.cumsum(lens, 0) - lens
    src = (torch.arange(E, device=dev)
           + torch.repeat_interleave(starts - excl, lens, output_size=E))
    key_t = torch.int32 if n_steps * n_self < 2**31 else torch.int64
    step = torch.repeat_interleave(
        torch.arange(len(seg_order), device=dev, dtype=key_t) // mix, lens, output_size=E)
    key, perm = torch.sort(step * n_self + self_ids[src].to(key_t), stable=True)
    src = src[perm]
    new_run = torch.ones(E, dtype=torch.bool, device=dev)
    new_run[1:] = key[1:] != key[:-1]
    run_start = torch.nonzero(new_run).squeeze(1)
    n_runs = run_start.shape[0]
    run_len = torch.diff(run_start, append=torch.tensor([E], device=dev))
    run_pieces = (run_len + piece - 1) // piece
    run_key = key[run_start].long()
    # before[r]: the pieces of the runs before run r.  Runs are sorted by
    # step, so each step's first run, and with it its first piece, is a
    # search away.
    before = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(run_pieces, 0)])
    first = before[:-1]
    step_off = before[torch.searchsorted(run_key // n_self,
                                         torch.arange(n_steps + 1, device=dev))]
    step_off_host = step_off.cpu()
    n_pieces = int(step_off_host[-1])
    max_pieces = int(torch.diff(step_off_host).max()) if n_steps else 0
    # Piece q of run r starts `piece` edges after piece q - 1.
    run_of = torch.repeat_interleave(torch.arange(n_runs, device=dev), run_pieces,
                                     output_size=n_pieces)
    piece_first = first[run_of]
    piece_start = run_start[run_of] + (torch.arange(n_pieces, device=dev)
                                       - piece_first) * piece
    return StepGroups(
        other=other[src].contiguous(), x=x[src].contiguous(),
        piece_ptr=torch.cat([piece_start, torch.tensor([E], device=dev)]),
        piece_row=(run_key % n_self).to(torch.int32)[run_of],
        piece_first=piece_first.to(torch.int32),
        piece_count=run_pieces.to(torch.int32)[run_of],
        step_off=step_off.to(torch.int32), step_edges=step_edges,
        max_step_pieces=max_pieces, n_runs=n_runs,
        scratch=torch.empty((max_pieces if dev.type == "cuda" else 0, K + 2),
                            dtype=torch.float32, device=dev),
        counters=torch.zeros(max_pieces, dtype=torch.int32, device=dev))


def map_grad_pieces_plain(self_tab, other_tab, g: StepGroups, step: int,
                          lam_floor: float, with_nll: bool, out) -> None:
    """Plain K9: store one direction of step ``step`` into ``out`` as the
    kernel does: each piece's sums, then each row's pieces added in piece
    order."""
    K = self_tab.shape[1] - 1
    p0, p1 = (int(v) for v in g.step_off[step : step + 2])
    e0, e1 = int(g.piece_ptr[p0]), int(g.piece_ptr[p1])
    if p1 == p0:
        return
    lens = g.piece_ptr[p0 + 1 : p1 + 1] - g.piece_ptr[p0:p1]
    piece_of = torch.repeat_interleave(torch.arange(p1 - p0, device=lens.device), lens)
    rows = g.piece_row[p0:p1].long()
    g_self = self_tab[rows[piece_of], :K]
    g_other = other_tab[g.other[e0:e1].long(), :K]
    w, nll = _edge_terms(g_self, g_other, g.x[e0:e1], lam_floor)
    cols = [w[:, None] * g_other, torch.ones_like(w)[:, None]]
    if with_nll:
        cols.append(nll[:, None])
    per_piece = torch.zeros((p1 - p0, K + 1 + int(with_nll)), dtype=self_tab.dtype,
                            device=self_tab.device)
    per_piece.index_add_(0, piece_of, torch.cat(cols, dim=1))
    out[rows] = 0
    out.index_add_(0, rows, per_piece.to(out.dtype))


def _check_cuda_args(self_tab, other_tab, g: StepGroups, with_nll, out):
    if self_tab.dim() != 2:
        raise ValueError(f"self_tab must be (n, K+1), got shape {tuple(self_tab.shape)}")
    _build.check_k(self_tab.shape[1] - 1, "map-grad kernel (tables carry K+1 columns)")
    checks = [("self_tab", self_tab, torch.float32), ("other_tab", other_tab, torch.float32),
              ("out", out, torch.float32), ("x", g.x, torch.float32),
              ("other", g.other, torch.int32), ("piece_ptr", g.piece_ptr, torch.int64),
              ("piece_row", g.piece_row, torch.int32),
              ("piece_first", g.piece_first, torch.int32),
              ("piece_count", g.piece_count, torch.int32),
              ("step_off", g.step_off, torch.int32), ("scratch", g.scratch, torch.float32),
              ("counters", g.counters, torch.int32)]
    for name, t, dt in checks:
        if t.device != self_tab.device:
            raise ValueError(f"{name} is on {t.device}, self_tab on {self_tab.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if other_tab.dim() != 2 or other_tab.shape[1] != self_tab.shape[1]:
        raise ValueError("self_tab and other_tab differ in K")
    width = self_tab.shape[1] + int(with_nll)
    if out.shape != (self_tab.shape[0], width):
        raise ValueError(f"out must be ({self_tab.shape[0]}, {width}), got "
                         f"{tuple(out.shape)}")
    if g.scratch.shape[0] < g.max_step_pieces or g.scratch.shape[1] < width \
            or g.counters.shape[0] < g.max_step_pieces:
        raise ValueError(f"scratch {tuple(g.scratch.shape)} or counters "
                         f"{tuple(g.counters.shape)} too small for "
                         f"{g.max_step_pieces} pieces of width {width}")


def map_grad_pieces(self_tab: torch.Tensor, other_tab: torch.Tensor, g: StepGroups,
                    step: int, lam_floor: float, with_nll: bool,
                    out: torch.Tensor) -> None:
    """K9: one direction of step ``step`` of the grouping ``g``, each row
    the step holds stored into ``out`` (the other rows untouched).  CUDA
    tensors launch the kernel once; CPU tensors run the plain version.  A
    step without edges launches nothing."""
    if not self_tab.is_cuda:
        map_grad_pieces_plain(self_tab, other_tab, g, step, lam_floor, with_nll, out)
        return
    _check_cuda_args(self_tab, other_tab, g, with_nll, out)
    if not 0 <= step < g.n_steps:
        raise ValueError(f"step {step} is outside the grouping's {g.n_steps} steps")
    if g.step_edges[step] == 0:
        return
    _build.launch("pmf_map_grad", MAP_GRAD_LAUNCHES, self_tab.device, self_tab,
                  other_tab, g.step_off, step, g.max_step_pieces, g.piece_ptr,
                  g.piece_row, g.piece_first, g.piece_count, g.other, g.x,
                  self_tab.shape[1] - 1, lam_floor, int(with_nll), out, g.scratch,
                  g.counters)


def map_grad_grouped(u_sp: torch.Tensor, i_sp: torch.Tensor, groups, step: int,
                     lam_floor: float):
    """The two accumulators of step ``step``: zeroed, then each
    direction's rows stored by one K9 launch.  ``groups``: the (by user,
    by item) groupings of one segment order."""
    K = u_sp.shape[1] - 1
    acc_u = torch.zeros((u_sp.shape[0], K + 2), dtype=u_sp.dtype, device=u_sp.device)
    acc_i = torch.zeros((i_sp.shape[0], K + 1), dtype=i_sp.dtype, device=i_sp.device)
    by_user, by_item = groups
    map_grad_pieces(u_sp, i_sp, by_user, step, lam_floor, True, acc_u)
    map_grad_pieces(i_sp, u_sp, by_item, step, lam_floor, False, acc_i)
    return acc_u, acc_i


def map_grad_step(u_sp: torch.Tensor, i_sp: torch.Tensor, layout, seg_ids,
                  lam_floor: float):
    """The two accumulators of one Adam step over the layout's segments
    ``seg_ids`` (host integers), grouped for that one step."""
    seg_ids = list(seg_ids)
    groups = layout.group(seg_ids, max(len(seg_ids), 1), u_sp.shape[1] - 1)
    return map_grad_grouped(u_sp, i_sp, groups, 0, lam_floor)
