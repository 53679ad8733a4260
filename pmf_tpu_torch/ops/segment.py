"""Segment-reduction primitives over flat COO edges.

Padding edges carry the sentinel id ``num_segments`` (or any id out of
range): ``sorted_segment_sum`` drops them and ``gather_rows`` clips them,
so padding contributes zero to every statistic.
"""

from __future__ import annotations

import torch


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` rows; ids outside
    [0, num_segments) are dropped (they land in a spill row cut off).
    The add is out of place, so the sum also runs under
    ``torch.func.vmap`` over a batched ``data`` (``tune.multi_seed``)."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, ids, data)[:num_segments]


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows by id; out-of-range (padding) ids clip to the edges."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def edge_dot(a_rows: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    """Per-edge inner product over the factor axis: (nnz, K) -> (nnz,)."""
    return torch.sum(a_rows * b_rows, dim=-1)
