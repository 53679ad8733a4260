"""Padded dual-sorted COO rating shards as torch tensors.

Two copies of the (user, item, rating) triples — one stably sorted by
user, one by item — padded to a multiple of ``PAD_MULTIPLE`` with
sentinel ids ``u = n_users`` / ``i = n_items`` and rating 0.  The arrays
equal the JAX package's for the same triples; padding contributes zero
because ``ops.segment.sorted_segment_sum`` drops out-of-range ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmf_tpu_torch.data.native import radix_argsort
from pmf_tpu_torch.utils.device import resolve_device

PAD_MULTIPLE = 1024


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _padded(arr: np.ndarray, n: int, sentinel) -> np.ndarray:
    out = np.full((n,), sentinel, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


@dataclasses.dataclass(frozen=True)
class RatingsCOO:
    u_by_u: torch.Tensor  # (nnz_padded,) int32
    i_by_u: torch.Tensor  # (nnz_padded,) int32
    x_by_u: torch.Tensor  # (nnz_padded,) float
    u_by_i: torch.Tensor
    i_by_i: torch.Tensor
    x_by_i: torch.Tensor
    user_counts: torch.Tensor  # (n_users,) float — ratings per user
    item_counts: torch.Tensor  # (n_items,) float
    n_users: int
    n_items: int
    nnz: int
    nnz_padded: int


def build_ratings(
    u, i, x, n_users: int | None = None, n_items: int | None = None,
    pad_multiple: int = PAD_MULTIPLE, dtype=np.float32, device=None,
) -> RatingsCOO:
    """Dimensions default to ``max(id) + 1``; ``device`` None = the card."""
    device = resolve_device(device)
    u = np.asarray(u, dtype=np.int32)
    i = np.asarray(i, dtype=np.int32)
    x = np.asarray(x, dtype=dtype)
    nnz = int(u.shape[0])
    if n_users is None:
        n_users = int(u.max()) + 1
    if n_items is None:
        n_items = int(i.max()) + 1
    nnz_padded = max(_round_up(nnz, pad_multiple), pad_multiple)

    # Both stable sorts and the counts by the native radix sort (numpy
    # without it), as the JAX package's build_ratings: the same arrays.
    order_u, user_counts = radix_argsort(u, n_users)
    order_i, item_counts = radix_argsort(i, n_items)
    user_counts = user_counts.astype(dtype)
    item_counts = item_counts.astype(dtype)

    def t(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    return RatingsCOO(
        u_by_u=t(_padded(u[order_u], nnz_padded, n_users)),
        i_by_u=t(_padded(i[order_u], nnz_padded, n_items)),
        x_by_u=t(_padded(x[order_u], nnz_padded, 0.0)),
        u_by_i=t(_padded(u[order_i], nnz_padded, n_users)),
        i_by_i=t(_padded(i[order_i], nnz_padded, n_items)),
        x_by_i=t(_padded(x[order_i], nnz_padded, 0.0)),
        user_counts=t(user_counts),
        item_counts=t(item_counts),
        n_users=int(n_users),
        n_items=int(n_items),
        nnz=nnz,
        nnz_padded=nnz_padded,
    )


@dataclasses.dataclass(frozen=True)
class EvalSet:
    """A padded evaluation split.  ``real`` marks non-padding rows,
    ``valid`` additionally ids in model range; ``class_id`` indexes each
    row's true rating among the split's unique values (``n_classes`` for
    padding), so macro-MAE is one segment mean per class."""

    u: torch.Tensor  # (n_rows_padded,) int32
    i: torch.Tensor
    x: torch.Tensor
    real: torch.Tensor  # bool
    valid: torch.Tensor  # bool
    class_id: torch.Tensor  # int32
    class_value: torch.Tensor  # (n_classes,)
    n_rows: int
    n_rows_padded: int
    n_classes: int


def build_eval_set(
    u, i, x, n_users: int, n_items: int, class_values=None,
    pad_multiple: int = PAD_MULTIPLE, dtype=np.float32, device=None,
) -> EvalSet:
    device = resolve_device(device)
    u = np.asarray(u, dtype=np.int32)
    i = np.asarray(i, dtype=np.int32)
    x = np.asarray(x, dtype=dtype)
    n_rows = int(u.shape[0])
    n_rows_padded = max(_round_up(n_rows, pad_multiple), pad_multiple)

    if class_values is None:
        class_values = np.unique(x)
    class_values = np.asarray(class_values, dtype=dtype)
    n_classes = int(class_values.shape[0])
    class_id = np.searchsorted(class_values, x).astype(np.int32)
    valid = (u < n_users) & (i < n_items)
    real = np.ones(n_rows, dtype=bool)

    def t(arr, sentinel):
        return torch.from_numpy(_padded(arr, n_rows_padded, sentinel)).to(device)

    return EvalSet(
        u=t(u, n_users),
        i=t(i, n_items),
        x=t(x, 0.0),
        real=t(real, False),
        valid=t(valid, False),
        class_id=t(class_id, n_classes),
        class_value=torch.from_numpy(class_values).to(device),
        n_rows=n_rows,
        n_rows_padded=n_rows_padded,
        n_classes=n_classes,
    )
