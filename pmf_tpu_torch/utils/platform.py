"""Timing helpers for the card: a synchronizing read and the scalar round
trip, after the JAX package's ``pmf_tpu/utils/platform.py``.

A CUDA launch returns before the kernel ends, so a host clock bounds
device work only after something waits for it; copying one element to the
host does, on the stream that queued the work.  The JAX package's
``setup_cache`` (its persistent compilation cache) has no counterpart
here: the kernels are built once by ``ops/_build.py`` into
``pmf_tpu_torch/_build/``, keyed by a hash of their sources, and every
later process loads that library.
"""

from __future__ import annotations

import time

import torch

from pmf_tpu_torch.utils.device import resolve_device


def _leaves(tree) -> list:
    """The tensors of a tensor, a dict or a list/tuple, depth first in
    order (a dict's values in insertion order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def device_sync(tree) -> float:
    """Wait for the work queued on the first leaf by copying its first
    element to the host; returns that element as a float (0.0 for a tree
    without tensors)."""
    leaves = _leaves(tree)
    return float(leaves[0].reshape(-1)[0]) if leaves else 0.0


def measure_transfer_rtt(n: int = 5, device=None) -> float:
    """Mean seconds of a scalar copy from ``device`` to the host over ``n``
    copies, after one untimed copy: what to subtract from a time taken
    with ``device_sync``.  ``device``: None = the card (raises without
    one)."""
    tiny = torch.zeros(1, device=resolve_device(device))
    float(tiny[0])
    t0 = time.perf_counter()
    for _ in range(n):
        float(tiny[0])
    return (time.perf_counter() - t0) / n
