"""Batch top-k recommendation: the serving path.

Scores are dense batches ``theta[u] @ beta^T`` (``torch.mm`` in float32;
device setup keeps TF32 off on the card) plus the item bias where the
model has one.  Each user's
own training items are masked by one ``index_put_`` a batch and
``torch.topk`` picks the k best.  The exclusion index is built once: the
CSR row pointers stay on the host, the item column sorted by user lives on
the device, and each batch's mask indices are built on the device from the
queried rows' (start, offset, count).  The queried users' ids and those
triples go to the device in one copy before the first batch, every batch
is dispatched before any result is read, and the results come to the host
in one copy at the end: nothing waits for the device between batches.
"""

from __future__ import annotations

import numpy as np
import torch

from pmf_tpu_torch.data.native import radix_argsort
from pmf_tpu_torch.utils.device import resolve_device

NEG = -3.0e38  # effectively -inf for float32 scores


def _round_pow2(n: int, floor: int = 256) -> int:
    m = floor
    while m < n:
        m *= 2
    return m


def _check_range(ids: np.ndarray, n: int, what: str) -> None:
    if len(ids) and (ids.min() < 0 or ids.max() >= n):
        bad = ids[(ids < 0) | (ids >= n)][:5]
        raise ValueError(f"{what} out of range [0, {n}): {bad.tolist()}")


def build_exclusion_index(train_u, train_i, n_users: int | None = None,
                          n_items: int | None = None, device=None):
    """Serving-time preparation, done once: sort the training pairs by user
    (stable), build the per-user CSR row pointer on the host and put the
    sorted item column on ``device`` (None = the card).  Returns an opaque
    index for ``recommend(train_index=...)``.  Ids outside
    [0, n_users) / [0, n_items) raise."""
    tu = np.asarray(train_u, dtype=np.int64)
    ti = np.asarray(train_i, dtype=np.int64)
    if n_users is None:
        n_users = int(tu.max()) + 1 if len(tu) else 0
    _check_range(tu, n_users, "train user ids")
    if n_items is not None:
        _check_range(ti, n_items, "train item ids")
    # The stable sort and the counts by the native radix sort (numpy
    # without it), as the JAX package's.
    order, counts = radix_argsort(tu, n_users)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    ti_dev = torch.from_numpy(ti[order].astype(np.int32)).to(resolve_device(device))
    return row_ptr, ti_dev


def exclusion_index_from_coo(data):
    """The serving index of a training ``data.coo.RatingsCOO``: its
    ``i_by_u`` column is already the by-user-sorted item list on the
    device (padding sits past the real edges, where the row pointers from
    ``user_counts`` never reach), so only the counts are read, once."""
    counts = data.user_counts.cpu().numpy().astype(np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return row_ptr, data.i_by_u


def _pad_row_ptr(row_ptr: np.ndarray, n_users: int) -> np.ndarray:
    """An index built from max(train_u) + 1 users gives users above that
    (cold users the model still has rows for) zero exclusions."""
    if len(row_ptr) - 1 < n_users:
        pad = np.full(n_users - (len(row_ptr) - 1), row_ptr[-1], dtype=row_ptr.dtype)
        row_ptr = np.concatenate([row_ptr, pad])
    return row_ptr


def _device_mask(lo, off, cnt, ti_dev, cap: int, n_rows: int, total: int):
    """(row, item) mask indices of one batch, built on the device: row r
    contributes ``ti_dev[lo[r] : lo[r] + cnt[r]]`` at flat positions
    [off[r], off[r] + cnt[r]).  ``total`` = sum(cnt) (known on the host);
    the cap - total padding positions go to the spare row ``n_rows``
    with item 0, so no entry is out of range and nothing is dropped."""
    dev = cnt.device
    pad = cap - total
    rows = torch.repeat_interleave(
        torch.arange(n_rows + 1, device=dev),
        torch.cat([cnt, torch.full((1,), pad, dtype=cnt.dtype, device=dev)]),
        output_size=cap)
    lo = torch.cat([lo, torch.zeros((1,), dtype=lo.dtype, device=dev)])
    off = torch.cat([off, torch.full((1,), total, dtype=off.dtype, device=dev)])
    pos = torch.arange(cap, device=dev) - off[rows]
    at = (lo[rows] + pos).clamp(0, max(ti_dev.shape[0] - 1, 0))
    item = ti_dev[at].long()
    return rows, torch.where(rows < n_rows, item, 0)


def recommend(theta, beta, user_ids, k: int = 10, train_u=None, train_i=None,
              batch: int = 1024, item_bias=None, user_bias=None,
              mean: float = 0.0, train_index=None):
    """Top-k items per user under the model's full score.

    ``theta`` (n_users, K) and ``beta`` (n_items, K) are the point
    estimates as tensors; scoring runs on their device.  Scores are
    ``mean + user_bias[u] + item_bias[i] + <theta_u, beta_i>``: item_bias
    takes part in the ranking, the per-user terms only shift the reported
    scores so they match predict().  With train_u/train_i (or a prebuilt
    ``train_index``) each user's own training items are excluded.
    Returns (items (len(user_ids), k) int64, scores float32) as numpy
    arrays."""
    theta = theta.detach().to(torch.float32)
    beta = beta.detach().to(device=theta.device, dtype=torch.float32)
    dev = theta.device
    n_rows, n_items = theta.shape[0], beta.shape[0]
    users = np.asarray(user_ids, dtype=np.int64).reshape(-1)
    _check_range(users, n_rows, "user ids")
    n = len(users)
    if item_bias is not None:
        item_bias = item_bias.detach().to(device=dev, dtype=torch.float32)

    if train_index is None and train_u is not None and train_i is not None \
            and len(train_u):
        train_index = build_exclusion_index(train_u, train_i, n_users=n_rows,
                                            n_items=n_items, device=dev)
    users_dev = torch.from_numpy(users).to(dev)
    if train_index is not None:
        row_ptr, ti_dev = train_index
        row_ptr = _pad_row_ptr(row_ptr, n_rows)
        lo_all = row_ptr[users]
        cnt_all = row_ptr[users + 1] - lo_all
        # Each user's offset inside its batch: exclusive sums restarted at
        # every batch start.
        excl = np.cumsum(cnt_all) - cnt_all
        starts = np.arange(0, n, batch)
        off_all = excl - np.repeat(excl[starts], np.diff(np.append(starts, n)))
        lo_dev, off_dev, cnt_dev = torch.from_numpy(
            np.stack([lo_all, off_all, cnt_all])).to(dev)

    vals, idxs = [], []
    for s in range(0, n, batch):
        e = min(s + batch, n)
        B = e - s
        # Row B is the spare row the mask's padding lands in.
        scores = torch.empty((B + 1, n_items), dtype=torch.float32, device=dev)
        torch.mm(theta[users_dev[s:e]], beta.T, out=scores[:B])
        if item_bias is not None:  # a pass over the whole score matrix
            scores[:B] += item_bias
        if train_index is not None:
            total = int(cnt_all[s:e].sum())
            mask_u, mask_i = _device_mask(lo_dev[s:e], off_dev[s:e], cnt_dev[s:e],
                                          ti_dev, _round_pow2(max(total, 1)), B,
                                          total)
            scores[mask_u, mask_i] = NEG
        v, i = torch.topk(scores[:B], k, dim=1)
        vals.append(v)
        idxs.append(i)
    if n:
        items = torch.cat(idxs).cpu().numpy().astype(np.int64)
        out = torch.cat(vals).cpu().numpy()
    else:
        items = np.empty((0, k), dtype=np.int64)
        out = np.empty((0, k), dtype=np.float32)
    if mean or user_bias is not None:
        shift = np.full(n, float(mean), dtype=np.float32)
        if user_bias is not None:
            shift = shift + user_bias.detach().cpu().numpy().astype(np.float32)[users]
        out = out + shift[:, None]
    return items, out


def recommend_sharded(theta, beta, user_ids, k: int = 10, train_u=None, train_i=None,
                      mesh=None, item_bias=None, user_bias=None, mean: float = 0.0,
                      batch: int = 1024, train_index=None):
    """``recommend`` with the queried users cut over the mesh's ranks: each
    rank scores its contiguous share against its own copy of the tables
    (``torch.mm`` and ``torch.topk``, no kernel of the port), then one
    gather gives every rank the whole (items, scores), equal to
    ``recommend``'s.  ``batch`` bounds each rank's users a dispatch."""
    import torch.distributed as dist

    from pmf_tpu_torch.parallel.mesh import share

    if mesh is None:
        raise ValueError("recommend_sharded requires a mesh")
    users = np.asarray(user_ids, dtype=np.int64).reshape(-1)
    _check_range(users, theta.shape[0], "user ids")
    n = len(users)
    mine = share(n, mesh.rank, mesh.size)
    items, scores = recommend(theta, beta, users[mine], k=k, train_u=train_u,
                              train_i=train_i, batch=batch, item_bias=item_bias,
                              user_bias=user_bias, mean=mean, train_index=train_index)
    # Every share padded to the longest, gathered, and the padding dropped.
    width = -(-n // mesh.size)
    dev = mesh.device
    packed = torch.zeros((width, 2 * k), dtype=torch.float64, device=dev)
    packed[: len(items), :k] = torch.from_numpy(items).to(dev, torch.float64)
    packed[: len(items), k:] = torch.from_numpy(scores).to(dev, torch.float64)
    parts = [torch.empty_like(packed) for _ in range(mesh.size)]
    dist.all_gather(parts, packed)
    lengths = [len(range(n)[share(n, r, mesh.size)]) for r in range(mesh.size)]
    rows = torch.cat([part[:m] for part, m in zip(parts, lengths)]).cpu().numpy()
    return rows[:, :k].astype(np.int64), rows[:, k:].astype(np.float32)
