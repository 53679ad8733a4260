"""Top-K ranking metrics (recall@k, NDCG@k, mean rank) for held-out items.

Exact ranks with no sort of the catalogue and no ragged mask:

  rank(u, i*) = 1 + #{j : score(u, j) > score(u, i*)}
                  - #{j in train(u) : score(u, j) > score(u, i*)}

  * the first count runs over all items: batched dense score matrices
    theta[u] @ beta^T and a compare-and-sum;
  * the train-item correction is one pass over the training edges in
    bounded chunks, scoring every edge.  Per chunk the edges are sorted by
    the key (user, score) and each held-out pair counts its user's edges
    above its threshold by two binary searches; the JAX package compares
    every edge with a dense (n_users, T) table of thresholds instead
    (T = most held-out pairs of one user), the same counts.

Binary-relevance NDCG@k = 1/log2(rank+1) for rank <= k, averaged over
held-out pairs; recall@k = fraction of held-out pairs ranked <= k.
Everything runs on the device of ``theta``; the batches are dispatched
before the results are read, in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from pmf_tpu_torch.ops.segment import edge_dot, gather_rows


def _sort_key(u: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (u, score) for non-NaN float32 scores: the
    float's bits mapped to an unsigned order in the low 32 bits (-0.0
    first turned into +0.0, which compares equal to it)."""
    bits = (score.to(torch.float32) + 0.0).view(torch.int32).long()
    ordered = torch.where(bits >= 0, bits + (1 << 31), ~bits)
    return (u.long() << 32) | ordered


def _train_higher_counts(theta, beta, train_u, train_i, pair_u, pair_t,
                         edge_chunk: int) -> torch.Tensor:
    """counts[p] = # training edges of user pair_u[p] scoring strictly
    above pair_t[p], summed over chunks of ``edge_chunk`` edges (float64,
    on the device)."""
    q_key = _sort_key(pair_u, pair_t)
    q_end = (pair_u.long() + 1) << 32  # the first key of the next user
    counts = torch.zeros(pair_u.shape[0], dtype=torch.float64, device=theta.device)
    for s in range(0, train_u.shape[0], edge_chunk):
        cu, ci = train_u[s : s + edge_chunk], train_i[s : s + edge_chunk]
        es = edge_dot(gather_rows(theta, cu), gather_rows(beta, ci))
        keys = torch.sort(_sort_key(cu, es)).values
        counts += (torch.searchsorted(keys, q_end)
                   - torch.searchsorted(keys, q_key, right=True))
    return counts


def _rank_all_batch(theta_rows, beta, i_batch):
    """Per pair: (threshold, #items scoring strictly above it).  The
    threshold is read from the same score matrix that competitors are
    counted in, so the pair's own item never miscounts itself by a
    summation-order ulp."""
    scores = torch.mm(theta_rows, beta.T)
    t = scores[torch.arange(scores.shape[0], device=scores.device), i_batch]
    return t, torch.sum(scores > t[:, None], dim=1)


def _as_f32(theta, beta):
    theta = theta.detach().to(torch.float32)
    return theta, beta.detach().to(device=theta.device, dtype=torch.float32)


def _ids(arr, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(dev)


def ranking_metrics(theta, beta, train_u, train_i, test_u, test_i, ks=(10, 50),
                    batch: int = 2048, edge_chunk: int = 4 << 20) -> dict:
    """Exact recall@k / NDCG@k / mean rank of held-out (test_u, test_i)
    pairs under dot-product scores, each user's own training items
    excluded from the competition.  ``theta``, ``beta``: tensors; the ids
    numpy arrays."""
    theta, beta = _as_f32(theta, beta)
    dev = theta.device
    test_u = np.asarray(test_u, dtype=np.int64)
    test_i = np.asarray(test_i, dtype=np.int64)
    order = np.argsort(test_u, kind="stable")
    test_u, test_i = test_u[order], test_i[order]
    P = len(test_u)
    tu, ti = _ids(test_u, dev), _ids(test_i, dev)

    thresholds, above = [], []
    for s in range(0, P, batch):
        t, r = _rank_all_batch(gather_rows(theta, tu[s : s + batch]), beta,
                               ti[s : s + batch])
        thresholds.append(t)
        above.append(r)
    rank = torch.zeros(P, dtype=torch.float64, device=dev)
    if P:
        t = torch.cat(thresholds)
        higher = _train_higher_counts(theta, beta, _ids(train_u, dev),
                                      _ids(train_i, dev), tu, t, edge_chunk)
        # A held-out pair that also occurs in train would subtract its own
        # score and reach rank 0; it is the target, so clamp to 1.
        rank = torch.clamp_min(torch.cat(above).double() - higher + 1.0, 1.0)
    rank = rank.cpu().numpy()
    out = {"mean_rank": float(rank.mean()) if P else float("nan"), "n_pairs": P}
    for k in ks:
        hit = rank <= k
        out[f"recall@{k}"] = float(hit.mean())
        out[f"ndcg@{k}"] = float(np.where(hit, 1.0 / np.log2(rank + 1.0), 0.0).mean())
    return out


def _sampled_ranks(theta_rows, beta_cands, target_scores):
    """rank = 1 + #{negatives scoring strictly above the target}."""
    s = torch.sum(theta_rows[:, None, :] * beta_cands, dim=-1)
    return 1.0 + torch.sum(s > target_scores[:, None], dim=1)


def sampled_ranking_metrics(theta, beta, train_u, train_i, test_u, test_i,
                            n_negatives: int = 100, seed: int = 0, ks=(10,),
                            batch: int = 8192, max_resample_rounds: int = 8) -> dict:
    """Leave-one-out ranking with sampled negatives: each held-out
    (u, i*) pair is ranked among ``n_negatives`` items drawn uniformly
    from the user's unseen items (not in train(u), != i*), reporting
    HR@k and NDCG@k.  The negatives are drawn on the host by numpy in the
    JAX package's order (uniform draws, collisions found by binary search
    in the sorted train keys and redrawn, then exact sampling from the
    unseen set for users the redraws could not serve), so the same seed
    gives the same negatives."""
    theta, beta = _as_f32(theta, beta)
    dev = theta.device
    n_items = beta.shape[0]
    test_u = np.asarray(test_u, dtype=np.int64)
    test_i = np.asarray(test_i, dtype=np.int64)
    P = len(test_u)
    if P == 0:
        return {"n_pairs": 0}

    train_keys = np.sort(
        np.asarray(train_u, np.int64) * n_items + np.asarray(train_i, np.int64))

    def is_seen(users, items):
        if not len(train_keys):
            return np.zeros(len(users), dtype=bool)
        keys = users * n_items + items
        pos = np.minimum(np.searchsorted(train_keys, keys), len(train_keys) - 1)
        return train_keys[pos] == keys

    rng = np.random.default_rng(seed)
    cands = rng.integers(0, n_items, size=(P, n_negatives), dtype=np.int64)
    users_b = np.broadcast_to(test_u[:, None], cands.shape)
    bad = is_seen(users_b.ravel(), cands.ravel()).reshape(cands.shape)
    bad |= cands == test_i[:, None]
    for _ in range(max_resample_rounds):
        n_bad = int(bad.sum())
        if n_bad == 0:
            break
        redraw = rng.integers(0, n_items, size=n_bad, dtype=np.int64)
        cands[bad] = redraw
        bu = np.broadcast_to(test_u[:, None], cands.shape)[bad]
        still = is_seen(bu, redraw) | (redraw == test_i[:, None].repeat(
            n_negatives, 1)[bad])
        nb = np.zeros_like(bad)
        nb[bad] = still
        bad = nb
    if bad.any():
        # Dense users: rejection sampling stalls when a user has rated most
        # items; sample from the true unseen set, with replacement when it
        # is smaller than the slots left.
        for p in np.flatnonzero(bad.any(axis=1)):
            u = int(test_u[p])
            lo = np.searchsorted(train_keys, u * n_items)
            hi = np.searchsorted(train_keys, (u + 1) * n_items)
            seen = (train_keys[lo:hi] % n_items).astype(np.int64)
            unseen = np.setdiff1d(np.arange(n_items, dtype=np.int64),
                                  np.concatenate([seen, [test_i[p]]]),
                                  assume_unique=False)
            cells = np.flatnonzero(bad[p])
            if len(unseen) == 0:
                raise RuntimeError(
                    f"user {u} has rated the entire catalog; no negatives "
                    "exist for the sampled protocol")
            cands[p, cells] = rng.choice(unseen, size=len(cells),
                                         replace=len(unseen) < len(cells))

    tu, ti, tc = _ids(test_u, dev), _ids(test_i, dev), _ids(cands, dev)
    ranks = []
    for s in range(0, P, batch):
        rows = gather_rows(theta, tu[s : s + batch])
        target = edge_dot(rows, gather_rows(beta, ti[s : s + batch]))
        ranks.append(_sampled_ranks(rows, beta[tc[s : s + batch]], target))
    ranks = torch.cat(ranks).double().cpu().numpy()

    out = {"n_pairs": P, "n_negatives": n_negatives, "mean_rank": float(ranks.mean())}
    for k in ks:
        hit = ranks <= k
        out[f"hr@{k}"] = float(hit.mean())
        out[f"ndcg@{k}"] = float(np.where(hit, 1.0 / np.log2(ranks + 1.0), 0.0).mean())
    return out
