"""Synthetic ratings generators (numpy), kept in the port so it needs
nothing of the JAX package.

``synth_ratings`` / ``synth_splits`` give the small long-tail datasets the
tests use; ``synth`` is the benchmark's Zipf generator (162k x 59k x 25M
at the headline scale), so ``chip_smoke.py`` makes its data in-repo.
All three draw the same numbers as the JAX package's generators for the
same arguments.
"""

from __future__ import annotations

import numpy as np


def synth_ratings(
    n_users: int,
    n_items: int,
    n_ratings: int,
    seed: int = 0,
    rating_values: tuple = (0, 1, 2, 3, 4, 5),
    skew: float = 1.2,
):
    """Draw (u, i, x) triples with Zipf-ish popularity and a skewed rating
    distribution (most ratings 4-5).  Duplicate (u, i) pairs are dropped
    (keeping the first), and every user/item index below n_users/n_items
    gets at least one rating so inferred dimensions are deterministic."""
    rng = np.random.default_rng(seed)

    u_weights = (1.0 + np.arange(n_users)) ** (-skew / 2)
    i_weights = (1.0 + np.arange(n_items)) ** (-skew)
    u_weights /= u_weights.sum()
    i_weights /= i_weights.sum()

    n_draw = int(n_ratings * 1.3) + n_users + n_items
    u = rng.choice(n_users, size=n_draw, p=u_weights)
    i = rng.choice(n_items, size=n_draw, p=i_weights)

    u[:n_users] = np.arange(n_users)
    i[:n_users] = rng.integers(0, n_items, size=n_users)
    u[n_users : n_users + n_items] = rng.integers(0, n_users, size=n_items)
    i[n_users : n_users + n_items] = np.arange(n_items)

    key = u.astype(np.int64) * n_items + i
    _, first = np.unique(key, return_index=True)
    first.sort()
    first = first[:n_ratings]
    u, i = u[first], i[first]

    probs = np.array([0.05, 0.02, 0.03, 0.08, 0.22, 0.60])
    probs = probs[: len(rating_values)] / probs[: len(rating_values)].sum()
    x = rng.choice(np.asarray(rating_values, dtype=np.float64), size=u.shape[0], p=probs)

    order = rng.permutation(u.shape[0])
    return u[order].astype(np.int64), i[order].astype(np.int64), x[order]


def synth_splits(n_users: int, n_items: int, n_ratings: int, seed: int = 0):
    """Train/val/test triples with a per-user leave-out: last rating to
    test, next two to val, the rest to train (users with >= 4 ratings)."""
    u, i, x = synth_ratings(n_users, n_items, n_ratings, seed=seed)
    rng = np.random.default_rng(seed + 1)

    order = np.lexsort((rng.random(u.shape[0]), u))
    u, i, x = u[order], i[order], x[order]

    _, starts, counts = np.unique(u, return_index=True, return_counts=True)
    pos_from_end = np.zeros(u.shape[0], dtype=np.int64)
    for s, c in zip(starts, counts):
        pos_from_end[s : s + c] = c - 1 - np.arange(c)

    is_test = (pos_from_end == 0) & (np.repeat(counts, counts) >= 4)
    is_val = (pos_from_end >= 1) & (pos_from_end <= 2) & (np.repeat(counts, counts) >= 4)
    is_train = ~(is_test | is_val)

    def pick(m):
        return u[m], i[m], x[m]

    return pick(is_train), pick(is_val), pick(is_test)


def synth(n_users: int, n_items: int, nnz: int, seed: int = 0):
    """The benchmark's Zipf data: item popularity ~ 1/rank, user activity
    ~ rank^-0.7, integer ratings 1..5 (duplicates kept), every user and
    item present.  Returns int64 ids and float32 ratings."""
    rng = np.random.default_rng(seed)
    iw = (1.0 + np.arange(n_items)) ** -1.0
    iw /= iw.sum()
    uw = (1.0 + np.arange(n_users)) ** -0.7
    uw /= uw.sum()
    u = rng.choice(n_users, size=nnz, p=uw).astype(np.int64)
    i = rng.choice(n_items, size=nnz, p=iw).astype(np.int64)
    u[:n_users] = np.arange(n_users)
    i[:n_items] = np.arange(n_items)
    x = (1.0 + rng.integers(0, 5, size=nnz)).astype(np.float32)
    return u, i, x
