"""Synthetic ratings generators (numpy), kept in the port so it needs
nothing of the JAX package.

``synth_ratings`` / ``synth_splits`` give the small long-tail datasets the
tests use; ``synth`` is the benchmark's Zipf generator (162k x 59k x 25M
at the headline scale), so ``chip_smoke.py`` makes its data in-repo;
``synth_planted`` draws ratings from a planted bias + low-rank model,
``synth_foodcom_raw`` writes a Food.com-shaped raw dataset and
``leave_out_split`` is the vectorized per-user leave-out.  Each draws the
same numbers, in the same call order, as the JAX package's generator of
the same name for the same arguments.
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


def synth_foodcom_raw(
    raw_dir: str,
    n_users: int = 25076,
    n_items: int = 178265,
    n_raw: int = 1_130_000,
    seed: int = 7,
    s_item: float = 0.9,
    s_user: float = 0.7,
) -> dict:
    """Write a Food.com-shaped synthetic raw Kaggle dataset into
    ``raw_dir``: ``interactions_{train,validation,test}.csv`` with columns
    ``user_id, recipe_id, rating``, the three files the preprocessing
    reads.

    25,076 raw users x 178,265 raw items; Zipf item popularity and
    heavy-tailed per-user activity calibrated so the preprocessing filter
    (items >= 10 ratings, then users >= 5 interactions) keeps ~700k
    interactions.  User/recipe ids are non-contiguous large integers so
    the dense re-indexing is exercised.

    Returns a stats dict (raw/kept counts)."""
    import os

    import pandas as pd

    rng = np.random.default_rng(seed)

    iw = (1.0 + np.arange(n_items)) ** (-s_item)
    uw = (1.0 + np.arange(n_users)) ** (-s_user)
    iw /= iw.sum()
    uw /= uw.sum()
    u = rng.choice(n_users, size=n_raw, p=uw)
    i = rng.choice(n_items, size=n_raw, p=iw)

    # Food.com-like rating profile: mostly 4-5 stars, some zeros.
    probs = np.array([0.05, 0.02, 0.03, 0.08, 0.22, 0.60])
    x = rng.choice(np.arange(6), size=n_raw, p=probs / probs.sum())

    # Sparse large external ids (sorted-unique draw keeps them distinct).
    user_ids = np.sort(rng.choice(30_000_000, size=n_users, replace=False))
    recipe_ids = np.sort(rng.choice(600_000, size=n_items, replace=False))

    df = pd.DataFrame(
        {"user_id": user_ids[u], "recipe_id": recipe_ids[i], "rating": x}
    )
    # Kaggle ships three raw shards; proportions are immaterial (the
    # preprocessing concatenates them).
    perm = rng.permutation(n_raw)
    cut1, cut2 = int(n_raw * 0.7), int(n_raw * 0.85)
    os.makedirs(raw_dir, exist_ok=True)
    for name, sl in (
        ("train", perm[:cut1]),
        ("validation", perm[cut1:cut2]),
        ("test", perm[cut2:]),
    ):
        df.iloc[sl].to_csv(
            os.path.join(raw_dir, f"interactions_{name}.csv"), index=False
        )

    ic = np.bincount(i, minlength=n_items)
    keep_i = ic >= 10
    mask = keep_i[i]
    uc = np.bincount(u[mask], minlength=n_users)
    keep_u = uc >= 5
    kept = int((keep_u[u] & mask).sum())
    return {
        "n_raw": n_raw,
        "raw_users": n_users,
        "raw_items": n_items,
        "kept_interactions": kept,
        "kept_users": int(keep_u.sum()),
        "kept_items": int(keep_i.sum()),
    }


def synth_planted(
    n_users: int,
    n_items: int,
    n_ratings: int,
    K_true: int = 8,
    seed: int = 0,
    noise: float = 0.45,
    mu: float = 3.4,
    bias_scale: float = 0.40,
    factor_var: float = 0.55,
    draw_factor: float = 1.25,
):
    """Zipf-sampled (u, i) pairs whose ratings come from a PLANTED
    bias + low-rank model, rounded and clipped to the 0-5 star scale:

        x_ui = clip(round(mu + b_u + c_i + theta_u . beta_i + eps), 0, 5)

    Unlike :func:`synth_ratings` (i.i.d. ratings — nothing to learn
    beyond the marginal), this gives converged-quality runs a real
    signal: a factor model can drive test RMSE toward the generative
    floor  sqrt(noise^2 + 1/12-ish rounding variance)  while a
    bias-only predictor plateaus ~sqrt(floor^2 + factor_var) higher.
    Defaults keep mu ~3.3 sigma from the clip edges (a 4+ mu saturates
    the 5-star bin and erases most of the planted variance) with an
    ML-25M-like overall rating spread (~std 1.0 around 3.4).

    Returns (u, i, x, floor_rmse) with x float64 in {0..5}."""
    rng = np.random.default_rng(seed)

    iw = (1.0 + np.arange(n_items)) ** -1.0
    iw /= iw.sum()
    uw = (1.0 + np.arange(n_users)) ** -0.7
    uw /= uw.sum()
    # Zipf sampling duplicates heavily at scale: 31.5M draws over
    # 162k x 59k yield only ~20.8M unique pairs (66%).  Callers that need
    # the full n_ratings UNIQUE edges (the ML-25M converged run: 25M
    # ratings like the real dataset) pass a larger draw_factor; the
    # default keeps the historical RNG stream byte-identical.
    n_draw = int(n_ratings * draw_factor) + n_users + n_items
    u = rng.choice(n_users, size=n_draw, p=uw)
    i = rng.choice(n_items, size=n_draw, p=iw)
    u[:n_users] = np.arange(n_users)
    i[:n_users] = rng.integers(0, n_items, size=n_users)
    u[n_users : n_users + n_items] = rng.integers(0, n_users, size=n_items)
    i[n_users : n_users + n_items] = np.arange(n_items)

    key = u.astype(np.int64) * n_items + i
    _, first = np.unique(key, return_index=True)
    first.sort()
    first = first[:n_ratings]
    u, i = u[first].astype(np.int64), i[first].astype(np.int64)

    b_u = (bias_scale * rng.standard_normal(n_users)).astype(np.float32)
    c_i = (bias_scale * rng.standard_normal(n_items)).astype(np.float32)
    # var(theta_u . beta_i) = K * var(theta_k) * var(beta_k) = K * sf^4
    # for independent N(0, sf^2) entries -> sf = (factor_var / K)^(1/4).
    sf = (factor_var / K_true) ** 0.25
    theta = (sf * rng.standard_normal((n_users, K_true))).astype(np.float32)
    beta = (sf * rng.standard_normal((n_items, K_true))).astype(np.float32)

    raw = (
        mu
        + b_u[u]
        + c_i[i]
        + np.einsum("ek,ek->e", theta[u], beta[i])
        + noise * rng.standard_normal(len(u)).astype(np.float32)
    )
    x = np.clip(np.rint(raw), 0.0, 5.0).astype(np.float64)
    # Generative-floor estimate: RMSE of the oracle predictor E[x | u, i]
    # is bounded below by the noise+rounding spread (clipping shrinks it
    # slightly at the scale edges); report the unclipped analytic value.
    floor_rmse = float(np.sqrt(noise**2 + 1.0 / 12.0))

    order = rng.permutation(len(u))
    return u[order], i[order], x[order], floor_rmse


def leave_out_split(u, i, x, seed: int = 0, n_test: int = 1, n_val: int = 2):
    """Vectorized per-user leave-out split: for users with >=
    n_test + n_val + 1 ratings, the last ``n_test`` go to test and the
    next ``n_val`` to validation (after a per-user shuffle); everything
    else trains.  Scales to 25M edges (no Python per-user loop)."""
    u = np.asarray(u, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    x = np.asarray(x, dtype=np.float64)
    rng = np.random.default_rng(seed + 1)
    order = np.lexsort((rng.random(len(u)), u))
    u, i, x = u[order], i[order], x[order]

    uniq, starts, counts = np.unique(u, return_index=True, return_counts=True)
    group_end = starts + counts  # first index past each user's run
    pos_from_end = np.repeat(group_end, counts) - 1 - np.arange(len(u))
    big = np.repeat(counts, counts) >= n_test + n_val + 1
    is_test = (pos_from_end < n_test) & big
    is_val = (pos_from_end >= n_test) & (pos_from_end < n_test + n_val) & big
    is_train = ~(is_test | is_val)

    def pick(m):
        return u[m], i[m], x[m]

    return pick(is_train), pick(is_val), pick(is_test)


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
