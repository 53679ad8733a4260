"""Dataset pipeline: Kaggle download, unzip, filter and split
preprocessing, split loading.  The same steps, files and bytes as the JAX
package's ``data/pipeline.py``:

  * download: the kaggle CLI fetches
    shuyangli94/food-com-recipes-and-user-interactions into data/raw.
  * unzip: extract every raw zip in place.
  * preprocess: concatenate the three Kaggle interaction splits; keep
    recipes with >= 10 ratings, then users with >= 5; shuffle within each
    user by a fresh RandomState(42) permutation (pandas'
    ``g.sample(frac=1, random_state=42)``); per user the last rating to
    test, the two before it to validation, the rest to train; dense
    contiguous id maps written as dict_u.csv (user_id, u) and dict_i.csv
    (recipe_id, i).
  * load: per-split u/i/rating frames, and the centred loader that
    subtracts the train-only mean from every split.

Everything here runs on the host with pandas and numpy.
"""

from __future__ import annotations

import os
import subprocess
import zipfile

import numpy as np
import pandas as pd

from pmf_tpu_torch.data.native import parse_interactions_csv

DATASET = "shuyangli94/food-com-recipes-and-user-interactions"
RAW_DIR = os.path.join("data", "raw")
PROCESSED_DIR = os.path.join("data", "processed")


def download_dataset(raw_dir: str = RAW_DIR) -> None:
    """Fetch the Kaggle dataset with the kaggle CLI (credentials required)."""
    os.makedirs(raw_dir, exist_ok=True)
    subprocess.run(
        ["kaggle", "datasets", "download", "-d", DATASET, "-p", raw_dir],
        check=True,
    )


def unzip_files(raw_dir: str = RAW_DIR) -> None:
    for name in sorted(os.listdir(raw_dir)):
        if name.endswith(".zip"):
            with zipfile.ZipFile(os.path.join(raw_dir, name)) as zf:
                zf.extractall(raw_dir)


def preprocess_data(raw_dir: str = RAW_DIR, processed_dir: str = PROCESSED_DIR) -> None:
    """Filter and per-user leave-out split of the raw interaction files."""
    frames = [
        pd.read_csv(
            os.path.join(raw_dir, f"interactions_{split}.csv"),
            usecols=["user_id", "recipe_id", "rating"],
        )
        for split in ("train", "validation", "test")
    ]
    df = pd.concat(frames, ignore_index=True)

    # Recipes with >= 10 ratings, then users with >= 5 interactions.
    recipe_counts = df["recipe_id"].value_counts()
    df = df[df["recipe_id"].isin(recipe_counts[recipe_counts >= 10].index)]
    user_counts = df["user_id"].value_counts()
    df = df[df["user_id"].isin(user_counts[user_counts >= 5].index)]

    # Per-user shuffle: a fresh RandomState(42) permutation per user group,
    # groups in sorted user order, as pandas' groupby-sample draws it.
    df = df.sort_values("user_id", kind="stable").reset_index(drop=True)
    sizes = df.groupby("user_id", sort=True).size().to_numpy()
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    take = np.empty(len(df), dtype=np.int64)
    for s, n in zip(starts, sizes):
        take[s : s + n] = s + np.random.RandomState(42).permutation(n)
    df = df.iloc[take].reset_index(drop=True)
    idx_in_user = np.concatenate([np.arange(n) for n in sizes])
    total = np.repeat(sizes, sizes)

    # Last rating -> test, the two before it -> validation, rest -> train.
    remaining = total - (idx_in_user + 1)
    split = np.where(remaining == 0, "3.test", np.where(remaining <= 2, "2.val", "1.train"))
    df = df.assign(split=split)

    # Dense contiguous id maps in raw-id order.
    dict_i = (
        df[["recipe_id"]].drop_duplicates().sort_values("recipe_id")
        .reset_index(drop=True).assign(i=lambda t: t.index)
    )
    dict_u = (
        df[["user_id"]].drop_duplicates().sort_values("user_id")
        .reset_index(drop=True).assign(u=lambda t: t.index)
    )
    df = df.merge(dict_i, on="recipe_id").merge(dict_u, on="user_id")

    os.makedirs(processed_dir, exist_ok=True)
    for tag, name in (("1.train", "train"), ("2.val", "validation"), ("3.test", "test")):
        df[df["split"] == tag].to_csv(
            os.path.join(processed_dir, f"interactions_{name}.csv"), index=False
        )
    dict_i.to_csv(os.path.join(processed_dir, "dict_i.csv"), index=False)
    dict_u.to_csv(os.path.join(processed_dir, "dict_u.csv"), index=False)


def load_interactions(split: str, processed_dir: str = PROCESSED_DIR) -> pd.DataFrame:
    """Load one processed split as a u/i/rating frame (int64 ids, float64
    ratings), parsed by the native C++ reader (``data.native``; pandas
    where it does not build), as the JAX package's.  The ratings are
    integers, so both readers give the same frame."""
    path = os.path.join(processed_dir, f"interactions_{split}.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(f"File not found: {path}")
    u, i, x = parse_interactions_csv(path)
    return pd.DataFrame({"u": u, "i": i, "rating": x})


def load_all_splits(processed_dir: str = PROCESSED_DIR):
    return (
        load_interactions("train", processed_dir),
        load_interactions("validation", processed_dir),
        load_interactions("test", processed_dir),
    )


def load_all_splits_centered(processed_dir: str = PROCESSED_DIR):
    """Every split centred by the train-only mean; returns the three
    frames and that mean."""
    train, val, test = load_all_splits(processed_dir)
    global_mean = train["rating"].mean()
    out = []
    for frame in (train, val, test):
        c = frame.copy()
        c["rating"] = c["rating"] - global_mean
        out.append(c)
    return (*out, global_mean)


def legacy_generate_processed_data(raw_dir: str = RAW_DIR, processed_dir: str = PROCESSED_DIR,
                                   seed: int = 42):
    """The superseded alternative preprocessing: RAW_interactions mapped to
    dense ids through the user map of the Kaggle interaction splits and
    the recipe map of PP_recipes, recipes with >= 10 reviews kept, written
    as interactions_processed.csv, then a shuffled 80/10/10 row split
    into train/val/test.csv."""
    raw = pd.read_csv(os.path.join(raw_dir, "RAW_interactions.csv"))
    pp_recipes = pd.read_csv(os.path.join(raw_dir, "PP_recipes.csv"))

    # user_id -> u map from the Kaggle splits' own columns.
    frames = [
        pd.read_csv(os.path.join(raw_dir, f"interactions_{s}.csv"))
        for s in ("train", "test", "validation")
    ]
    user_map = pd.concat(frames)[["user_id", "u"]].drop_duplicates()
    user_map = user_map.drop_duplicates(subset=["user_id"])
    recipe_map = pp_recipes[["id", "i"]].rename(columns={"id": "recipe_id"})

    df = raw.merge(user_map, on="user_id", how="inner")
    df = df.merge(recipe_map, on="recipe_id", how="inner")

    counts = df.groupby("recipe_id").size()
    df = df[df["recipe_id"].isin(counts[counts >= 10].index)].copy()
    keep = [c for c in ("user_id", "recipe_id", "date", "rating", "u", "i")
            if c in df.columns]
    df = df[keep]

    os.makedirs(processed_dir, exist_ok=True)
    df.to_csv(os.path.join(processed_dir, "interactions_processed.csv"), index=False)

    shuffled = df.sample(frac=1, random_state=seed).reset_index(drop=True)
    n = len(shuffled)
    parts = {
        "train": shuffled.iloc[: int(n * 0.8)],
        "val": shuffled.iloc[int(n * 0.8) : int(n * 0.9)],
        "test": shuffled.iloc[int(n * 0.9) :],
    }
    for name, part in parts.items():
        part.to_csv(os.path.join(processed_dir, f"{name}.csv"), index=False)
    return parts
