"""Model item index -> recipe id, read from ``processed/dict_i.csv``.

Two schemas of that file exist: the canonical one that
``data.pipeline.preprocess_data`` writes, columns (recipe_id, i), and the
legacy one, columns (i_new, i), whose ``i`` is the Kaggle PP index joined
to a recipe id through ``raw/PP_recipes.csv``.  Both are read, as in the
JAX package's ``utils/mapping.py``.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd


def get_recipe_id_map(data_dir: str = "data") -> np.ndarray | None:
    """Return array with ``id_map[i] = recipe_id`` for model item index i
    (legacy rows without a recipe get -1); None, with a message, when a
    file is missing or the schema is neither."""
    dict_i_path = os.path.join(data_dir, "processed", "dict_i.csv")
    if not os.path.exists(dict_i_path):
        print(f"Error: {dict_i_path} not found.")
        return None
    dict_df = pd.read_csv(dict_i_path)

    if {"recipe_id", "i"} <= set(dict_df.columns):
        dict_df = dict_df.sort_values("i")
        n_items = int(dict_df["i"].max()) + 1
        id_map = np.zeros(n_items, dtype=np.int64)
        id_map[dict_df["i"].to_numpy()] = dict_df["recipe_id"].to_numpy()
        return id_map

    if {"i_new", "i"} <= set(dict_df.columns):
        pp_path = os.path.join(data_dir, "raw", "PP_recipes.csv")
        if not os.path.exists(pp_path):
            print(f"Error: {pp_path} not found.")
            return None
        pp_df = pd.read_csv(pp_path, usecols=["id", "i"])
        merged = dict_df.merge(pp_df, on="i", how="left").sort_values("i_new")
        merged["id"] = merged["id"].fillna(-1)
        n_items = int(merged["i_new"].max()) + 1
        id_map = np.zeros(n_items, dtype=np.int64)
        id_map[merged["i_new"].to_numpy()] = merged["id"].astype(np.int64).to_numpy()
        return id_map

    print("Error: dict_i.csv has neither (recipe_id, i) nor (i_new, i) columns")
    return None
