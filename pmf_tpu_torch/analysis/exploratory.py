"""Exploratory dataset analysis: the rating distribution, user-activity
and item-popularity long tails (log-log rank-frequency) and the split
counts, written under reports/figures/exploratory_analysis/.

    python -m pmf_tpu_torch.analysis.exploratory [--synthetic N] [--raw]

Host work only (pandas, numpy, matplotlib).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd

from pmf_tpu_torch.cli.common import add_data_args, get_splits

OUT_DIR = os.path.join("reports", "figures", "exploratory_analysis")


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def split_stats(train_df, val_df, test_df) -> dict:
    df = pd.concat([train_df, val_df, test_df])
    return {
        "n_users": int(df["u"].nunique()),
        "n_items": int(df["i"].nunique()),
        "n_train": len(train_df),
        "n_val": len(val_df),
        "n_test": len(test_df),
        "mean_rating": float(df["rating"].mean()),
    }


def analyze_processed(train_df, val_df, test_df, out_dir=OUT_DIR):
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    df = pd.concat([train_df, val_df, test_df])

    # Ratings distribution.
    fig, ax = plt.subplots(figsize=(7, 4))
    df["rating"].value_counts().sort_index().plot.bar(ax=ax)
    ax.set_xlabel("rating")
    ax.set_ylabel("count")
    ax.set_title("Rating distribution (processed)")
    fig.savefig(os.path.join(out_dir, "rating_distribution.png"), dpi=120,
                bbox_inches="tight")
    plt.close(fig)

    # Long-tail rank-frequency plots.
    for col, name in (("u", "user_activity"), ("i", "item_popularity")):
        counts = df[col].value_counts().to_numpy()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.loglog(np.arange(1, len(counts) + 1), np.sort(counts)[::-1])
        ax.set_xlabel("rank")
        ax.set_ylabel("ratings")
        ax.set_title(f"{name} long tail")
        ax.grid(True, which="both", alpha=0.3)
        fig.savefig(os.path.join(out_dir, f"{name}_longtail.png"), dpi=120,
                    bbox_inches="tight")
        plt.close(fig)

    stats = split_stats(train_df, val_df, test_df)
    with open(os.path.join(out_dir, "split_stats.txt"), "w") as f:
        for k, v in stats.items():
            f.write(f"{k}: {v}\n")
    print(f"Wrote exploratory figures to {out_dir}: {stats}")
    return stats


def analyze_raw(raw_dir: str = "data/raw", out_dir: str = OUT_DIR):
    """Raw-data stats: the rating histogram and the user/item long tails
    straight from RAW_interactions.csv."""
    plt = _plt()
    path = os.path.join(raw_dir, "RAW_interactions.csv")
    if not os.path.exists(path):
        print(f"skip raw analysis: {path} not found")
        return None
    os.makedirs(out_dir, exist_ok=True)
    df = pd.read_csv(path, usecols=["user_id", "recipe_id", "rating"])

    fig, ax = plt.subplots(figsize=(7, 4))
    df["rating"].value_counts().sort_index().plot.bar(ax=ax)
    ax.set_title("Rating distribution (raw)")
    fig.savefig(os.path.join(out_dir, "raw_rating_distribution.png"), dpi=120,
                bbox_inches="tight")
    plt.close(fig)
    for col, name in (("user_id", "raw_user_activity"), ("recipe_id", "raw_item_popularity")):
        counts = df[col].value_counts().to_numpy()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.loglog(np.arange(1, len(counts) + 1), np.sort(counts)[::-1])
        ax.set_title(f"{name} long tail")
        fig.savefig(os.path.join(out_dir, f"{name}_longtail.png"), dpi=120,
                    bbox_inches="tight")
        plt.close(fig)
    stats = {"n_rows": len(df), "n_users": int(df["user_id"].nunique()),
             "n_items": int(df["recipe_id"].nunique())}
    print(f"raw stats: {stats}")
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(description="Exploratory analysis")
    parser.add_argument("--raw", action="store_true",
                        help="also analyze data/raw/RAW_interactions.csv")
    parser.add_argument("--raw_dir", default="data/raw")
    parser.add_argument("--out_dir", default=OUT_DIR)
    add_data_args(parser)
    args = parser.parse_args(argv)
    if args.raw:
        analyze_raw(args.raw_dir, args.out_dir)
    train_df, val_df, test_df = get_splits(args)
    return analyze_processed(train_df, val_df, test_df, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
