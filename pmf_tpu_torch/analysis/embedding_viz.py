"""Embedding visualization: reduce item embeddings by PCA, t-SNE, UMAP or
a random sample of columns, render pair-grid scatter matrices
(optionally coloured by recipe tags), and write the figures under
reports/figures/dimension_reduction/<model>/.

Subsampling caps as in the reference: UMAP 10k rows, t-SNE 1k rows when
reducing to more than 3 components (else 5k).  UMAP is optional: when
``umap`` is not installed it is skipped with a message.

    python -m pmf_tpu_torch.analysis.embedding_viz --model gaussian_mf \
        --methods pca tsne sample --dim 3

Host work only (sklearn, matplotlib), on train_full's item_embeddings.csv.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd

OUT_ROOT = os.path.join("reports", "figures", "dimension_reduction")


def reduce_dimensions(x: np.ndarray, method: str, dim: int, seed: int = 42):
    """Return (reduced array, row indices used); (None, indices) when
    UMAP is asked for and not installed."""
    rng = np.random.default_rng(seed)
    idx = np.arange(len(x))
    if method == "pca":
        from sklearn.decomposition import PCA

        return PCA(n_components=dim, random_state=seed).fit_transform(x), idx
    if method == "tsne":
        from sklearn.manifold import TSNE

        cap = 1000 if dim > 3 else 5000
        if len(x) > cap:
            idx = rng.choice(len(x), size=cap, replace=False)
        return TSNE(n_components=min(dim, 3), random_state=seed,
                    init="pca").fit_transform(x[idx]), idx
    if method == "umap":
        try:
            import umap
        except ImportError:
            print("umap-learn not installed; skipping UMAP")
            return None, idx
        if len(x) > 10000:
            idx = rng.choice(len(x), size=10000, replace=False)
        return umap.UMAP(n_components=dim, random_state=seed).fit_transform(x[idx]), idx
    if method == "sample":
        cols = rng.choice(x.shape[1], size=min(dim, x.shape[1]), replace=False)
        return x[:, cols], idx
    raise ValueError(method)


def tag_colors(recipe_ids: np.ndarray, tags: list[str], data_dir: str = "data"):
    """Colour index per item: 1 + the index of the first matching tag in
    RAW_recipes.csv's tag lists, 0 when none matches; None when the raw
    file is not there."""
    import ast

    path = os.path.join(data_dir, "raw", "RAW_recipes.csv")
    if not os.path.exists(path) or not tags:
        return None
    raw = pd.read_csv(path, usecols=["id", "tags"])
    tag_map = {}
    for rid, tag_str in zip(raw["id"], raw["tags"]):
        try:
            tag_map[rid] = set(ast.literal_eval(tag_str))
        except (ValueError, SyntaxError):
            tag_map[rid] = set()
    colors = np.zeros(len(recipe_ids), dtype=int)
    for row, rid in enumerate(recipe_ids):
        item_tags = tag_map.get(rid, ())
        for t_idx, tag in enumerate(tags):
            if tag in item_tags:
                colors[row] = t_idx + 1
                break
    return colors


def plot_grid(reduced: np.ndarray, path: str, color=None, title: str = ""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = reduced.shape[1]
    fig, axes = plt.subplots(d, d, figsize=(2.5 * d, 2.5 * d))
    axes = np.atleast_2d(axes)
    for r in range(d):
        for c in range(d):
            ax = axes[r][c]
            if r == c:
                ax.hist(reduced[:, r], bins=40)
            else:
                ax.scatter(reduced[:, c], reduced[:, r], s=2, alpha=0.3,
                           c=color, cmap="tab10")
            if r == d - 1:
                ax.set_xlabel(f"dim {c}")
            if c == 0:
                ax.set_ylabel(f"dim {r}")
    fig.suptitle(title)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Embedding visualization")
    parser.add_argument("--model", default="gaussian_mf")
    parser.add_argument("--methods", nargs="+", default=["pca", "tsne", "umap", "sample"])
    parser.add_argument("--dim", type=int, default=3)
    parser.add_argument("--data_dir", default="data")
    parser.add_argument("--tags", nargs="*", default=None,
                        help="color items by these recipe tags (needs RAW_recipes.csv)")
    args = parser.parse_args(argv)

    emb_path = os.path.join(args.data_dir, "embeddings", args.model, "item_embeddings.csv")
    if not os.path.exists(emb_path):
        raise FileNotFoundError(f"{emb_path} not found — run train_full first")
    emb = pd.read_csv(emb_path)
    x = emb.drop(columns=["recipe_id"], errors="ignore").to_numpy()

    colors = None
    if args.tags and "recipe_id" in emb.columns:
        colors = tag_colors(emb["recipe_id"].to_numpy(), args.tags, args.data_dir)

    out_dir = os.path.join(OUT_ROOT, args.model)
    for method in args.methods:
        reduced, idx = reduce_dimensions(x, method, args.dim)
        if reduced is None:
            continue
        c = colors[idx] if colors is not None else None
        plot_grid(reduced, os.path.join(out_dir, f"{method}.png"), color=c,
                  title=f"{args.model}: {method} ({reduced.shape[1]}d)")
        print(f"wrote {out_dir}/{method}.png ({len(idx)} rows)")


if __name__ == "__main__":
    main()
