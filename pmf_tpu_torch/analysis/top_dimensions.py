"""Latent-dimension interpretation: score each latent dimension by its
divergence, mean(top-n) - mean(bottom-n) item loadings, pick the top
dimensions, and write the names of each one's top and bottom items
(joined to RAW_recipes.csv when it is there).

    python -m pmf_tpu_torch.analysis.top_dimensions --model gaussian_mf \
        [--n_dim 5] [--n_items 10]

Host work only, on train_full's item_embeddings.csv.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd

OUT_ROOT = os.path.join("reports", "figures", "Top_recepies_dim")


def _load_recipe_names(data_dir: str):
    path = os.path.join(data_dir, "raw", "RAW_recipes.csv")
    if not os.path.exists(path):
        return None
    raw = pd.read_csv(path, usecols=["id", "name"])
    return dict(zip(raw["id"], raw["name"]))


def analyze_top_dimensions(model: str, n_dim: int = 5, n_items: int = 10,
                           data_dir: str = "data", out_root: str = OUT_ROOT):
    emb_path = os.path.join(data_dir, "embeddings", model, "item_embeddings.csv")
    if not os.path.exists(emb_path):
        raise FileNotFoundError(f"{emb_path} not found — run train_full first")
    emb = pd.read_csv(emb_path)
    recipe_ids = emb["recipe_id"].to_numpy() if "recipe_id" in emb.columns else None
    loadings = emb.drop(columns=["recipe_id"], errors="ignore").to_numpy()
    names = _load_recipe_names(data_dir)

    # Divergence score per dimension: mean(top-n) - mean(bottom-n) loadings.
    order = np.argsort(loadings, axis=0)
    top_mean = loadings[order[-n_items:], np.arange(loadings.shape[1])].mean(0)
    bot_mean = loadings[order[:n_items], np.arange(loadings.shape[1])].mean(0)
    divergence = top_mean - bot_mean
    top_dims = np.argsort(divergence)[::-1][:n_dim]

    def label(k):
        rid = recipe_ids[k] if recipe_ids is not None else k
        return names.get(rid, f"recipe_id={rid}") if names else f"item={k}"

    out_dir = os.path.join(out_root, model)
    os.makedirs(out_dir, exist_ok=True)
    summary = []
    for d in top_dims:
        lines = [f"Dimension {d} (divergence {divergence[d]:.4f})", "", "TOP items:"]
        for k in order[-n_items:, d][::-1]:
            lines.append(f"  {loadings[k, d]: .4f}  {label(k)}")
        lines += ["", "BOTTOM items:"]
        for k in order[:n_items, d]:
            lines.append(f"  {loadings[k, d]: .4f}  {label(k)}")
        with open(os.path.join(out_dir, f"dim_{d}.txt"), "w") as f:
            f.write("\n".join(lines))
        summary.append({"dim": int(d), "divergence": float(divergence[d])})
    print(f"Wrote {len(top_dims)} dimension reports to {out_dir}")
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description="Interpret top latent dimensions")
    parser.add_argument("--model", default="gaussian_mf")
    parser.add_argument("--n_dim", type=int, default=5)
    parser.add_argument("--n_items", type=int, default=10)
    parser.add_argument("--data_dir", default="data")
    args = parser.parse_args(argv)
    return analyze_top_dimensions(args.model, args.n_dim, args.n_items, args.data_dir)


if __name__ == "__main__":
    main()
