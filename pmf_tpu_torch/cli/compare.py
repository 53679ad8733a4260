"""Model comparison: train the four production models on the full splits
with tuned configs, collect train/val/test RMSE, macro-MAE and
wall-clock, render the 3-panel bar chart and write the params artifact.

    python -m pmf_tpu_torch.cli.compare [--synthetic N] [--hyperparams PATH]
        [--ranking] [--device cuda|cpu] [--mesh_devices N]

Each model runs inside its own try/except, so one model's failure does
not stop the run (as in the reference); a missing card or a kernel fault
raises out of the command.  With ``--mesh_devices N`` (under ``torchrun
--nproc_per_node N``) every fit is data-parallel over the ranks, the ranks
agree on each model's outcome before the next one starts, and rank 0
alone writes the plot and the params file.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import pandas as pd

from pmf_tpu_torch import config as cfg_io
from pmf_tpu_torch.cli.common import (
    add_data_args,
    add_device_arg,
    add_mesh_arg,
    get_splits,
    isolated,
    mesh_session,
    print_header,
    setup_runtime,
)
from pmf_tpu_torch.cli.run_single import DEFAULTS, run_model
from pmf_tpu_torch.models import GaussianMFConfig, HPFConfig, HPFMapConfig, PoissonMFConfig
from pmf_tpu_torch.utils.device import resolve_device

MODELS = [
    # (display name, run_single name, artifact key, config class)
    ("Gaussian MF (CAVI)", "gaussian_bias", cfg_io.GAUSSIAN_KEY, GaussianMFConfig),
    ("Poisson MF (CAVI)", "poisson", cfg_io.POISSON_KEY, PoissonMFConfig),
    ("HPF (CAVI)", "hpf_cavi", cfg_io.HPF_CAVI_KEY, HPFConfig),
    ("HPF (MAP)", "hpf_map", cfg_io.HPF_MAP_KEY, HPFMapConfig),
]


def _config_for(run_name, key, config_cls, hyperparams):
    raw = hyperparams.get(key)
    if raw:
        return config_cls(**cfg_io.filter_config_kwargs(config_cls, raw))
    return dataclasses.replace(DEFAULTS[run_name])


def compare_models(train_df, val_df, test_df, hyperparams: dict, verbose=False,
                   elbo_every: int = 0, ranking: bool = False, device=None, mesh=None):
    """Fit the four models; returns (results DataFrame or None when none
    succeeded, {display name: config used}).  ``ranking``: add test
    recall@10 / NDCG@10 (``eval.ranking``).  ``mesh``: every fit
    data-parallel over its ranks, each model kept or skipped on every rank
    alike (``cli.common.isolated``)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    rows, configs_used = [], {}
    for display, run_name, key, config_cls in MODELS:
        print_header(display)
        config = _config_for(run_name, key, config_cls, hyperparams)
        config.verbose = verbose
        configs_used[display] = config

        def fit_one():
            res = run_model(run_name, train_df, val_df, test_df, config=config,
                            elbo_every=elbo_every, verbose=verbose, device=device,
                            mesh=mesh)
            model = res.pop("_model", None)
            res["model"] = display
            if ranking and model is not None:
                from pmf_tpu_torch.eval.ranking import ranking_metrics

                theta, beta = model._point_estimates()
                r = ranking_metrics(
                    theta, beta,
                    train_df["u"].to_numpy(), train_df["i"].to_numpy(),
                    test_df["u"].to_numpy(), test_df["i"].to_numpy(),
                    ks=(10,),
                )
                res["test_recall@10"] = r["recall@10"]
                res["test_ndcg@10"] = r["ndcg@10"]
            return res

        res = isolated(display, fit_one, mesh)
        if res is None:
            continue
        rows.append(res)
        print(
            f"train/val/test RMSE: {res['train_rmse']:.3f} / "
            f"{res['val_rmse']:.3f} / {res['test_rmse']:.3f} | "
            f"time {res['fit_seconds']:.1f}s"
        )
    return (pd.DataFrame(rows) if rows else None), configs_used


def write_params(configs_used: dict, path: str) -> None:
    with open(path, "w") as f:
        for display, config in configs_used.items():
            f.write(f"{display}: {dataclasses.asdict(config)!r}\n")


def plot_results(results_df: pd.DataFrame, path: str) -> None:
    """3-panel bar chart: RMSE, macro-MAE, training time."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    x = np.arange(len(results_df))
    width = 0.25
    for k, split in enumerate(("train", "val", "test")):
        for ax, metric in ((axes[0], "rmse"), (axes[1], "macro_mae")):
            vals = results_df[f"{split}_{metric}"]
            bars = ax.bar(x + (k - 1) * width, vals, width, label=split.capitalize())
            for b, v in zip(bars, vals):
                ax.text(b.get_x() + b.get_width() / 2, v, f"{v:.3f}",
                        ha="center", va="bottom", fontsize=7)
    for ax, title in ((axes[0], "RMSE"), (axes[1], "Macro-MAE")):
        ax.set_xticks(x)
        ax.set_xticklabels(results_df["model"], rotation=20, ha="right")
        ax.set_title(title)
        ax.legend()
        ax.grid(True, axis="y", alpha=0.3)
    bars = axes[2].bar(x, results_df["fit_seconds"], color="tab:gray")
    for b, v in zip(bars, results_df["fit_seconds"]):
        axes[2].text(b.get_x() + b.get_width() / 2, v, f"{v:.1f}s",
                     ha="center", va="bottom", fontsize=8)
    axes[2].set_xticks(x)
    axes[2].set_xticklabels(results_df["model"], rotation=20, ha="right")
    axes[2].set_title("Training time (s)")
    axes[2].grid(True, axis="y", alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Compare all PMF models")
    parser.add_argument("--hyperparams", default="best_hyperparams.txt")
    parser.add_argument("--plot", default="model_comparison_plots.png")
    parser.add_argument("--params_out", default="model_comparison_params.txt")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--elbo", type=int, default=0, metavar="N",
                        help="record the ELBO every N iterations for the "
                             "CAVI models (0 = off)")
    parser.add_argument("--ranking", action="store_true",
                        help="also compute test recall@10 / NDCG@10 "
                             "(beyond the reference's metric set)")
    add_device_arg(parser)
    add_mesh_arg(parser)
    add_data_args(parser)
    args = parser.parse_args(argv)
    device = setup_runtime(args.device)
    with mesh_session(args.mesh_devices, args.device, "compare") as mesh:
        return _run(args, device, mesh)


def _run(args, device, mesh):
    train_df, val_df, test_df = get_splits(args)
    hyperparams = cfg_io.load_best_hyperparams(args.hyperparams)
    if hyperparams:
        print(f"Loaded tuned configs from {args.hyperparams}: {sorted(hyperparams)}")
    else:
        print("No best_hyperparams.txt found; using defaults.")

    results_df, configs_used = compare_models(
        train_df, val_df, test_df, hyperparams, verbose=args.verbose,
        elbo_every=args.elbo, ranking=args.ranking, device=device, mesh=mesh)
    if results_df is None:
        print("No model succeeded.")
        return None
    if mesh is None or mesh.is_writer:
        plot_results(results_df, args.plot)
        write_params(configs_used, args.params_out)
    print(f"\nWrote {args.plot} and {args.params_out}")
    print(results_df.drop(columns=[c for c in results_df.columns if c.startswith('_')])
          .to_string(index=False))
    return results_df


if __name__ == "__main__":
    main()
