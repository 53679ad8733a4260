"""Forecast diagnostics: read each model's test_predictions.csv, compute
RMSE / MAE / MSE / R^2, render per-true-rating prediction histograms,
residual scatter and boxplots, and write reports/forecast_metrics.csv
and reports/forecast_analysis.md.

    python -m pmf_tpu_torch.analysis.forecasts [--data_dir data]

Host work only (pandas, numpy, matplotlib) on train_full's CSVs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd

MODELS = ["gaussian_mf", "poisson_mf", "hpf_cavi", "hpf_pytorch"]
REPORT_DIR = "reports"


def compute_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    err = y_true - y_pred
    mse = float(np.mean(err**2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    r2 = 1.0 - float(np.sum(err**2)) / ss_tot if ss_tot > 0 else float("nan")
    return {
        "rmse": float(np.sqrt(mse)),
        "mae": float(np.mean(np.abs(err))),
        "mse": mse,
        "r2": r2,
    }


def _plots(model: str, df: pd.DataFrame, fig_dir: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(fig_dir, exist_ok=True)
    y_true = df["y_true"].to_numpy()
    y_pred = df["y_pred"].to_numpy()

    # Per-true-rating prediction histograms.
    values = np.unique(y_true)
    fig, axes = plt.subplots(1, len(values), figsize=(3 * len(values), 3), sharey=True)
    axes = np.atleast_1d(axes)
    for ax, v in zip(axes, values):
        ax.hist(y_pred[y_true == v], bins=30)
        ax.set_title(f"true={v:g}")
    fig.suptitle(f"{model}: prediction histograms by true rating")
    fig.savefig(os.path.join(fig_dir, f"{model}_pred_hist.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)

    # Residual scatter + per-class boxplot.
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    sample = np.random.default_rng(0).choice(len(df), size=min(len(df), 20000), replace=False)
    ax1.scatter(y_true[sample], (y_pred - y_true)[sample], s=2, alpha=0.2)
    ax1.axhline(0, color="k", lw=1)
    ax1.set_xlabel("true rating")
    ax1.set_ylabel("residual")
    ax2.boxplot([y_pred[y_true == v] for v in values], tick_labels=[f"{v:g}" for v in values],
                showfliers=False)
    ax2.set_xlabel("true rating")
    ax2.set_ylabel("prediction")
    fig.suptitle(f"{model}: residuals")
    fig.savefig(os.path.join(fig_dir, f"{model}_residuals.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)


def collect(data_dir: str, models=MODELS) -> dict:
    """{model: its test_predictions frame} for the models that have one."""
    frames = {}
    for model in models:
        path = os.path.join(data_dir, "predictions", model, "test_predictions.csv")
        if not os.path.exists(path):
            print(f"skip {model}: {path} not found")
            continue
        frames[model] = pd.read_csv(path)
    return frames


def write_report(frames: dict, report_dir: str) -> pd.DataFrame:
    """forecast_metrics.csv and forecast_analysis.md from ``collect``'s
    frames; returns the metrics table."""
    rows = []
    for model, df in frames.items():
        metrics = compute_metrics(df["y_true"].to_numpy(), df["y_pred"].to_numpy())
        rows.append({"model": model, **metrics})
        print(f"{model}: {metrics}")
    os.makedirs(report_dir, exist_ok=True)
    out = pd.DataFrame(rows)
    out.to_csv(os.path.join(report_dir, "forecast_metrics.csv"), index=False)
    with open(os.path.join(report_dir, "forecast_analysis.md"), "w") as f:
        f.write("# Forecast analysis\n\n")
        f.write(out.to_markdown(index=False))
        f.write("\n\nFigures: `reports/figures/forecasts/`\n")
    print(f"Wrote {report_dir}/forecast_metrics.csv and forecast_analysis.md")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Forecast diagnostics")
    parser.add_argument("--data_dir", default="data")
    parser.add_argument("--report_dir", default=REPORT_DIR)
    parser.add_argument("--models", nargs="+", default=MODELS)
    args = parser.parse_args(argv)

    frames = collect(args.data_dir, args.models)
    if not frames:
        print("No predictions found.")
        return None
    fig_dir = os.path.join(args.report_dir, "figures", "forecasts")
    for model, df in frames.items():
        _plots(model, df, fig_dir)
    return write_report(frames, args.report_dir)


if __name__ == "__main__":
    main()
