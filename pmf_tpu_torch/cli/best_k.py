"""Best-K sweeps: fit over a range of latent dimensions, pick the K of
the highest validation log predictive likelihood, and plot RMSE-vs-K and
LPL-vs-K.

    python -m pmf_tpu_torch.cli.best_k --model {gaussian,poisson,hpf_cavi} \
        --k_min 2 --k_max 60 --k_step 2 [--seeds S] [--synthetic N]
        [--device cuda|cpu]

As in the reference and the JAX package, the HPF sweep does NOT apply
the +1 rating shift.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pmf_tpu_torch.cli.common import (
    add_data_args,
    add_device_arg,
    center,
    get_splits,
    print_header,
    setup_runtime,
)
from pmf_tpu_torch.eval.metrics import (
    gaussian_log_predictive_likelihood,
    poisson_log_predictive_likelihood,
)
from pmf_tpu_torch.models import (
    HPF,
    GaussianMF,
    GaussianMFConfig,
    HPFConfig,
    PoissonMF,
    PoissonMFConfig,
)
from pmf_tpu_torch.utils.device import resolve_device

FIG_DIR = os.path.join("reports", "figures")


def _plot(ks, values, ylabel, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(ks, values, marker="o")
    ax.set_xlabel("K (latent factors)")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def _seed_metrics(model_name, cfg, stacked, n_seeds, val_df, n_users, n_items):
    """Per-seed val RMSE / LPL from a multi-seed state stack (copied to
    the host once)."""
    vu = val_df["u"].to_numpy()
    vi = val_df["i"].to_numpy()
    vx = val_df["rating"].to_numpy()
    valid = (vu < n_users) & (vi < n_items)
    if model_name == "gaussian":
        thetas = stacked["m_theta"].cpu().numpy()
        betas = stacked["m_beta"].cpu().numpy()
    else:  # poisson / hpf_cavi: Gamma-mean rates
        thetas = (stacked["a_theta"] / stacked["b_theta"]).cpu().numpy()
        betas = (stacked["a_beta"] / stacked["b_beta"]).cpu().numpy()
    out = []
    for s in range(n_seeds):
        pred = np.zeros(len(vu))
        pred[valid] = np.sum(thetas[s][vu[valid]] * betas[s][vi[valid]], axis=1)
        rmse_s = float(np.sqrt(np.mean((vx - pred) ** 2)))
        if model_name == "gaussian":
            lpl = gaussian_log_predictive_likelihood(vx[valid], pred[valid],
                                                     np.sqrt(cfg.sigma2))
        else:
            lpl = poisson_log_predictive_likelihood(vx[valid], pred[valid])
        out.append({"seed": s, "val_rmse": rmse_s, "val_lpl": float(lpl)})
    return out


def _config(model_name, K, max_iter, verbose):
    if model_name == "gaussian":
        return GaussianMFConfig(
            n_factors=K, sigma2=2.0, eta_theta2=0.05, eta_beta2=0.05,
            max_iter=max_iter, tol=1e-3, use_bias=False, verbose=verbose)
    if model_name == "poisson":
        return PoissonMFConfig(n_factors=K, max_iter=max_iter, tol=1e-4, verbose=verbose)
    if model_name == "hpf_cavi":
        return HPFConfig(n_factors=K, max_iter=max_iter, tol=1e-4, verbose=verbose)
    raise ValueError(model_name)


def sweep(model_name, train_df, val_df, ks, max_iter=30, verbose=False,
          seeds: int = 1, device=None):
    """One row per K: val RMSE and val LPL.  ``seeds > 1``: per K, all
    seeds fit at once in one vmapped program (``tune.multi_seed``);
    the row carries the mean over seeds and each seed's numbers.
    ``device``: None = the CUDA card (raises without one)."""
    from pmf_tpu_torch.tune.multi_seed import multi_seed_fit

    device = resolve_device(device)
    if model_name not in ("gaussian", "poisson", "hpf_cavi"):
        raise ValueError(model_name)
    if model_name == "gaussian":
        train_c, val_c, mean = center(train_df, val_df)
    rows = []
    for K in ks:
        cfg = _config(model_name, K, max_iter, verbose)
        # Reference quirk kept: no +1 shift for HPF in the best-K sweep.
        tr, va = (train_c, val_c) if model_name == "gaussian" else (train_df, val_df)
        if seeds > 1:
            stacked, _ = multi_seed_fit(cfg, tr, va, seeds=tuple(range(seeds)),
                                        n_iter=max_iter, device=device)
            n_users = int(tr["u"].max()) + 1
            n_items = int(tr["i"].max()) + 1
            per_seed = _seed_metrics(model_name, cfg, stacked, seeds, va,
                                     n_users, n_items)
            row = {
                "K": K,
                "val_rmse": float(np.mean([m["val_rmse"] for m in per_seed])),
                "val_lpl": float(np.mean([m["val_lpl"] for m in per_seed])),
                "per_seed": per_seed,
            }
            rows.append(row)
            print(f"K={K}: mean val RMSE {row['val_rmse']:.4f} | mean val LPL "
                  f"{row['val_lpl']:.1f} (over {seeds} vmapped seeds)",
                  flush=True)
            continue
        if model_name == "gaussian":
            m = GaussianMF(cfg).fit(tr, va, global_mean=mean, device=device)
            val_rmse = m.evaluate_rmse(va, global_mean=mean)
            theta = m.state["m_theta"].cpu().numpy()
            beta = m.state["m_beta"].cpu().numpy()
            vv = va[(va["u"] < m.n_users) & (va["i"] < m.n_items)]
            lpl = gaussian_log_predictive_likelihood(
                vv["rating"].to_numpy(),
                np.sum(theta[vv["u"].to_numpy()] * beta[vv["i"].to_numpy()], axis=1),
                np.sqrt(cfg.sigma2),
            )
        else:
            m = (PoissonMF if model_name == "poisson" else HPF)(cfg).fit(
                tr, va, device=device)
            val_rmse = m.evaluate_rmse(va)
            lam = m.predict(va["u"].to_numpy(), va["i"].to_numpy())
            lpl = poisson_log_predictive_likelihood(va["rating"].to_numpy(), lam)
        rows.append({"K": K, "val_rmse": val_rmse, "val_lpl": lpl})
        print(f"K={K}: val RMSE {val_rmse:.4f} | val LPL {lpl:.1f}", flush=True)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description="Best-K sweep")
    parser.add_argument("--model", required=True, choices=["gaussian", "poisson", "hpf_cavi"])
    parser.add_argument("--k_min", type=int, default=2)
    parser.add_argument("--k_max", type=int, default=60)
    parser.add_argument("--k_step", type=int, default=2)
    parser.add_argument("--max_iter", type=int, default=30)
    parser.add_argument("--seeds", type=int, default=1,
                        help="fit N seeds per K in one vmapped program and "
                             "select by mean val LPL")
    add_device_arg(parser)
    add_data_args(parser)
    args = parser.parse_args(argv)
    device = setup_runtime(args.device)

    train_df, val_df, _ = get_splits(args)
    ks = list(range(args.k_min, args.k_max + 1, args.k_step))
    print_header(f"best-K sweep: {args.model}, K in {ks[0]}..{ks[-1]}"
                 + (f", {args.seeds} vmapped seeds/K" if args.seeds > 1 else ""))
    rows = sweep(args.model, train_df, val_df, ks, max_iter=args.max_iter,
                 seeds=args.seeds, device=device)

    best = max(rows, key=lambda r: r["val_lpl"])
    print(f"\nBest K by val LPL: {best['K']} (LPL {best['val_lpl']:.1f})")

    prefix = {"gaussian": "GF", "poisson": "PF", "hpf_cavi": "HPF"}[args.model]
    _plot([r["K"] for r in rows], [r["val_rmse"] for r in rows],
          "Validation RMSE", os.path.join(FIG_DIR, f"{prefix}_RMSE.png"))
    _plot([r["K"] for r in rows], [r["val_lpl"] for r in rows],
          "Validation log predictive likelihood",
          os.path.join(FIG_DIR, f"{prefix}_LPL.png"))
    print(f"Plots written to {FIG_DIR}/{prefix}_RMSE.png, {prefix}_LPL.png")
    return rows, best


if __name__ == "__main__":
    main()
