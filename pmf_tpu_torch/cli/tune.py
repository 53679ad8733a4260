"""Hyperparameter tuning: the seeded random tuner and the HPF-MAP grid.

    python -m pmf_tpu_torch.cli.tune --n_trials 5 [--models gaussian poisson ...]
        [--seeds_per_trial S] [--device cuda|cpu]
    python -m pmf_tpu_torch.cli.tune --grid_hpf_map     # the 16-combo grid

Search spaces, subsampling (50k train / 10k val rows, seed 42),
macro-MAE selection and per-model preprocessing (centring for Gaussian,
+1 shift for HPF) as in the JAX package's tuner; the same seeded numpy
generator draws the same trial configs.  Writes ``best_hyperparams.txt``
in the shared artifact format (``pmf_tpu_torch.config``).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools

import numpy as np

from pmf_tpu_torch import config as cfg_io
from pmf_tpu_torch.cli.common import (
    DEVICE_FAULTS,
    add_data_args,
    add_device_arg,
    center,
    get_splits,
    print_header,
    setup_runtime,
    shift,
)
from pmf_tpu_torch.cli.run_single import run_model
from pmf_tpu_torch.models import GaussianMFConfig, HPFConfig, HPFMapConfig, PoissonMFConfig
from pmf_tpu_torch.utils.device import resolve_device

GAUSSIAN_GRID = {"n_factors": [30, 50, 70], "sigma2": [0.3, 0.5, 0.7], "eta_reg": [0.5, 1.0, 2.0]}
POISSON_GRID = {"n_factors": [10, 20, 40], "a0": [0.05, 0.1, 0.2], "b0": [0.1, 0.3, 0.5]}
HPF_GRID = {"n_factors": [10, 20, 30], "hyper_a": [0.1, 0.3, 0.5], "hyper_prime": [3.0, 5.0, 7.0]}
HPF_MAP_GRID = {
    "n_factors": [10, 20, 30],
    "lr": [0.005, 0.01, 0.02],
    "hyper_a": [0.5, 1.0, 1.5],
    "hyper_prime": [0.5, 1.0, 2.0],
}


def _sample_config(model: str, rng: np.random.Generator):
    def pick(opts):
        return opts[rng.integers(len(opts))]

    if model == "gaussian":
        return GaussianMFConfig(
            n_factors=int(pick(GAUSSIAN_GRID["n_factors"])),
            sigma2=float(pick(GAUSSIAN_GRID["sigma2"])),
            eta_theta2=float(pick(GAUSSIAN_GRID["eta_reg"])),
            eta_beta2=float(pick(GAUSSIAN_GRID["eta_reg"])),
            eta_bias2=float(pick(GAUSSIAN_GRID["eta_reg"])),
            max_iter=50, tol=1e-3, use_bias=True,
        )
    if model == "poisson":
        return PoissonMFConfig(
            n_factors=int(pick(POISSON_GRID["n_factors"])),
            a0=float(pick(POISSON_GRID["a0"])),
            b0=float(pick(POISSON_GRID["b0"])),
            max_iter=30, tol=1e-3,
        )
    if model == "hpf_cavi":
        a = float(pick(HPF_GRID["hyper_a"]))
        p = float(pick(HPF_GRID["hyper_prime"]))
        return HPFConfig(
            n_factors=int(pick(HPF_GRID["n_factors"])),
            a=a, a_prime=p, b_prime=p, c=a, c_prime=p, d_prime=p,
            max_iter=50, tol=1e-3,
        )
    if model == "hpf_map":
        a = float(pick(HPF_MAP_GRID["hyper_a"]))
        p = float(pick(HPF_MAP_GRID["hyper_prime"]))
        return HPFMapConfig(
            n_factors=int(pick(HPF_MAP_GRID["n_factors"])),
            lr=float(pick(HPF_MAP_GRID["lr"])),
            a=a, a_prime=p, b_prime=p, c=a, c_prime=p, d_prime=p,
            epochs=20, batch_size=4096,
        )
    raise ValueError(model)


# run_single model-name for each tuner key.
_RUN_NAME = {"gaussian": "gaussian_bias", "poisson": "poisson",
             "hpf_cavi": "hpf_cavi", "hpf_map": "hpf_map"}
# best_hyperparams.txt artifact key for each tuner key.
ARTIFACT_KEY = {"gaussian": cfg_io.GAUSSIAN_KEY, "poisson": cfg_io.POISSON_KEY,
                "hpf_cavi": cfg_io.HPF_CAVI_KEY, "hpf_map": cfg_io.HPF_MAP_KEY}


def _multi_seed_trial(model: str, config, train_df, val_df, seeds, device=None):
    """Score one config across several init seeds at once
    (``tune.multi_seed``), after the model's preprocessing (centring or
    the +1 shift; macro-MAE is invariant under the common shift).
    Returns (best macro-MAE, its RMSE, config with the best seed)."""
    from pmf_tpu_torch.tune.multi_seed import multi_seed_fit

    if model == "gaussian":
        train_t, val_t, _, _mean = center(train_df, val_df, val_df)
    elif model == "hpf_cavi":
        train_t, val_t = shift(train_df, 1), shift(val_df, 1)
    else:
        train_t, val_t = train_df, val_df
    _, metrics = multi_seed_fit(config, train_t, val_t, seeds=seeds, device=device)
    best = min(metrics, key=lambda m: m["val_macro_mae"])
    return best["val_macro_mae"], best["val_rmse"], dataclasses.replace(
        config, random_state=best["seed"]
    )


def tune_model(model: str, train_df, val_df, n_trials: int, seed: int = 0,
               verbose=False, seeds_per_trial: int = 1, device=None):
    """Random search on validation macro-MAE.  With ``seeds_per_trial >
    1`` each CAVI-model trial fits that many init seeds in one vmapped
    program and keeps the best (its random_state lands in the returned
    config).  A failing trial is reported and skipped, as in the
    reference; a missing card or a kernel fault raises."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    best_score, best_config = float("inf"), None
    print_header(f"Tuning {model} ({n_trials} trials)")
    vmappable = seeds_per_trial > 1 and model in ("gaussian", "poisson", "hpf_cavi")
    for t in range(n_trials):
        config = _sample_config(model, rng)
        try:
            if vmappable:
                score, rmse_v, config = _multi_seed_trial(
                    model, config, train_df, val_df,
                    seeds=tuple(range(seeds_per_trial)), device=device,
                )
            else:
                res = run_model(_RUN_NAME[model], train_df, val_df, val_df,
                                config=config, verbose=verbose, device=device)
                score, rmse_v = res["val_macro_mae"], res["val_rmse"]
            print(
                f"Trial {t + 1}/{n_trials}: MacroMAE={score:.4f} "
                f"(RMSE={rmse_v:.4f}) | {config}",
                flush=True,
            )
            if np.isfinite(score) and score < best_score:
                best_score, best_config = score, config
        except DEVICE_FAULTS:
            raise
        except Exception as e:  # isolation, as in the reference
            print(f"Trial {t + 1} failed: {e}", flush=True)
    print(f"Best {model} MacroMAE: {best_score:.4f}")
    return best_config


def grid_tune_hpf_map(train_df, val_df, verbose=False, device=None):
    """The reference's exhaustive 16-combo HPF-MAP grid on val RMSE."""
    grid = {"n_factors": [20, 50], "lr": [0.001, 0.005], "a": [0.3, 1.0], "a_prime": [1.0, 3.0]}
    best_score, best_config = float("inf"), None
    combos = [dict(zip(grid, v)) for v in itertools.product(*grid.values())]
    print_header(f"HPF-MAP grid tuning: {len(combos)} combos")
    for c in combos:
        config = HPFMapConfig(
            n_factors=c["n_factors"], lr=c["lr"],
            a=c["a"], a_prime=c["a_prime"], b_prime=c["a_prime"],
            c=c["a"], c_prime=c["a_prime"], d_prime=c["a_prime"],
            epochs=10, batch_size=4096,
        )
        res = run_model("hpf_map", train_df, val_df, val_df, config=config,
                        verbose=verbose, device=device)
        print(f"{c}: val RMSE {res['val_rmse']:.4f}", flush=True)
        if res["val_rmse"] < best_score:
            best_score, best_config = res["val_rmse"], config
    print(f"Best grid val RMSE: {best_score:.4f}")
    return best_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="Tune PMF models")
    parser.add_argument("--n_trials", type=int, default=5)
    parser.add_argument("--models", nargs="+",
                        default=["gaussian", "poisson", "hpf_cavi", "hpf_map"],
                        choices=["gaussian", "poisson", "hpf_cavi", "hpf_map"])
    parser.add_argument("--grid_hpf_map", action="store_true")
    parser.add_argument("--tune_seed", type=int, default=0)
    parser.add_argument("--seeds_per_trial", type=int, default=1,
                        help="fit N init seeds per trial in one vmapped "
                             "program (CAVI models)")
    parser.add_argument("--subsample", type=int, default=50000)
    parser.add_argument("--out", default="best_hyperparams.txt")
    parser.add_argument("--verbose", action="store_true")
    add_device_arg(parser)
    add_data_args(parser)
    args = parser.parse_args(argv)
    device = setup_runtime(args.device)

    train_df, val_df, _ = get_splits(args)
    # Subsample like the reference (50k train / 10k val, seed 42).
    if len(train_df) > args.subsample:
        train_df = train_df.sample(n=args.subsample, random_state=42)
    if len(val_df) > args.subsample // 5:
        val_df = val_df.sample(n=args.subsample // 5, random_state=42)

    if args.grid_hpf_map:
        best = grid_tune_hpf_map(train_df, val_df, verbose=args.verbose, device=device)
        print(f"Grid best: {best}")
        return best

    results = {}
    for model in args.models:
        best = tune_model(model, train_df, val_df, args.n_trials,
                          seed=args.tune_seed, verbose=args.verbose,
                          seeds_per_trial=args.seeds_per_trial, device=device)
        if best is not None:
            results[ARTIFACT_KEY[model]] = best
    cfg_io.write_best_hyperparams(results, args.out)
    print(f"\nWrote {args.out}")
    return results


if __name__ == "__main__":
    main()
