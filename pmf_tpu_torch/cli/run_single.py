"""Single-model experiment runner, one entry point for the six models:

    python -m pmf_tpu_torch.cli.run_single --model {gaussian,gaussian_bias,
        poisson,poisson_extended,hpf_cavi,hpf_map} [--synthetic N]
        [--device cuda|cpu] [--mesh_devices N]

Per-model preprocessing as in the JAX package's runner: the Gaussian
variants train on centred ratings; the Poisson variants check that the
ratings are non-negative; HPF-CAVI and HPF-MAP train on ratings shifted
by +1 and report metrics on the original scale.  Every fit runs on
``--device`` (default: the CUDA card; it raises without one).  With
``--mesh_devices N`` it runs under ``torchrun --nproc_per_node N``, each
fit data-parallel over the N ranks (``cli.common.mesh_session``).
"""

from __future__ import annotations

import argparse
import dataclasses

from pmf_tpu_torch.cli.common import (
    Timer,
    add_data_args,
    add_device_arg,
    add_mesh_arg,
    center,
    get_splits,
    mesh_session,
    print_header,
    setup_runtime,
    shift,
)
from pmf_tpu_torch.eval.metrics import macro_mae, rmse
from pmf_tpu_torch.models import (
    HPF,
    GaussianMF,
    GaussianMFConfig,
    HPFConfig,
    HPFMap,
    HPFMapConfig,
    PoissonMF,
    PoissonMFConfig,
)

# The reference runners' default configs.
DEFAULTS = {
    "gaussian": GaussianMFConfig(
        n_factors=20, sigma2=2.0, eta_theta2=0.05, eta_beta2=0.05,
        max_iter=100, tol=1e-3, use_bias=False,
    ),
    "gaussian_bias": GaussianMFConfig(
        n_factors=20, sigma2=0.5, eta_theta2=0.1, eta_beta2=0.01, eta_bias2=0.01,
        max_iter=100, tol=1e-8, use_bias=True,
    ),
    "poisson": PoissonMFConfig(n_factors=20, a0=0.3, b0=1.0, max_iter=100, tol=1e-4),
    "poisson_extended": PoissonMFConfig(
        n_factors=20, a0=0.6, b0=1.0, max_iter=100, tol=1e-4, extended=True
    ),
    "hpf_cavi": HPFConfig(
        n_factors=20, a=0.3, a_prime=1.0, b_prime=1.0, c=0.3, c_prime=1.0,
        d_prime=1.0, max_iter=100,
    ),
    "hpf_map": HPFMapConfig(
        n_factors=20, a=0.3, a_prime=1.0, b_prime=1.0, c=0.3, c_prime=1.0,
        d_prime=1.0, lr=1e-3, batch_size=4096, epochs=20,
    ),
}


def run_model(model_name: str, train_df, val_df, test_df, config=None, verbose=True,
              profile_dir=None, elbo_every: int = 0, device=None, mesh=None):
    """Train one model with its reference preprocessing; return metrics.

    ``device``: None = the CUDA card (raises without one).  ``mesh``
    (``parallel.make_mesh``): every fit data-parallel over its ranks (then
    ``device`` is the mesh's); HPF-MAP runs flat under a mesh.
    ``profile_dir``: a ``torch.profiler`` trace of the whole fit.
    ``elbo_every=N``: the CAVI families record their ELBO every N
    iterations and the final one lands in the result; ignored for
    hpf_map, which has no variational objective."""
    # Never mutate the shared DEFAULTS instances.
    config = dataclasses.replace(config or DEFAULTS[model_name], verbose=verbose)
    results = {"model": model_name}

    if model_name.startswith("gaussian"):
        train_c, val_c, test_c, mean = center(train_df, val_df, test_df)
        model = GaussianMF(config)
        with Timer() as t:
            model.fit(train_c, val_c, global_mean=mean, device=device,
                      profile_dir=profile_dir, elbo_every=elbo_every, mesh=mesh)
        for split, df in (("train", train_c), ("val", val_c), ("test", test_c)):
            results[f"{split}_rmse"] = model.evaluate_rmse(df, global_mean=mean)
            results[f"{split}_macro_mae"] = model.evaluate_macro_mae(df, global_mean=mean)
    elif model_name.startswith("poisson"):
        assert (train_df["rating"] >= 0).all(), "Poisson models need non-negative ratings"
        model = PoissonMF(config)
        with Timer() as t:
            model.fit(train_df, val_df, device=device, profile_dir=profile_dir,
                      elbo_every=elbo_every, mesh=mesh)
        for split, df in (("train", train_df), ("val", val_df), ("test", test_df)):
            results[f"{split}_rmse"] = model.evaluate_rmse(df)
            results[f"{split}_macro_mae"] = model.evaluate_macro_mae(df)
    elif model_name in ("hpf_cavi", "hpf_map"):
        # +1 shift to keep rates positive; unshift for original-scale metrics.
        tr, va, te = shift(train_df, 1), shift(val_df, 1), shift(test_df, 1)
        with Timer() as t:
            if model_name == "hpf_cavi":
                model = HPF(config)
                model.fit(tr, va, device=device, profile_dir=profile_dir,
                          elbo_every=elbo_every, mesh=mesh)
            else:
                model = HPFMap(config)
                model.fit(tr, va, device=device, profile_dir=profile_dir, mesh=mesh)
        for split, df0, df1 in (("train", train_df, tr), ("val", val_df, va),
                                ("test", test_df, te)):
            preds = model.predict(df1["u"].to_numpy(), df1["i"].to_numpy()) - 1.0
            y = df0["rating"].to_numpy()
            results[f"{split}_rmse"] = rmse(y, preds)
            results[f"{split}_macro_mae"] = macro_mae(y, preds)
    else:
        raise ValueError(f"unknown model {model_name}")

    results["fit_seconds"] = t.seconds
    if elbo_every and model.fit_history:
        elbos = [h["elbo"] for h in model.fit_history if "elbo" in h]
        if elbos:
            results["final_elbo"] = elbos[-1]
    results["_model"] = model
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run a single PMF model")
    parser.add_argument("--model", required=True, choices=sorted(DEFAULTS))
    parser.add_argument("--max_iter", type=int, help="override config max_iter/epochs")
    parser.add_argument("--n_factors", type=int, help="override latent dimension")
    parser.add_argument("--profile_dir", help="write a torch.profiler trace here")
    parser.add_argument("--engine",
                        help="sweep engine override for every model "
                             "(flat, flat_chunked, blocked_high, blocked_mid, "
                             "blocked_fast, auto)")
    parser.add_argument("--bias_update", choices=["exact", "lagged"],
                        help="Gaussian bias-block mode (lagged: bias stats "
                             "ride the factor passes; same fixed point)")
    parser.add_argument("--elbo", type=int, default=0, metavar="N",
                        help="record the ELBO every N iterations in "
                             "fit_history (CAVI models; 0 = off)")
    add_device_arg(parser)
    add_mesh_arg(parser)
    add_data_args(parser)
    args = parser.parse_args(argv)
    device = setup_runtime(args.device)
    with mesh_session(args.mesh_devices, args.device, "run_single") as mesh:
        return _run(args, mesh.device if mesh else device, mesh)


def _run(args, device, mesh):
    config = dataclasses.replace(DEFAULTS[args.model])
    if args.n_factors:
        config.n_factors = args.n_factors
    if args.max_iter:
        if hasattr(config, "max_iter"):
            config.max_iter = args.max_iter
        else:
            config.epochs = args.max_iter
    if args.engine and hasattr(config, "engine"):
        config.engine = args.engine
    if args.bias_update and hasattr(config, "bias_update"):
        config.bias_update = args.bias_update

    train_df, val_df, test_df = get_splits(args)
    print_header(f"run_single: {args.model}")
    res = run_model(args.model, train_df, val_df, test_df, config=config,
                    profile_dir=args.profile_dir, elbo_every=args.elbo, device=device,
                    mesh=mesh)
    for split in ("train", "val", "test"):
        print(
            f"{split:>5} RMSE {res[f'{split}_rmse']:.4f} | "
            f"macro-MAE {res[f'{split}_macro_mae']:.4f}"
        )
    print(f"fit time: {res['fit_seconds']:.1f}s")
    if "final_elbo" in res:
        print(f"final ELBO: {res['final_elbo']:.6g}")
    return res


if __name__ == "__main__":
    main()
