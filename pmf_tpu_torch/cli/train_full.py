"""Full-data training and artifact export:

    python -m pmf_tpu_torch.cli.train_full --model {gaussian,poisson,hpf_cavi,
        hpf_map,all} --dataset_mode {train,train+val,full} [--device cuda|cpu]
        [--mesh_devices N]

Per model: train on the selected union of splits with the tuned config
(``best_hyperparams.txt``, else the defaults), then export
  data/embeddings/<model>/{user,item}_embeddings.csv  (item rows carry a
  recipe_id column when the id map is available),
  data/embeddings/<model>/config.txt,
  data/predictions/<model>/test_predictions.csv  (u,i,y_true,y_pred),
the same files as the JAX package's.  A model that fails is reported and
the next one runs; a missing card or a kernel fault raises.  With
``--mesh_devices N`` (under ``torchrun --nproc_per_node N``) every fit is
data-parallel over the ranks, the ranks agree on each model's outcome, and
rank 0 alone exports.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import pandas as pd

from pmf_tpu_torch import config as cfg_io
from pmf_tpu_torch.cli.common import (
    Timer,
    add_data_args,
    add_device_arg,
    add_mesh_arg,
    get_splits,
    isolated,
    mesh_session,
    print_header,
    setup_runtime,
    shift,
)
from pmf_tpu_torch.cli.run_single import DEFAULTS
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
from pmf_tpu_torch.utils.mapping import get_recipe_id_map

# (artifact dir, run_single default key, artifact key, config class)
SPECS = {
    "gaussian": ("gaussian_mf", "gaussian_bias", cfg_io.GAUSSIAN_KEY, GaussianMFConfig),
    "poisson": ("poisson_mf", "poisson", cfg_io.POISSON_KEY, PoissonMFConfig),
    "hpf_cavi": ("hpf_cavi", "hpf_cavi", cfg_io.HPF_CAVI_KEY, HPFConfig),
    "hpf_map": ("hpf_pytorch", "hpf_map", cfg_io.HPF_MAP_KEY, HPFMapConfig),
}


def _select_union(train_df, val_df, test_df, mode: str) -> pd.DataFrame:
    if mode == "train":
        return train_df[["u", "i", "rating"]]
    if mode == "train+val":
        return pd.concat([train_df, val_df])[["u", "i", "rating"]]
    if mode == "full":
        return pd.concat([train_df, val_df, test_df])[["u", "i", "rating"]]
    raise ValueError(f"Invalid dataset_mode: {mode}")


def _export(model_dir_name, user_emb, item_emb, config, extra_cfg, test_df, predict_fn,
            data_dir="data", map_data_dir=None):
    """Write the embeddings (tensors, copied to the host once each), the
    config and the test predictions."""
    out_dir = os.path.join(data_dir, "embeddings", model_dir_name)
    os.makedirs(out_dir, exist_ok=True)
    pd.DataFrame(user_emb.detach().cpu().numpy()).to_csv(
        os.path.join(out_dir, "user_embeddings.csv"), index=False
    )
    item_df = pd.DataFrame(item_emb.detach().cpu().numpy())
    id_map = get_recipe_id_map(map_data_dir or data_dir)
    if id_map is not None and len(id_map) >= len(item_df):
        item_df.insert(0, "recipe_id", id_map[: len(item_df)])
    item_df.to_csv(os.path.join(out_dir, "item_embeddings.csv"), index=False)
    with open(os.path.join(out_dir, "config.txt"), "w") as f:
        f.write(str(dataclasses.asdict(config)))
        for k, v in extra_cfg.items():
            f.write(f"\n{k}: {v}")

    pred_dir = os.path.join(data_dir, "predictions", model_dir_name)
    os.makedirs(pred_dir, exist_ok=True)
    tu, ti = test_df["u"].to_numpy(), test_df["i"].to_numpy()
    y_true = test_df["rating"].to_numpy()
    y_pred = predict_fn(tu, ti)
    pd.DataFrame({"u": tu, "i": ti, "y_true": y_true, "y_pred": y_pred}).to_csv(
        os.path.join(pred_dir, "test_predictions.csv"), index=False
    )
    print(
        f"Test metrics: RMSE={rmse(y_true, y_pred):.4f} "
        f"MacroMAE={macro_mae(y_true, y_pred):.4f}"
    )
    print(f"Exported embeddings -> {out_dir}, predictions -> {pred_dir}")


def train_one(model_name, train_df, val_df, test_df, dataset_mode, hyperparams,
              data_dir="data", verbose=True, map_data_dir=None, device=None,
              mesh=None):
    """Fit one model and export its artifacts; returns the model, with
    ``fit_seconds`` and ``export_seconds`` set on it.  ``mesh``: the fit
    data-parallel over its ranks (``device`` then the mesh's); rank 0 alone
    exports (the others' ``export_seconds`` is 0)."""
    dir_name, default_key, artifact_key, config_cls = SPECS[model_name]
    raw = hyperparams.get(artifact_key)
    config = (
        config_cls(**cfg_io.filter_config_kwargs(config_cls, raw))
        if raw
        else dataclasses.replace(DEFAULTS[default_key])
    )
    config.verbose = verbose
    df = _select_union(train_df, val_df, test_df, dataset_mode)
    print_header(f"train_full: {model_name} | mode={dataset_mode} | {len(df)} ratings")

    if model_name == "gaussian":
        mean = float(df["rating"].mean())
        dfc = df.copy()
        dfc["rating"] -= mean
        model = GaussianMF(config)
        with Timer() as t:
            model.fit(dfc, global_mean=mean, device=device, mesh=mesh)
        user_emb, item_emb = model.state["m_theta"], model.state["m_beta"]

        def predict_fn(u, i):
            return model.predict(u, i, global_mean=mean)

        extra = {"global_mean": mean}
    elif model_name == "poisson":
        model = PoissonMF(config)
        with Timer() as t:
            model.fit(df, device=device, mesh=mesh)
        user_emb, item_emb = model._point_estimates()
        predict_fn = model.predict
        extra = {}
    else:  # hpf_cavi, hpf_map: +1 shift in, -1 out
        model = (HPF if model_name == "hpf_cavi" else HPFMap)(config)
        with Timer() as t:
            model.fit(shift(df, 1), device=device, mesh=mesh)
        user_emb, item_emb = model._point_estimates()

        def predict_fn(u, i):
            return model.predict(u, i) - 1.0

        extra = {"rating_shift": 1}

    print(f"Training finished in {t.seconds:.1f}s")
    model.fit_seconds, model.export_seconds = t.seconds, 0.0
    if mesh is None or mesh.is_writer:
        with Timer() as e:
            _export(dir_name, user_emb, item_emb, config, extra, test_df, predict_fn,
                    data_dir, map_data_dir)
        model.export_seconds = e.seconds
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(description="Full training + artifact export")
    parser.add_argument("--model", default="all", choices=["all", *SPECS])
    parser.add_argument("--dataset_mode", default="train",
                        choices=["train", "train+val", "full"])
    parser.add_argument("--hyperparams", default="best_hyperparams.txt")
    parser.add_argument("--data_dir", default="data")
    parser.add_argument("--map_data_dir", default=None,
                        help="directory whose processed/dict_i.csv provides the "
                        "recipe-id map when exports go elsewhere (default: "
                        "--data_dir)")
    parser.add_argument("--verbose", action="store_true")
    add_device_arg(parser)
    add_mesh_arg(parser)
    add_data_args(parser)
    args = parser.parse_args(argv)
    device = setup_runtime(args.device)
    with mesh_session(args.mesh_devices, args.device, "train_full") as mesh:
        return _run(args, mesh.device if mesh else device, mesh)


def _run(args, device, mesh):
    train_df, val_df, test_df = get_splits(args)
    hyperparams = cfg_io.load_best_hyperparams(args.hyperparams)
    names = list(SPECS) if args.model == "all" else [args.model]
    models = {}
    for name in names:
        model = isolated(name, lambda: train_one(
            name, train_df, val_df, test_df, args.dataset_mode, hyperparams,
            data_dir=args.data_dir, verbose=args.verbose, map_data_dir=args.map_data_dir,
            device=device, mesh=mesh), mesh)
        if model is not None:
            models[name] = model
    return models


if __name__ == "__main__":
    main()
