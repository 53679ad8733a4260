"""The port's one-command chain (``pmf_tpu_torch.cli.reproduce``) end to
end on the CPU: a tiny synthetic Food.com clone through preprocess ->
tune -> compare -> train_full -> analysis, the same artifact set as
``tests/test_reproduce.py`` checks of the JAX package's chain."""

import json
import os

import pandas as pd
import torch

from pmf_tpu_torch.config import load_best_hyperparams

torch.set_num_threads(1)

ARTIFACTS = (
    "data/processed/interactions_train.csv",
    "data/processed/dict_i.csv",
    "best_hyperparams.txt",
    "model_comparison_plots.png",
    "model_comparison_params.txt",
    "data/embeddings/gaussian_mf/user_embeddings.csv",
    "data/embeddings/gaussian_mf/config.txt",
    "data/predictions/hpf_cavi/test_predictions.csv",
    "reports/forecast_metrics.csv",
    "reports/forecast_analysis.md",
    "reproduce_manifest.json",
)


def test_reproduce_chain_end_to_end(tmp_path, monkeypatch):
    from pmf_tpu_torch.cli.reproduce import main

    from pmf_tpu_torch.data import layout_cache

    monkeypatch.chdir(tmp_path)
    # The chain's CLIs turn the layout cache on where the environment names
    # no directory: keep it in this test's directory, not the checkout's.
    monkeypatch.setenv(layout_cache.ENV_VAR, str(tmp_path / "layouts"))
    wd = str(tmp_path / "repro")
    # A smaller clone than the JAX test's 9000 x 250 x 120, so the chain
    # stays well inside a minute on one CPU thread.
    res = main(["--workdir", wd, "--synthetic_clone", "4000", "--clone_users", "150",
                "--clone_items", "80", "--n_trials", "1", "--device", "cpu"])

    assert set(res["stages"]) >= {"synthetic_clone", "preprocess", "tune", "compare",
                                  "train_full", "analysis"}
    assert res["device"] == "cpu"
    for rel in ARTIFACTS:
        assert os.path.exists(os.path.join(wd, rel)), rel
    with open(os.path.join(wd, "reproduce_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["stages"]["preprocess"]["files"]
    assert len(manifest["stages"]["compare"]) == 4  # every model fitted
    assert manifest["stages"]["train_full"]["embeddings"] == [
        "gaussian_mf", "hpf_cavi", "hpf_pytorch", "poisson_mf"]
    assert load_best_hyperparams(os.path.join(wd, "best_hyperparams.txt"))
    metrics = pd.read_csv(os.path.join(wd, "reports", "forecast_metrics.csv"))
    assert len(metrics) == 4 and metrics["rmse"].notna().all()
    # Item embeddings carry the recipe ids of the processed id map.
    items = pd.read_csv(os.path.join(wd, "data/embeddings/hpf_cavi/item_embeddings.csv"))
    dict_i = pd.read_csv(os.path.join(wd, "data/processed/dict_i.csv"))
    assert list(items["recipe_id"]) == list(dict_i.sort_values("i")["recipe_id"])
