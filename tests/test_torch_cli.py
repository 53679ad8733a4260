"""Port ``cli/*`` against the JAX package's CLIs on the CPU, on the same
seeded synthetic splits (the JAX fits at engine "flat", which "auto"
means on the CPU; the port's with ``--device cpu``): ``run_model`` of all
six models (RMSE and macro-MAE to 1e-4), the tuner's sampled configs and
``best_hyperparams.txt``, ``best_k.sweep`` with and without seeds (RMSE
and LPL to 1e-4 relative), ``compare`` and ``train_full``'s exports (same
columns and shapes, values to 1e-4).  Then the port's own rules: every
``main`` raises without a card (and prints no "FAILED"), a kernel fault
is not turned into a "FAILED" line, the unported engines raise."""

import dataclasses
import os

import numpy as np
import pandas as pd
import pytest
import torch

from pmf_tpu import config as jcfg
from pmf_tpu.cli import best_k as jbest_k
from pmf_tpu.cli import compare as jcompare
from pmf_tpu.cli import run_single as jrun
from pmf_tpu.cli import train_full as jtrain
from pmf_tpu.cli import tune as jtune
from pmf_tpu_torch import config as tcfg
from pmf_tpu_torch.cli import best_k as tbest_k
from pmf_tpu_torch.cli import common as tcommon
from pmf_tpu_torch.cli import compare as tcompare
from pmf_tpu_torch.cli import reproduce as treproduce
from pmf_tpu_torch.cli import run_single as trun
from pmf_tpu_torch.cli import train_full as ttrain
from pmf_tpu_torch.cli import tune as ttune
from pmf_tpu_torch.data import layout_cache
from pmf_tpu_torch.data.synthetic import synth_splits
from pmf_tpu_torch.ops._build import KernelError

torch.set_num_threads(1)

SYN = ["--synthetic", "4000", "--synthetic_users", "300", "--synthetic_items", "120"]
CPU = ["--device", "cpu"]
MODELS = ["gaussian", "gaussian_bias", "poisson", "poisson_extended", "hpf_cavi", "hpf_map"]
TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_jax_runtime(monkeypatch):
    """The JAX CLIs' compile-cache set-up writes beside the repo: off."""
    for mod in (jrun, jtune, jbest_k, jcompare, jtrain):
        monkeypatch.setattr(mod, "setup_runtime", lambda: None)


@pytest.fixture(autouse=True)
def _layout_cache_in_tmp(monkeypatch, tmp_path):
    """A CLI's ``main`` turns the layout cache on where the environment
    names no directory: keep it in this test's own directory, so no layout
    outlives the test."""
    monkeypatch.setenv(layout_cache.ENV_VAR, str(tmp_path / "layouts"))


@pytest.fixture(scope="module")
def frames():
    tr, va, te = synth_splits(300, 120, 4000, seed=0)

    def mk(t):
        return pd.DataFrame({"u": t[0], "i": t[1], "rating": t[2]})

    return mk(tr), mk(va), mk(te)


def _small(cfg, K=4, iters=3):
    """A small copy of ``cfg``: K factors, a few iterations; HPF-MAP full
    batch, so its one Adam step an epoch does not depend on the shuffle
    (a torch.Generator in the port, a JAX key in the reference)."""
    cfg = dataclasses.replace(cfg, n_factors=K, verbose=False)
    if hasattr(cfg, "max_iter"):
        cfg.max_iter = iters
    else:
        cfg.epochs, cfg.batch_size = iters, 1 << 14
    return cfg


@pytest.mark.parametrize("model", MODELS)
def test_run_model_equals_the_jax_runner(frames, model):
    tr, va, te = frames
    want = jrun.run_model(model, tr, va, te, config=_small(jrun.DEFAULTS[model]),
                          verbose=False)
    got = trun.run_model(model, tr, va, te, config=_small(trun.DEFAULTS[model]),
                         verbose=False, device="cpu")
    assert got["model"] == model and got["_model"].device == torch.device("cpu")
    for split in ("train", "val", "test"):
        for metric in ("rmse", "macro_mae"):
            key = f"{split}_{metric}"
            assert np.isfinite(got[key])
            assert abs(got[key] - want[key]) < TOL, key


def test_run_model_records_the_final_elbo(frames):
    tr, va, te = frames
    res = trun.run_model("hpf_cavi", tr, va, te, config=_small(trun.DEFAULTS["hpf_cavi"]),
                         verbose=False, elbo_every=1, device="cpu")
    assert np.isfinite(res["final_elbo"])
    assert res["final_elbo"] == res["_model"].fit_history[-1]["elbo"]


def test_defaults_equal_the_jax_defaults():
    assert sorted(trun.DEFAULTS) == sorted(jrun.DEFAULTS)
    for name, cfg in trun.DEFAULTS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jrun.DEFAULTS[name]), name


def test_run_single_main_prints_and_returns(capsys):
    res = trun.main(["--model", "poisson", "--max_iter", "2", "--n_factors", "3",
                     *SYN, *CPU])
    out = capsys.readouterr().out
    assert "=== run_single: poisson ===" in out and "fit time" in out
    assert res["_model"].config.max_iter == 2 and res["_model"].config.n_factors == 3


def test_run_single_engine_and_bias_update_flags():
    res = trun.main(["--model", "gaussian_bias", "--max_iter", "2", "--engine", "flat",
                     "--bias_update", "lagged", *SYN, *CPU])
    assert res["_model"].config.bias_update == "lagged"
    assert res["_model"].engine_used == "flat"
    res = trun.main(["--model", "hpf_map", "--max_iter", "1", "--engine", "blocked_high",
                     "--n_factors", "3", *SYN, *CPU])
    assert res["_model"].engine_used == "blocked_high"
    assert res["_model"].config.epochs == 1


@pytest.mark.parametrize("model", ["hpf_cavi", "gaussian", "poisson", "hpf_map"])
@pytest.mark.parametrize("engine", ["blocked_mid", "blocked_fast", "flat_chunked"])
def test_unported_engines_raise(model, engine):
    """The engines this test once saw raise are ported: each runs, as in
    the JAX package ("flat_chunked" runs flat outside HPF, and HPF-MAP
    records it as "flat")."""
    res = trun.main(["--model", model, "--max_iter", "1", "--engine", engine, *SYN, *CPU])
    want = "flat" if model == "hpf_map" and engine == "flat_chunked" else engine
    assert res["_model"].engine_used == want


@pytest.mark.parametrize("model", ["gaussian", "poisson", "hpf_cavi", "hpf_map"])
def test_tuner_samples_the_jax_configs(model):
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(6):
        got = ttune._sample_config(model, trng)
        assert dataclasses.asdict(got) == dataclasses.asdict(jtune._sample_config(model, jrng))


def _tiny_grids(monkeypatch):
    """K of the tuner's grids cut to 3 and 4 in both packages, so the
    trials stay small; everything else of the search is the reference's."""
    for mod in (jtune, ttune):
        for grid in ("GAUSSIAN_GRID", "POISSON_GRID", "HPF_GRID", "HPF_MAP_GRID"):
            monkeypatch.setitem(getattr(mod, grid), "n_factors", [3, 4])


@pytest.mark.parametrize("seeds_per_trial", ["1", "2"])
def test_tune_writes_the_jax_best_hyperparams(tmp_path, monkeypatch, seeds_per_trial):
    _tiny_grids(monkeypatch)
    common = ["--n_trials", "2", "--tune_seed", "3", "--models", "gaussian", "poisson",
              "hpf_cavi", "--seeds_per_trial", seeds_per_trial, "--subsample", "2500",
              *SYN]
    want = jtune.main([*common, "--out", str(tmp_path / "jax.txt")])
    got = ttune.main([*common, "--out", str(tmp_path / "port.txt"), *CPU])
    assert sorted(got) == sorted(want) == sorted(
        [tcfg.GAUSSIAN_KEY, tcfg.POISSON_KEY, tcfg.HPF_CAVI_KEY])
    port_file = tcfg.load_best_hyperparams(str(tmp_path / "port.txt"))
    jax_file = jcfg.load_best_hyperparams(str(tmp_path / "jax.txt"))
    assert port_file == jax_file
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_tune_hpf_map_trial_and_grid(frames, monkeypatch):
    _tiny_grids(monkeypatch)
    tr, va, _ = frames
    best = ttune.tune_model("hpf_map", tr, va, n_trials=1, seed=1, device="cpu")
    assert isinstance(best, ttune.HPFMapConfig) and best.n_factors in (3, 4)
    monkeypatch.setattr(ttune, "run_model", lambda *a, **k: {"val_rmse": float(
        k["config"].n_factors * 10 + k["config"].lr)})
    assert ttune.grid_tune_hpf_map(tr, va, device="cpu").n_factors == 20


def test_tune_isolates_a_failing_trial(frames, monkeypatch, capsys):
    tr, va, _ = frames

    def boom(*args, **kwargs):
        raise FloatingPointError("diverged")

    monkeypatch.setattr(ttune, "run_model", boom)
    assert ttune.tune_model("poisson", tr, va, n_trials=2, device="cpu") is None
    assert capsys.readouterr().out.count("failed: diverged") == 2


@pytest.mark.parametrize("seeds", [1, 2])
@pytest.mark.parametrize("model", ["gaussian", "poisson", "hpf_cavi"])
def test_best_k_sweep_equals_the_jax_sweep(frames, model, seeds):
    tr, va, _ = frames
    want = jbest_k.sweep(model, tr, va, ks=[2, 3], max_iter=3, seeds=seeds)
    got = tbest_k.sweep(model, tr, va, ks=[2, 3], max_iter=3, seeds=seeds, device="cpu")
    assert [r["K"] for r in got] == [2, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("val_rmse", "val_lpl"):
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, err_msg=key)
        for gs, ws in zip(g.get("per_seed", []), w.get("per_seed", [])):
            assert gs["seed"] == ws["seed"]
            np.testing.assert_allclose([gs["val_rmse"], gs["val_lpl"]],
                                       [ws["val_rmse"], ws["val_lpl"]], rtol=TOL)
    if seeds > 1:
        assert got[0]["per_seed"][0]["val_lpl"] != got[0]["per_seed"][1]["val_lpl"]


def test_best_k_main_plots(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows, best = tbest_k.main(["--model", "hpf_cavi", "--k_min", "2", "--k_max", "4",
                               "--k_step", "2", "--max_iter", "2", "--seeds", "2",
                               "--synthetic", "600", "--synthetic_users", "60",
                               "--synthetic_items", "40", *CPU])
    assert len(rows) == 2 and best == max(rows, key=lambda r: r["val_lpl"])
    for name in ("HPF_RMSE.png", "HPF_LPL.png"):
        assert os.path.getsize(tmp_path / "reports" / "figures" / name) > 0


def _write_small_hyperparams(cfg_mod, models_mod, path):
    cfg_mod.write_best_hyperparams({
        cfg_mod.GAUSSIAN_KEY: _small(models_mod.GaussianMFConfig(use_bias=True)),
        cfg_mod.POISSON_KEY: _small(models_mod.PoissonMFConfig()),
        cfg_mod.HPF_CAVI_KEY: _small(models_mod.HPFConfig()),
        cfg_mod.HPF_MAP_KEY: _small(models_mod.HPFMapConfig()),
    }, str(path))


def test_compare_equals_the_jax_comparison(tmp_path, monkeypatch):
    import pmf_tpu.models as jmodels
    import pmf_tpu_torch.models as tmodels

    monkeypatch.chdir(tmp_path)
    _write_small_hyperparams(jcfg, jmodels, tmp_path / "jax_hp.txt")
    _write_small_hyperparams(tcfg, tmodels, tmp_path / "port_hp.txt")
    want = jcompare.main(["--hyperparams", "jax_hp.txt", "--plot", "jax.png",
                          "--params_out", "jax_params.txt", "--ranking", *SYN])
    got = tcompare.main(["--hyperparams", "port_hp.txt", "--plot", "port.png",
                         "--params_out", "port_params.txt", "--ranking", *SYN, *CPU])
    assert list(got.columns) == list(want.columns) and got.shape == want.shape == (4, 10)
    assert list(got["model"]) == list(want["model"])
    for col in got.columns:
        if col not in ("model", "fit_seconds"):
            np.testing.assert_allclose(got[col], want[col], rtol=TOL, atol=TOL, err_msg=col)
    assert os.path.getsize("port.png") > 0
    assert (tmp_path / "port_params.txt").read_text() == (
        tmp_path / "jax_params.txt").read_text()


def test_compare_isolates_a_failing_model(frames, monkeypatch, capsys):
    tr, va, te = frames
    real = tcompare.run_model

    def fail_poisson(name, *args, **kwargs):
        if name == "poisson":
            raise FloatingPointError("diverged")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(tcompare, "run_model", fail_poisson)
    hp = {k: dataclasses.asdict(_small(c)) for k, c in (
        (tcfg.GAUSSIAN_KEY, trun.DEFAULTS["gaussian_bias"]),
        (tcfg.POISSON_KEY, trun.DEFAULTS["poisson"]),
        (tcfg.HPF_CAVI_KEY, trun.DEFAULTS["hpf_cavi"]),
        (tcfg.HPF_MAP_KEY, trun.DEFAULTS["hpf_map"]))}
    df, configs = tcompare.compare_models(tr, va, te, hp, device="cpu")
    assert len(df) == 3 and len(configs) == 4
    assert "Poisson MF (CAVI) FAILED: diverged" in capsys.readouterr().out


def test_train_full_exports_equal_the_jax_exports(tmp_path, monkeypatch):
    import pmf_tpu.models as jmodels
    import pmf_tpu_torch.models as tmodels

    monkeypatch.chdir(tmp_path)
    _write_small_hyperparams(jcfg, jmodels, tmp_path / "jax_hp.txt")
    _write_small_hyperparams(tcfg, tmodels, tmp_path / "port_hp.txt")
    jtrain.main(["--model", "all", "--hyperparams", "jax_hp.txt", "--data_dir", "jax",
                 *SYN])
    models = ttrain.main(["--model", "all", "--hyperparams", "port_hp.txt",
                          "--data_dir", "port", *SYN, *CPU])
    assert sorted(models) == sorted(ttrain.SPECS)
    for name, (dir_name, *_) in ttrain.SPECS.items():
        assert models[name].fit_seconds > 0 and models[name].export_seconds > 0
        for rel in (f"embeddings/{dir_name}/user_embeddings.csv",
                    f"embeddings/{dir_name}/item_embeddings.csv",
                    f"predictions/{dir_name}/test_predictions.csv"):
            got = pd.read_csv(tmp_path / "port" / rel)
            want = pd.read_csv(tmp_path / "jax" / rel)
            assert list(got.columns) == list(want.columns) and got.shape == want.shape, rel
            np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=TOL, atol=TOL,
                                       err_msg=rel)
        cfg_txt = f"embeddings/{dir_name}/config.txt"
        assert (tmp_path / "port" / cfg_txt).read_text() == (
            tmp_path / "jax" / cfg_txt).read_text()


def test_train_full_dataset_modes_and_the_recipe_map(frames, tmp_path):
    tr, va, te = frames
    assert len(ttrain._select_union(tr, va, te, "train+val")) == len(tr) + len(va)
    assert len(ttrain._select_union(tr, va, te, "full")) == len(tr) + len(va) + len(te)
    with pytest.raises(ValueError, match="Invalid dataset_mode"):
        ttrain._select_union(tr, va, te, "all")
    n_items = int(tr["i"].max()) + 1
    os.makedirs(tmp_path / "processed")
    pd.DataFrame({"recipe_id": 1000 + np.arange(n_items), "i": np.arange(n_items)}).to_csv(
        tmp_path / "processed" / "dict_i.csv", index=False)
    hp = {tcfg.HPF_CAVI_KEY: dataclasses.asdict(_small(trun.DEFAULTS["hpf_cavi"]))}
    ttrain.train_one("hpf_cavi", tr, va, te, "full", hp, data_dir=str(tmp_path),
                     verbose=False, device="cpu")
    items = pd.read_csv(tmp_path / "embeddings" / "hpf_cavi" / "item_embeddings.csv")
    assert list(items.columns[:2]) == ["recipe_id", "0"]
    np.testing.assert_array_equal(items["recipe_id"], 1000 + np.arange(n_items))
    preds = pd.read_csv(tmp_path / "predictions" / "hpf_cavi" / "test_predictions.csv")
    users = pd.read_csv(tmp_path / "embeddings" / "hpf_cavi" / "user_embeddings.csv")
    u, i = preds["u"].to_numpy(), preds["i"].to_numpy()
    host = np.sum(users.to_numpy()[u] * items.to_numpy()[i, 1:], axis=1) - 1.0
    np.testing.assert_allclose(preds["y_pred"], host, rtol=1e-5, atol=1e-5)


def _mains(tmp_path):
    hp = ["--hyperparams", str(tmp_path / "none.txt")]
    return {
        "run_single": (trun.main, ["--model", "poisson", "--max_iter", "1", *SYN]),
        "tune": (ttune.main, ["--n_trials", "1", "--out", str(tmp_path / "b.txt"), *SYN]),
        "best_k": (tbest_k.main, ["--model", "poisson", "--k_min", "2", "--k_max", "2",
                                  *SYN]),
        "compare": (tcompare.main, [*hp, *SYN]),
        "train_full": (ttrain.main, [*hp, "--data_dir", str(tmp_path), *SYN]),
        "reproduce": (treproduce.main, ["--workdir", str(tmp_path / "w"),
                                        "--synthetic_clone", "2000"]),
    }


@pytest.mark.parametrize("name", ["run_single", "tune", "best_k", "compare",
                                  "train_full", "reproduce"])
def test_every_main_raises_without_a_card(tmp_path, monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = _mains(tmp_path)[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert "FAILED" not in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "w")  # nothing ran before the check


@pytest.mark.parametrize("name", ["tune", "compare", "train_full"])
def test_a_kernel_fault_is_not_a_failed_model(tmp_path, monkeypatch, capsys, name):
    """The per-model isolation lets a kernel or device fault raise out."""

    def fault(*args, **kwargs):
        raise KernelError("nvcc failed for cavi_edge.cu")

    for mod in (trun.HPF, trun.PoissonMF, trun.GaussianMF, trun.HPFMap):
        monkeypatch.setattr(mod, "fit", fault)
    main, argv = _mains(tmp_path)[name]
    with pytest.raises(KernelError, match="nvcc failed"):
        main([*argv, *CPU])
    assert "FAILED" not in capsys.readouterr().out


def test_setup_runtime_builds_the_kernels_on_the_card(monkeypatch):
    from pmf_tpu_torch.ops import _build

    calls = []
    monkeypatch.setattr(tcommon, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(_build, "load_library", lambda: calls.append("built"))
    assert tcommon.setup_runtime(None) == torch.device("cuda")
    assert calls == ["built"]
    monkeypatch.setattr(tcommon, "resolve_device", lambda d: torch.device("cpu"))
    assert tcommon.setup_runtime("cpu") == torch.device("cpu") and calls == ["built"]


def test_get_splits_equals_the_jax_splits():
    import argparse

    from pmf_tpu.cli.common import get_splits as j_get_splits

    parser = argparse.ArgumentParser()
    tcommon.add_data_args(parser)
    tcommon.add_device_arg(parser)
    args = parser.parse_args(SYN)
    assert args.device is None
    for got, want in zip(tcommon.get_splits(args), j_get_splits(args)):
        pd.testing.assert_frame_equal(got, want)
