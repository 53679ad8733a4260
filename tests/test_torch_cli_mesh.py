"""The CLIs' ``--mesh_devices`` (run_single, compare, train_full,
recommend) in a gloo world of 2 ranks on the CPU: every rank returns the
same result, rank 0 alone writes files, and each result equals the JAX
CLI's ``--mesh_devices 2`` run (2 of conftest's virtual CPU devices) and
the port's own one-device run at ``tests/test_torch_cli.py``'s tolerance.
Also: a real ``torch.distributed.run`` of run_single (the ``env://``
path), the error without torchrun, a model that fails on one rank only,
and the layout cache shared by the ranks.  JAX is imported inside the
tests only: the spawned ranks import torch, numpy and the port."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from tests.torch_world import World, numpy_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SYN = ["--synthetic", "4000", "--synthetic_users", "300", "--synthetic_items", "120"]
CPU = ["--device", "cpu"]
MESH = ["--mesh_devices", "2"]
SMALL = ["--max_iter", "3", "--n_factors", "4"]
MODELS = ["hpf_cavi", "gaussian_bias", "poisson_extended", "hpf_map"]
TOL = 1e-4  # tests/test_torch_cli.py's TOL
EXPORTS = ("embeddings/{d}/user_embeddings.csv", "embeddings/{d}/item_embeddings.csv",
           "predictions/{d}/test_predictions.csv")
METRICS = [f"{s}_{m}" for s in ("train", "val", "test") for m in ("rmse", "macro_mae")]


def _write_small_hyperparams(cfg_mod, models_mod, path):
    """Both packages' best_hyperparams.txt at K = 4 and a few iterations
    (HPF-MAP full batch, so its shuffle does not matter)."""
    small = dict(n_factors=4, verbose=False)
    cfg_mod.write_best_hyperparams({
        cfg_mod.GAUSSIAN_KEY: models_mod.GaussianMFConfig(**small, max_iter=3,
                                                          use_bias=True),
        cfg_mod.POISSON_KEY: models_mod.PoissonMFConfig(**small, max_iter=3),
        cfg_mod.HPF_CAVI_KEY: models_mod.HPFConfig(**small, max_iter=3),
        cfg_mod.HPF_MAP_KEY: models_mod.HPFMapConfig(**small, epochs=3, batch_size=1 << 14),
    }, str(path))


def _files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _table(df):
    return None if df is None else df.drop(columns=["fit_seconds"]).to_dict("list")


def cli_world(rank, world, root, ckpt):
    """Each CLI's main with --mesh_devices 2 in this rank's own working
    directory; returns what every rank computed and the files it wrote."""
    from pmf_tpu_torch import config as cfg_io
    from pmf_tpu_torch import models as tmodels
    from pmf_tpu_torch.cli import compare, recommend, run_single, train_full

    cwd = Path(root) / f"rank{rank}"
    cwd.mkdir()
    os.chdir(cwd)
    hp = str(Path(root) / "hp.txt")
    if rank == 0:
        _write_small_hyperparams(cfg_io, tmodels, hp)
    torch.distributed.barrier()
    out = {"run_single": {}}
    for name in MODELS:
        res = run_single.main(["--model", name, *SMALL, *MESH, *SYN, *CPU])
        out["run_single"][name] = ({k: res[k] for k in METRICS},
                                   numpy_state(res["_model"].state))
    out["compare"] = _table(compare.main(["--hyperparams", hp, "--ranking", *MESH,
                                          *SYN, *CPU]))
    models = train_full.main(["--model", "all", "--hyperparams", hp, "--data_dir",
                              "exports", *MESH, *SYN, *CPU])
    out["train_full"] = {k: numpy_state(m.state) for k, m in models.items()}
    rows = recommend.main(["--checkpoint", ckpt, "--k", "4", "--out", "rec.csv",
                           *MESH, *CPU])
    out["recommend"] = rows.to_dict("list")
    # The layout cache shared by the ranks: a blocked fit cold, then warm.
    out["cached"] = [
        numpy_state(run_single.main(["--model", "hpf_cavi", "--engine", "blocked_high",
                                     *SMALL, *MESH, *SYN, *CPU])["_model"].state)
        for _ in range(2)]
    out["files"] = _files(cwd)
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A fitted HPF checkpoint, written by the port on the CPU."""
    from pmf_tpu_torch.data.synthetic import synth_ratings
    from pmf_tpu_torch.models.hpf import HPF, HPFConfig
    from pmf_tpu_torch.utils.checkpoint import save_model

    u, i, x = synth_ratings(200, 150, 3000, seed=4)
    path = str(tmp_path_factory.mktemp("ckpt") / "ck")
    save_model(HPF(HPFConfig(n_factors=5, max_iter=2, tol=None, verbose=False)).fit(
        (u, i, x + 1), device="cpu"), path)
    return path


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("layouts")


@pytest.fixture(scope="module")
def world_root(tmp_path_factory):
    return tmp_path_factory.mktemp("cli_world")


@pytest.fixture(scope="module")
def ranks(world_root, ckpt, cache_dir):
    from pmf_tpu_torch.data import layout_cache

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(layout_cache.ENV_VAR, str(cache_dir))  # inherited by the ranks
        return World(cli_world, 2, world_root, str(world_root), ckpt).join()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, ckpt):
    """The JAX CLIs with --mesh_devices 2 on the same data and configs."""
    import pmf_tpu.models as jmodels
    from pmf_tpu import config as jcfg
    from pmf_tpu.cli import common as jcommon
    from pmf_tpu.cli import compare as jcompare
    from pmf_tpu.cli import recommend as jrec
    from pmf_tpu.cli import run_single as jrun
    from pmf_tpu.cli import train_full as jtrain

    root = tmp_path_factory.mktemp("jax_cli")
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jrun, jcompare, jtrain, jcommon):
            mp.setattr(mod, "setup_runtime", lambda: None)
        mp.setitem(sys.modules, "orbax.checkpoint", None)  # the npz form
        mp.chdir(root)
        _write_small_hyperparams(jcfg, jmodels, root / "hp.txt")
        out = {"run_single": {name: jrun.main(["--model", name, *SMALL, *MESH, *SYN])
                              for name in MODELS}}
        out["compare"] = jcompare.main(["--hyperparams", "hp.txt", "--ranking", *MESH,
                                        *SYN])
        jtrain.main(["--model", "all", "--hyperparams", "hp.txt", "--data_dir", "exports",
                     *MESH, *SYN])
        jrec.main(["--checkpoint", ckpt, "--k", "4", "--out", "rec.csv", *MESH])
    out["root"] = root
    return out


@pytest.fixture(scope="module")
def one_device(tmp_path_factory, ckpt):
    """The port's own CLIs on one device (no mesh)."""
    from pmf_tpu_torch import config as tcfg
    from pmf_tpu_torch import models as tmodels
    from pmf_tpu_torch.cli import compare, recommend, run_single, train_full
    from pmf_tpu_torch.data import layout_cache

    root = tmp_path_factory.mktemp("one_device")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(layout_cache.ENV_VAR, str(root / "layouts"))
        mp.chdir(root)
        _write_small_hyperparams(tcfg, tmodels, root / "hp.txt")
        out = {"run_single": {name: run_single.main(["--model", name, *SMALL, *SYN, *CPU])
                              for name in MODELS}}
        out["compare"] = compare.main(["--hyperparams", "hp.txt", "--ranking", *SYN, *CPU])
        out["train_full"] = train_full.main(["--model", "all", "--hyperparams", "hp.txt",
                                             "--data_dir", "exports", *SYN, *CPU])
        recommend.main(["--checkpoint", ckpt, "--k", "4", "--out", "rec.csv", *CPU])
        out["cached"] = run_single.main(["--model", "hpf_cavi", "--engine", "blocked_high",
                                         *SMALL, *SYN, *CPU])
    out["root"] = root
    return out


def _same(a, b):
    """Equal in bits: dicts and lists of arrays or numbers."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b)


@pytest.mark.parametrize("cli", ["run_single", "compare", "train_full", "recommend",
                                 "cached"])
def test_every_rank_returns_the_same_result(ranks, cli):
    _same(ranks[0][cli], ranks[1][cli])


def test_rank_zero_alone_writes_files(ranks):
    """Rank 0 wrote the plot, the params, the exports and the CSV; rank 1
    wrote nothing."""
    want = {"model_comparison_plots.png", "model_comparison_params.txt", "rec.csv"}
    want |= {rel.format(d=d) for d in ("gaussian_mf", "poisson_mf", "hpf_cavi",
                                       "hpf_pytorch")
             for rel in ("exports/" + e for e in EXPORTS)}
    want |= {f"exports/embeddings/{d}/config.txt" for d in ("gaussian_mf", "poisson_mf",
                                                             "hpf_cavi", "hpf_pytorch")}
    assert set(ranks[0]["files"]) == want
    assert ranks[1]["files"] == []


@pytest.mark.parametrize("model", MODELS)
def test_run_single_mesh_equals_the_jax_mesh_run(ranks, jax_runs, model):
    got, _ = ranks[0]["run_single"][model]
    want = jax_runs["run_single"][model]
    for key in METRICS:
        assert np.isfinite(got[key]) and abs(got[key] - want[key]) < TOL, key


@pytest.mark.parametrize("model", MODELS)
def test_run_single_mesh_equals_one_device(ranks, one_device, model):
    got, state = ranks[0]["run_single"][model]
    want = one_device["run_single"][model]
    for key in METRICS:
        assert abs(got[key] - want[key]) < TOL, key
    for k, v in numpy_state(want["_model"].state).items():
        np.testing.assert_allclose(state[k], v, rtol=TOL, atol=TOL, err_msg=k)


def _frames_close(got: dict, want: pd.DataFrame):
    assert list(got) == [c for c in want.columns if c != "fit_seconds"]
    assert got["model"] == list(want["model"])
    for col in got:
        if col != "model":
            np.testing.assert_allclose(got[col], want[col], rtol=TOL, atol=TOL,
                                       err_msg=col)


def test_compare_mesh_equals_the_jax_mesh_comparison(ranks, jax_runs):
    assert len(jax_runs["compare"]) == 4
    _frames_close(ranks[0]["compare"], jax_runs["compare"])


def test_compare_mesh_equals_one_device(ranks, one_device):
    _frames_close(ranks[0]["compare"], one_device["compare"])


@pytest.mark.parametrize("other", ["jax", "one_device"])
def test_train_full_mesh_exports_equal(ranks, world_root, jax_runs, one_device, other):
    root = (jax_runs if other == "jax" else one_device)["root"]
    for d in ("gaussian_mf", "poisson_mf", "hpf_cavi", "hpf_pytorch"):
        for rel in EXPORTS:
            rel = "exports/" + rel.format(d=d)
            got = pd.read_csv(world_root / "rank0" / rel)
            want = pd.read_csv(root / rel)
            assert list(got.columns) == list(want.columns) and got.shape == want.shape, rel
            np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=TOL,
                                       atol=TOL, err_msg=rel)


def test_train_full_mesh_states_equal_one_device(ranks, one_device):
    assert sorted(ranks[0]["train_full"]) == sorted(one_device["train_full"])
    for name, state in ranks[0]["train_full"].items():
        for k, v in numpy_state(one_device["train_full"][name].state).items():
            np.testing.assert_allclose(state[k], v, rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("other", ["jax", "one_device"])
def test_recommend_mesh_equals(ranks, jax_runs, one_device, other):
    got = pd.DataFrame(ranks[0]["recommend"])
    want = pd.read_csv((jax_runs if other == "jax" else one_device)["root"] / "rec.csv")
    assert len(got) == 200 * 4
    pd.testing.assert_frame_equal(got[["u", "rank", "i"]], want[["u", "rank", "i"]],
                                  check_dtype=False)
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-5)


def test_ranks_share_one_layout_cache_entry(ranks, one_device, cache_dir):
    """Both ranks built the same single-device blocked layout and wrote
    the same entry (a temporary file moved into place): one entry, and
    the warm fit (read from it) equals the cold one in bits."""
    from pmf_tpu_torch.data import layout_cache

    entries = [p.name for p in Path(cache_dir).iterdir()]
    assert len(entries) == 1 and entries[0].startswith(layout_cache.KIND + "_")
    cold, warm = ranks[0]["cached"]
    _same(cold, warm)
    for k, v in numpy_state(one_device["cached"]["_model"].state).items():
        np.testing.assert_allclose(cold[k], v, rtol=TOL, atol=TOL, err_msg=k)


def failing_world(rank, world, root):
    """compare with --mesh_devices 2 where Poisson MF fails on rank 1 only,
    after its fit (its collectives done): the ranks agree to skip it, so
    every rank goes on to the same next model."""
    from pmf_tpu_torch.cli import compare

    real = compare.run_model

    def fail_on_rank_one(name, *args, **kwargs):
        res = real(name, *args, **kwargs)
        if name == "poisson" and rank == 1:
            raise FloatingPointError("diverged")
        return res

    compare.run_model = fail_on_rank_one
    os.chdir(root)
    df = compare.main(["--hyperparams", "hp.txt", "--plot", f"p{rank}.png",
                       "--params_out", f"p{rank}.txt", *MESH, *SYN, *CPU])
    return list(df["model"])


def test_a_model_failing_on_one_rank_is_skipped_on_every_rank(tmp_path, monkeypatch):
    """The world ends within JOIN_SECONDS, or the test fails."""
    from pmf_tpu_torch import config as tcfg
    from pmf_tpu_torch import models as tmodels

    _write_small_hyperparams(tcfg, tmodels, tmp_path / "hp.txt")
    monkeypatch.setenv("PMF_TPU_TORCH_LAYOUT_CACHE", "")
    names = World(failing_world, 2, tmp_path, str(tmp_path)).join()
    assert names[0] == names[1] == ["Gaussian MF (CAVI)", "HPF (CAVI)", "HPF (MAP)"]


@pytest.mark.parametrize("name", ["run_single", "compare", "train_full", "recommend"])
def test_mesh_without_torchrun_raises_and_names_it(tmp_path, monkeypatch, capsys, name,
                                                   ckpt):
    """No process group and no torchrun environment: the CLI raises with
    the torchrun line to use before any model runs; nothing falls back to
    one device."""
    import importlib

    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PMF_TPU_TORCH_LAYOUT_CACHE", "")
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(f"pmf_tpu_torch.cli.{name}").main
    argv = {"run_single": ["--model", "poisson", *SYN],
            "compare": ["--hyperparams", "none.txt", *SYN],
            "train_full": ["--hyperparams", "none.txt", "--data_dir", "x", *SYN],
            "recommend": ["--checkpoint", ckpt]}[name]
    with pytest.raises(RuntimeError, match=f"torchrun --nproc_per_node 2 -m "
                                           f"pmf_tpu_torch.cli.{name}"):
        main([*argv, *MESH, *CPU])
    assert "===" not in capsys.readouterr().out and not os.listdir(tmp_path)


def test_a_world_size_other_than_mesh_devices_raises(monkeypatch):
    from pmf_tpu_torch.cli import run_single

    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError, match="WORLD_SIZE=3: give --nproc_per_node 2"):
        run_single.main(["--model", "poisson", *MESH, *SYN, *CPU])


def test_run_single_under_torch_distributed_run(tmp_path):
    """The env:// path: two processes started by torch.distributed.run,
    each running run_single --mesh_devices 2 --device cpu over gloo; rank
    0 alone prints the result lines."""
    env = dict(os.environ, PMF_TPU_TORCH_LAYOUT_CACHE="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "pmf_tpu_torch.cli.run_single", "--model",
         "poisson", *SMALL, *MESH, *SYN, *CPU],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("=== run_single: poisson ===") == 1
    assert proc.stdout.count("fit time") == 1
