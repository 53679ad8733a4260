"""The port's synthetic generators, config files and recommend CLI against
the JAX package's: equal arrays and files for one seed, config files read
across packages, and equal recommendation CSVs from one npz checkpoint."""

import dataclasses
import filecmp
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from pmf_tpu import config as jconfig
from pmf_tpu.data import synthetic as jsyn
from pmf_tpu_torch import config as tconfig
from pmf_tpu_torch.data import synthetic as tsyn

torch.set_num_threads(1)


def _equal_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_planted_equals_jax(seed):
    args = (300, 120, 4000)
    _equal_arrays(tsyn.synth_planted(*args, seed=seed, K_true=4),
                  jsyn.synth_planted(*args, seed=seed, K_true=4))


@pytest.mark.parametrize("n_test,n_val", [(1, 2), (2, 1)])
def test_leave_out_split_equals_jax(n_test, n_val):
    u, i, x = tsyn.synth_ratings(200, 90, 3000, seed=3)
    got = tsyn.leave_out_split(u, i, x, seed=4, n_test=n_test, n_val=n_val)
    want = jsyn.leave_out_split(u, i, x, seed=4, n_test=n_test, n_val=n_val)
    for g, w in zip(got, want):
        _equal_arrays(g, w)


def test_synth_foodcom_raw_equals_jax(tmp_path):
    kw = dict(n_users=400, n_items=3000, n_raw=6000, seed=2)
    got = tsyn.synth_foodcom_raw(str(tmp_path / "port"), **kw)
    want = jsyn.synth_foodcom_raw(str(tmp_path / "jax"), **kw)
    assert got == want
    for name in ("train", "validation", "test"):
        f = f"interactions_{name}.csv"
        assert filecmp.cmp(tmp_path / "port" / f, tmp_path / "jax" / f, shallow=False)


@pytest.mark.parametrize("name", ["GaussianMF", "PoissonMF", "HPF", "HPFMap"])
def test_config_classes_have_the_jax_fields(name):
    import pmf_tpu
    import pmf_tpu_torch

    t_fields = {f.name: f.default for f in
                dataclasses.fields(getattr(pmf_tpu_torch, name + "Config"))}
    j_fields = {f.name: f.default for f in
                dataclasses.fields(getattr(pmf_tpu, name + "Config"))}
    assert t_fields == j_fields


def test_best_hyperparams_round_trip_across_packages(tmp_path):
    from pmf_tpu.models.hpf import HPFConfig as JHPFConfig
    from pmf_tpu_torch import GaussianMFConfig, HPFMapConfig

    configs = {tconfig.GAUSSIAN_KEY: GaussianMFConfig(n_factors=7, sigma2=0.5),
               tconfig.HPF_MAP_KEY: HPFMapConfig(batch_size=4096),
               tconfig.POISSON_KEY: None,
               tconfig.HPF_CAVI_KEY: {"n_factors": 9, "stale_key": 1}}
    port_file, jax_file = tmp_path / "port.txt", tmp_path / "jax.txt"
    tconfig.write_best_hyperparams(configs, str(port_file))
    jconfig.write_best_hyperparams(configs, str(jax_file))
    assert port_file.read_text() == jax_file.read_text()
    got = tconfig.load_best_hyperparams(str(jax_file))
    assert got == jconfig.load_best_hyperparams(str(port_file))
    assert got[tconfig.GAUSSIAN_KEY]["sigma2"] == 0.5
    assert tconfig.POISSON_KEY not in got
    kept = tconfig.filter_config_kwargs(JHPFConfig, got[tconfig.HPF_CAVI_KEY])
    assert kept == jconfig.filter_config_kwargs(JHPFConfig, got[tconfig.HPF_CAVI_KEY])
    assert kept == {"n_factors": 9}
    assert tconfig.load_best_hyperparams(str(tmp_path / "missing.txt")) == {}


def test_recommend_cli_equals_jax(tmp_path, monkeypatch):
    from pmf_tpu.cli import common as jcommon
    from pmf_tpu.cli.recommend import main as j_main
    from pmf_tpu.models.hpf import HPF, HPFConfig
    from pmf_tpu.utils.checkpoint import save_model
    from pmf_tpu_torch.cli.recommend import main as t_main

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)  # the npz form
    monkeypatch.setattr(jcommon, "setup_runtime", lambda: None)
    u, i, x = tsyn.synth_ratings(200, 150, 3000, seed=4)
    model = HPF(HPFConfig(n_factors=5, max_iter=2, tol=None, verbose=False))
    save_model(model.fit((u, i, x + 1)), str(tmp_path / "ck"))
    pd.DataFrame({"u": u, "i": i, "rating": x}).to_csv(tmp_path / "train.csv",
                                                       index=False)
    common = ["--checkpoint", str(tmp_path / "ck"), "--k", "4", "--batch", "64",
              "--train", str(tmp_path / "train.csv")]
    j_main(common + ["--out", str(tmp_path / "jax.csv")])
    rows = t_main(common + ["--out", str(tmp_path / "port.csv"), "--device", "cpu"])
    got, want = pd.read_csv(tmp_path / "port.csv"), pd.read_csv(tmp_path / "jax.csv")
    assert len(rows) == len(got) == 200 * 4
    assert list(got.columns) == ["u", "rank", "i", "score"]
    pd.testing.assert_frame_equal(got[["u", "rank", "i"]], want[["u", "rank", "i"]])
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-5)
    for user in (0, 1, 77):
        assert not set(got[got["u"] == user]["i"]) & set(i[u == user])
    # Named users only.
    t_main(common + ["--users", "3", "9", "--out", str(tmp_path / "two.csv"),
                     "--device", "cpu"])
    two = pd.read_csv(tmp_path / "two.csv")
    pd.testing.assert_frame_equal(
        two, got[got["u"].isin([3, 9])].reset_index(drop=True))
