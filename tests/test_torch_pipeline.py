"""Port ``data.pipeline`` and ``utils.mapping`` against the JAX package
on the CPU: the same raw files through both preprocessings give
byte-identical processed CSVs; the loaders give equal frames; the legacy
preprocessing equal files and parts; both ``dict_i.csv`` schemas map
alike; ``unzip_files`` and ``download_dataset`` (the kaggle CLI,
monkeypatched) behave as the reference's."""

import os
import subprocess
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch

from pmf_tpu.data import pipeline as jpipe
from pmf_tpu.utils.mapping import get_recipe_id_map as j_id_map
from pmf_tpu_torch.data import pipeline as tpipe
from pmf_tpu_torch.data.synthetic import synth_foodcom_raw
from pmf_tpu_torch.utils.mapping import get_recipe_id_map as t_id_map

torch.set_num_threads(1)

PROCESSED = ("interactions_train.csv", "interactions_validation.csv",
             "interactions_test.csv", "dict_i.csv", "dict_u.csv")


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    raw = root / "raw"
    synth_foodcom_raw(str(raw), n_users=300, n_items=150, n_raw=6000, seed=3)
    jpipe.preprocess_data(str(raw), str(root / "jax"))
    tpipe.preprocess_data(str(raw), str(root / "port"))
    return root


@pytest.mark.parametrize("name", PROCESSED)
def test_preprocess_is_byte_identical_to_the_jax_package(processed, name):
    got = (processed / "port" / name).read_bytes()
    assert got == (processed / "jax" / name).read_bytes()
    assert len(got.splitlines()) > 10


def test_preprocess_split_rules(processed):
    train, val, test = tpipe.load_all_splits(str(processed / "port"))
    assert (test.groupby("u").size() == 1).all()
    assert (val.groupby("u").size() == 2).all()
    counts = pd.concat([train, val, test]).groupby("u").size()
    assert counts.min() >= 5


@pytest.mark.parametrize("split", ["train", "validation", "test"])
def test_load_interactions_equals_the_jax_loader(processed, split):
    got = tpipe.load_interactions(split, str(processed / "port"))
    want = jpipe.load_interactions(split, str(processed / "jax"))
    assert list(got.columns) == ["u", "i", "rating"]
    assert got["u"].dtype == np.int64 and got["rating"].dtype == np.float64
    pd.testing.assert_frame_equal(got, want)


def test_centered_loader_equals_the_jax_loader(processed):
    got = tpipe.load_all_splits_centered(str(processed / "port"))
    want = jpipe.load_all_splits_centered(str(processed / "jax"))
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        pd.testing.assert_frame_equal(g, w)
    assert abs(got[0]["rating"].mean()) < 1e-12


def test_load_interactions_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="interactions_train.csv"):
        tpipe.load_interactions("train", str(tmp_path))


def _legacy_raw(raw_dir, seed=3, n=4000):
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    user_ids = rng.integers(1000, 1080, n)
    recipe_ids = rng.integers(50000, 50060, n)
    pd.DataFrame({
        "user_id": user_ids, "recipe_id": recipe_ids,
        "date": "2020-01-01", "rating": rng.integers(0, 6, n),
    }).to_csv(os.path.join(raw_dir, "RAW_interactions.csv"), index=False)
    uniq_r = np.unique(recipe_ids)
    # PP index i is a shuffled stand-in for the Kaggle one.
    pd.DataFrame({"id": uniq_r, "i": rng.permutation(len(uniq_r))}).to_csv(
        os.path.join(raw_dir, "PP_recipes.csv"), index=False)
    uniq_u = np.unique(user_ids)
    for s in ("train", "test", "validation"):
        pd.DataFrame({"user_id": uniq_u, "u": np.arange(len(uniq_u)),
                      "recipe_id": uniq_r[0], "rating": 5}).to_csv(
            os.path.join(raw_dir, f"interactions_{s}.csv"), index=False)


def test_legacy_preprocessing_equals_the_jax_package(tmp_path):
    raw = str(tmp_path / "raw")
    _legacy_raw(raw)
    got = tpipe.legacy_generate_processed_data(raw, str(tmp_path / "port"))
    want = jpipe.legacy_generate_processed_data(raw, str(tmp_path / "jax"))
    for name in ("interactions_processed.csv", "train.csv", "val.csv", "test.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert list(got) == ["train", "val", "test"]
    for k in got:
        pd.testing.assert_frame_equal(got[k], want[k])
    total = sum(len(p) for p in got.values())
    assert abs(len(got["train"]) - 0.8 * total) <= 1


def test_id_map_canonical_schema_equals_the_jax_map(processed, tmp_path):
    data = tmp_path / "data"
    os.makedirs(data / "processed")
    (data / "processed" / "dict_i.csv").write_bytes(
        (processed / "port" / "dict_i.csv").read_bytes())
    got, want = t_id_map(str(data)), j_id_map(str(data))
    np.testing.assert_array_equal(got, want)
    dict_i = pd.read_csv(data / "processed" / "dict_i.csv")
    assert got.dtype == np.int64 and len(got) == len(dict_i)
    np.testing.assert_array_equal(got[dict_i["i"].to_numpy()], dict_i["recipe_id"].to_numpy())


def test_id_map_legacy_schema_equals_the_jax_map(tmp_path):
    data = tmp_path / "data"
    os.makedirs(data / "processed")
    os.makedirs(data / "raw")
    # i_new -> Kaggle PP index i -> recipe id; PP index 9 has no recipe.
    pd.DataFrame({"i_new": [2, 0, 1, 3], "i": [7, 5, 6, 9]}).to_csv(
        data / "processed" / "dict_i.csv", index=False)
    pd.DataFrame({"id": [500, 600, 700], "i": [5, 6, 7]}).to_csv(
        data / "raw" / "PP_recipes.csv", index=False)
    got = t_id_map(str(data))
    np.testing.assert_array_equal(got, j_id_map(str(data)))
    np.testing.assert_array_equal(got, [500, 600, 700, -1])
    os.remove(data / "raw" / "PP_recipes.csv")
    assert t_id_map(str(data)) is None  # legacy schema without PP_recipes


def test_id_map_missing_or_unknown_schema(tmp_path, capsys):
    assert t_id_map(str(tmp_path)) is None
    assert "not found" in capsys.readouterr().out
    os.makedirs(tmp_path / "processed")
    pd.DataFrame({"a": [1], "b": [2]}).to_csv(tmp_path / "processed" / "dict_i.csv",
                                             index=False)
    assert t_id_map(str(tmp_path)) is None
    assert "neither" in capsys.readouterr().out


def test_unzip_files(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    with zipfile.ZipFile(raw / "a.zip", "w") as zf:
        zf.writestr("interactions_train.csv", "user_id,recipe_id,rating\n")
    with zipfile.ZipFile(raw / "b.zip", "w") as zf:
        zf.writestr("PP_recipes.csv", "id,i\n")
    (raw / "notes.txt").write_text("not a zip")
    tpipe.unzip_files(str(raw))
    assert (raw / "interactions_train.csv").read_text().startswith("user_id")
    assert (raw / "PP_recipes.csv").read_text() == "id,i\n"
    assert (raw / "notes.txt").read_text() == "not a zip"


def test_download_dataset_calls_the_kaggle_cli(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, check: calls.append((cmd, check)))
    raw = tmp_path / "raw" / "nested"
    tpipe.download_dataset(str(raw))
    assert raw.is_dir()
    (cmd, check), = calls
    assert check is True
    assert cmd == ["kaggle", "datasets", "download", "-d", jpipe.DATASET, "-p", str(raw)]
    assert tpipe.DATASET == jpipe.DATASET
