"""Port ``analysis/*`` against the JAX package's analysis tools on the
same artifacts (host work; no device): forecast metrics, CSV and report;
top-dimension reports; PCA coordinates and the sample plot; exploratory
stats.  Each equal to the JAX package's output, floats to 1e-12; t-SNE
runs; a missing ``umap`` gives its message and no figure."""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from pmf_tpu.analysis import embedding_viz as jviz
from pmf_tpu.analysis import exploratory as jexp
from pmf_tpu.analysis import forecasts as jfc
from pmf_tpu.analysis import top_dimensions as jtop
from pmf_tpu_torch.analysis import embedding_viz as tviz
from pmf_tpu_torch.analysis import exploratory as texp
from pmf_tpu_torch.analysis import forecasts as tfc
from pmf_tpu_torch.analysis import top_dimensions as ttop

torch.set_num_threads(1)

SYN = ["--synthetic", "3000", "--synthetic_users", "200", "--synthetic_items", "90"]


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """A data/ tree with two models' predictions and one model's item
    embeddings (with recipe ids) and recipe names, seeded."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(4)
    for model in ("gaussian_mf", "hpf_cavi"):
        y = rng.integers(0, 6, 400).astype(float)
        pred_dir = tmp_path / "data" / "predictions" / model
        os.makedirs(pred_dir)
        pd.DataFrame({"u": rng.integers(0, 50, 400), "i": rng.integers(0, 30, 400),
                      "y_true": y, "y_pred": y + rng.normal(0, 0.7, 400)}).to_csv(
            pred_dir / "test_predictions.csv", index=False)
    emb_dir = tmp_path / "data" / "embeddings" / "gaussian_mf"
    os.makedirs(emb_dir)
    emb = pd.DataFrame(rng.normal(size=(60, 6)))
    emb.insert(0, "recipe_id", 9000 + 3 * np.arange(60))
    emb.to_csv(emb_dir / "item_embeddings.csv", index=False)
    os.makedirs(tmp_path / "data" / "raw")
    pd.DataFrame({"id": emb["recipe_id"], "name": [f"dish {k}" for k in range(60)],
                  "tags": ["['vegan']" if k % 3 else "['dessert']" for k in range(60)]}
                 ).to_csv(tmp_path / "data" / "raw" / "RAW_recipes.csv", index=False)
    return tmp_path


def test_compute_metrics_equals_the_jax_metrics():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 6, 500).astype(float)
    p = y + rng.normal(0, 1, 500)
    assert tfc.compute_metrics(y, p) == jfc.compute_metrics(y, p)
    assert np.isnan(tfc.compute_metrics(np.ones(4), np.ones(4))["r2"])


def test_forecasts_report_equals_the_jax_report(artifacts):
    want = jfc.main(["--data_dir", "data", "--report_dir", "jax_reports"])
    got = tfc.main(["--data_dir", "data", "--report_dir", "port_reports"])
    pd.testing.assert_frame_equal(got, want, rtol=1e-12)
    assert list(got["model"]) == ["gaussian_mf", "hpf_cavi"]
    for name in ("forecast_metrics.csv", "forecast_analysis.md"):
        assert (artifacts / "port_reports" / name).read_text() == (
            artifacts / "jax_reports" / name).read_text()
    figs = artifacts / "port_reports" / "figures" / "forecasts"
    for model in ("gaussian_mf", "hpf_cavi"):
        for kind in ("pred_hist", "residuals"):
            assert os.path.getsize(figs / f"{model}_{kind}.png") > 0


def test_forecasts_without_predictions(tmp_path, capsys):
    assert tfc.main(["--data_dir", str(tmp_path)]) is None
    assert "No predictions found." in capsys.readouterr().out


def test_top_dimensions_equal_the_jax_reports(artifacts):
    want = jtop.analyze_top_dimensions("gaussian_mf", n_dim=3, n_items=5,
                                       out_root="jax_top")
    got = ttop.main(["--model", "gaussian_mf", "--n_dim", "3", "--n_items", "5"])
    assert got == want and len(got) == 3
    for d in got:
        name = f"dim_{d['dim']}.txt"
        text = (artifacts / ttop.OUT_ROOT / "gaussian_mf" / name).read_text()
        assert text == (artifacts / "jax_top" / "gaussian_mf" / name).read_text()
        assert "dish " in text  # recipe names joined through RAW_recipes.csv


def test_top_dimensions_missing_embeddings(tmp_path):
    with pytest.raises(FileNotFoundError, match="run train_full first"):
        ttop.analyze_top_dimensions("hpf_cavi", data_dir=str(tmp_path))


def test_pca_and_sample_equal_the_jax_reductions():
    x = np.random.default_rng(2).normal(size=(80, 7))
    for method in ("pca", "sample"):
        got, gidx = tviz.reduce_dimensions(x, method, 3)
        want, widx = jviz.reduce_dimensions(x, method, 3)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(gidx, widx)


def test_tag_colors_equal_the_jax_colors(artifacts):
    ids = pd.read_csv("data/embeddings/gaussian_mf/item_embeddings.csv")["recipe_id"]
    got = tviz.tag_colors(ids.to_numpy(), ["vegan", "dessert"], "data")
    np.testing.assert_array_equal(got, jviz.tag_colors(ids.to_numpy(), ["vegan", "dessert"],
                                                       "data"))
    assert set(got) == {1, 2}
    assert tviz.tag_colors(ids.to_numpy(), ["vegan"], "elsewhere") is None


def test_embedding_viz_main_writes_the_sample_plot(artifacts, capsys):
    tviz.main(["--model", "gaussian_mf", "--methods", "pca", "sample", "--dim", "2",
               "--tags", "vegan", "dessert"])
    out_dir = artifacts / tviz.OUT_ROOT / "gaussian_mf"
    for method in ("pca", "sample"):
        assert os.path.getsize(out_dir / f"{method}.png") > 0
    assert "wrote" in capsys.readouterr().out


def test_tsne_runs():
    x = np.random.default_rng(3).normal(size=(40, 5))
    reduced, idx = tviz.reduce_dimensions(x, "tsne", 2)
    assert reduced.shape == (40, 2) and np.isfinite(reduced).all()
    np.testing.assert_array_equal(idx, np.arange(40))


def test_missing_umap_gives_its_message(artifacts, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "umap", None)  # import umap -> ImportError
    x = np.zeros((10, 3))
    reduced, idx = tviz.reduce_dimensions(x, "umap", 2)
    assert reduced is None and len(idx) == 10
    assert "umap-learn not installed; skipping UMAP" in capsys.readouterr().out
    tviz.main(["--model", "gaussian_mf", "--methods", "umap"])
    assert not (artifacts / tviz.OUT_ROOT / "gaussian_mf" / "umap.png").exists()


def test_unknown_reduction_raises():
    with pytest.raises(ValueError, match="nope"):
        tviz.reduce_dimensions(np.zeros((3, 3)), "nope", 2)


def test_exploratory_stats_equal_the_jax_stats(tmp_path):
    got = texp.main([*SYN, "--out_dir", str(tmp_path / "port")])
    want = jexp.main([*SYN, "--out_dir", str(tmp_path / "jax")])
    assert got == want and got["n_train"] > 0
    for name in ("split_stats.txt",):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    for name in ("rating_distribution.png", "user_activity_longtail.png",
                 "item_popularity_longtail.png"):
        assert os.path.getsize(tmp_path / "port" / name) > 0


def test_exploratory_raw_stats_equal_the_jax_stats(tmp_path, capsys):
    from pmf_tpu_torch.data.synthetic import synth_foodcom_raw

    raw = tmp_path / "raw"
    synth_foodcom_raw(str(raw), n_users=100, n_items=60, n_raw=1500, seed=1)
    df = pd.concat(pd.read_csv(raw / f"interactions_{s}.csv")
                   for s in ("train", "validation", "test"))
    df.to_csv(raw / "RAW_interactions.csv", index=False)
    got = texp.analyze_raw(str(raw), str(tmp_path / "port"))
    assert got == jexp.analyze_raw(str(raw), str(tmp_path / "jax"))
    assert got["n_rows"] == 1500
    assert os.path.getsize(tmp_path / "port" / "raw_rating_distribution.png") > 0
    assert texp.analyze_raw(str(tmp_path / "none")) is None
