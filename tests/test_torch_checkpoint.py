"""Checkpoints of the port against the JAX package's: the npz form loads
both ways with equal predictions and recommendations, a resumed fit
equals an unbroken one exactly, a JAX CAVI checkpoint resumed in the port
continues the JAX history, and the errors name their cause.  The JAX side
writes its npz form with ``orbax.checkpoint`` hidden."""

import json
import sys

import numpy as np
import pytest
import torch

from pmf_tpu.models import gaussian_mf as jgmf
from pmf_tpu.models import hpf as jhpf
from pmf_tpu.models import hpf_map as jmap
from pmf_tpu.models import poisson_mf as jpmf
from pmf_tpu.utils import checkpoint as jck
from pmf_tpu_torch.models import gaussian_mf as tgmf
from pmf_tpu_torch.models import hpf as thpf
from pmf_tpu_torch.models import hpf_map as tmap
from pmf_tpu_torch.models import poisson_mf as tpmf
from pmf_tpu_torch.models.base import FitLoop, poisson_stop_rule
from pmf_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)


@pytest.fixture
def no_orbax(monkeypatch):
    """The JAX package writes its npz form when orbax cannot be imported."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _splits(small_splits):
    (tu, ti, tx), (vu, vi, vx), (su, si, sx) = small_splits
    return (tu, ti, tx + 1.0), (vu, vi, vx + 1.0), (su, si, sx + 1.0)


# name -> (JAX class, JAX config, port class, port config, extra config)
FAMILIES = {
    "hpf": (jhpf.HPF, jhpf.HPFConfig, thpf.HPF, thpf.HPFConfig, {}),
    "poisson": (jpmf.PoissonMF, jpmf.PoissonMFConfig, tpmf.PoissonMF,
                tpmf.PoissonMFConfig, {}),
    "extended": (jpmf.PoissonMF, jpmf.PoissonMFConfig, tpmf.PoissonMF,
                 tpmf.PoissonMFConfig, {"extended": True}),
    "gaussian": (jgmf.GaussianMF, jgmf.GaussianMFConfig, tgmf.GaussianMF,
                 tgmf.GaussianMFConfig, {}),
    "gaussian_diag": (jgmf.GaussianMF, jgmf.GaussianMFConfig, tgmf.GaussianMF,
                      tgmf.GaussianMFConfig, {"covariance": "diag"}),
    "map": (jmap.HPFMap, jmap.HPFMapConfig, tmap.HPFMap, tmap.HPFMapConfig,
            {"batch_size": 256, "lr": 0.01}),
}


def _cfg(family, cls, length, **kw):
    extra = FAMILIES[family][4]
    if family == "map":
        return cls(n_factors=4, epochs=length, verbose=False, **extra, **kw)
    return cls(n_factors=4, max_iter=length, tol=None, verbose=False, **extra, **kw)


def test_state_round_trip(tmp_path):
    state = {"a": torch.arange(6.0).reshape(2, 3), "b": np.ones(4, np.float32),
             "c": torch.tensor(7, dtype=torch.int32)}
    tck.save_state(str(tmp_path / "ck"), state, {"iteration": 3})
    got, meta = tck.load_state(str(tmp_path / "ck"))
    assert meta == {"iteration": 3}
    np.testing.assert_array_equal(got["a"], state["a"].numpy())
    assert got["a"].dtype == np.float32 and got["c"].dtype == np.int32
    np.testing.assert_array_equal(got["b"], state["b"])
    # The JAX package reads the same directory.
    jgot, jmeta = jck.load_state(str(tmp_path / "ck"))
    assert jmeta == meta and sorted(jgot) == ["a", "b", "c"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_round_trip_in_the_port(tmp_path, small_splits, family):
    train, val, test = _splits(small_splits)
    _, _, tcls, tcfg, _ = FAMILIES[family]
    model = tcls(_cfg(family, tcfg, 2)).fit(train, val, device="cpu")
    tck.save_model(model, str(tmp_path / "ck"))
    loaded = tck.load_model(str(tmp_path / "ck"), device="cpu")
    assert type(loaded) is tcls and loaded.config == model.config
    assert (loaded.n_users, loaded.n_items) == (model.n_users, model.n_items)
    for k, v in model.state.items():
        assert torch.equal(loaded.state[k], v), k
    np.testing.assert_array_equal(loaded.predict(test[0], test[1]),
                                  model.predict(test[0], test[1]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_checkpoint_loads_in_the_jax_package(tmp_path, small_splits, family):
    train, val, test = _splits(small_splits)
    _, _, tcls, tcfg, _ = FAMILIES[family]
    gm = 3.5 if family.startswith("gaussian") else None
    kw = {"global_mean": gm} if gm is not None else {}
    model = tcls(_cfg(family, tcfg, 2)).fit(train, val, device="cpu", **kw)
    tck.save_model(model, str(tmp_path / "ck"))
    jm = jck.load_model(str(tmp_path / "ck"))
    assert type(jm).__name__ == type(model).__name__
    args = (test[0], test[1]) + ((gm,) if gm is not None else ())
    np.testing.assert_allclose(jm.predict(*args), model.predict(*args),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_checkpoint_loads_in_the_port(tmp_path, small_splits, no_orbax, family):
    train, val, test = _splits(small_splits)
    jcls, jcfg, tcls, _, _ = FAMILIES[family]
    gm = 3.5 if family.startswith("gaussian") else None
    kw = {"global_mean": gm} if gm is not None else {}
    jm = jcls(_cfg(family, jcfg, 2)).fit(train, val, **kw)
    jck.save_model(jm, str(tmp_path / "ck"))
    assert (tmp_path / "ck" / "state.npz").exists()
    tm = tck.load_model(str(tmp_path / "ck"), device="cpu")
    assert type(tm) is tcls and tm.device == torch.device("cpu")
    args = (test[0], test[1]) + ((gm,) if gm is not None else ())
    np.testing.assert_allclose(tm.predict(*args), jm.predict(*args),
                               rtol=1e-6, atol=1e-7)
    users = np.arange(0, jm.n_users, 7)
    j_items, j_scores = jm.recommend(users, k=5, train=train)
    t_items, t_scores = tm.recommend(users, k=5, train=train)
    np.testing.assert_array_equal(t_items, j_items)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5, atol=1e-6)


def _assert_states_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("family,engine", [
    ("hpf", "flat"), ("hpf", "blocked_high"), ("poisson", "flat"),
    ("extended", "blocked_high"), ("gaussian", "flat"),
    ("gaussian", "blocked_high"), ("gaussian_diag", "flat"), ("map", "flat"),
    ("map", "blocked_high")])
def test_resumed_fit_equals_an_unbroken_fit(tmp_path, small_splits, family, engine):
    train, val, _ = _splits(small_splits)
    _, _, tcls, tcfg, _ = FAMILIES[family]
    ck = str(tmp_path / "ck")
    if family == "map":
        full = tcls(_cfg(family, tcfg, 5, engine=engine)).fit(train, val, device="cpu")
        tcls(_cfg(family, tcfg, 2, engine=engine)).fit(
            train, val, device="cpu", checkpoint_dir=ck, checkpoint_every=2)
        resumed = tcls(_cfg(family, tcfg, 5, engine=engine)).fit(
            train, val, device="cpu", resume_from=ck)
        assert [r["epoch"] for r in resumed.fit_history] == [3, 4, 5]
        assert [r["train_loss"] for r in resumed.fit_history] == [
            r["train_loss"] for r in full.fit_history[2:]]
    else:
        full = tcls(_cfg(family, tcfg, 5, engine=engine)).fit(train, val, device="cpu")
        tcls(_cfg(family, tcfg, 2, engine=engine)).fit(
            train, val, device="cpu", checkpoint_dir=ck, checkpoint_every=2)
        resumed = tcls(_cfg(family, tcfg, 3, engine=engine)).fit(
            train, val, device="cpu", resume_from=ck)
        assert [r["val_rmse"] for r in resumed.fit_history] == [
            r["val_rmse"] for r in full.fit_history[2:]]
    _assert_states_equal(resumed.state, full.state)


def test_jax_cavi_checkpoint_continues_the_jax_history(tmp_path, small_splits,
                                                       no_orbax):
    train, val, _ = _splits(small_splits)
    kw = dict(n_factors=4, tol=None, verbose=False, dtype="float64", engine="flat")
    ck = str(tmp_path / "ck")
    jfull = jhpf.HPF(jhpf.HPFConfig(max_iter=6, **kw)).fit(train, val)
    jhpf.HPF(jhpf.HPFConfig(max_iter=3, **kw)).fit(
        train, val, checkpoint_dir=ck, checkpoint_every=3)
    resumed = thpf.HPF(thpf.HPFConfig(max_iter=3, **kw)).fit(
        train, val, device="cpu", resume_from=ck)
    got = [r["val_rmse"] for r in resumed.fit_history]
    want = [r["val_rmse"] for r in jfull.fit_history[3:]]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for k, v in resumed.state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jfull.state[k]),
                                   rtol=1e-6, err_msg=k)


def test_periodic_checkpoint_meta_and_state(tmp_path, small_splits):
    train, val, _ = _splits(small_splits)
    ck = str(tmp_path / "ck")
    cfg = dict(n_factors=4, tol=None, verbose=False, engine="flat")
    thpf.HPF(thpf.HPFConfig(max_iter=5, **cfg)).fit(
        train, val, device="cpu", checkpoint_dir=ck, checkpoint_every=2)
    at4 = thpf.HPF(thpf.HPFConfig(max_iter=4, **cfg)).fit(train, val, device="cpu")
    with open(f"{ck}/meta.json") as f:
        assert json.load(f) == {"iteration": 4, "name": "HPF"}
    state, meta = tck.load_state(ck)
    assert meta["iteration"] == 4
    # The state of sweep 4, not the speculative sweep 5 queued after it.
    for k, v in at4.state.items():
        np.testing.assert_array_equal(state[k], v.numpy(), err_msg=k)


def test_fit_loop_without_val_checkpoints(tmp_path, small_splits):
    from pmf_tpu_torch.data.coo import build_ratings

    train, _, _ = _splits(small_splits)
    cfg = thpf.HPFConfig(n_factors=4, max_iter=4, tol=None, verbose=False)
    data = build_ratings(*train, device="cpu")
    state = thpf.init_state(data.n_users, data.n_items, cfg, device="cpu")
    loop = FitLoop(lambda s, d: thpf.sweep(s, d, cfg.a, cfg.a_prime, cfg.b_prime,
                                           cfg.c, cfg.c_prime, cfg.d_prime),
                   None, cfg.max_iter, cfg.tol, poisson_stop_rule,
                   checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    final = loop.run(state, data, None)
    got, meta = tck.load_state(str(tmp_path / "ck"))
    assert meta == {"iteration": 4, "name": "CAVI"}
    np.testing.assert_array_equal(got["a_theta"], final["a_theta"].numpy())


def test_profile_dir_writes_a_trace(tmp_path, small_splits):
    train, val, _ = _splits(small_splits)
    thpf.HPF(thpf.HPFConfig(n_factors=3, max_iter=2, verbose=False)).fit(
        train, val, device="cpu", profile_dir=str(tmp_path / "prof"))
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_resume_shape_mismatch_names_the_key(tmp_path, small_splits):
    train, val, _ = _splits(small_splits)
    ck = str(tmp_path / "ck")
    thpf.HPF(thpf.HPFConfig(n_factors=4, max_iter=1, verbose=False)).fit(
        train, val, device="cpu", checkpoint_dir=ck, checkpoint_every=1)
    with pytest.raises(ValueError, match=r"does not match model state \(key a_theta: "
                                         r"\(150, 4\) vs \(150, 3\)\)"):
        thpf.HPF(thpf.HPFConfig(n_factors=3, max_iter=1, verbose=False)).fit(
            train, val, device="cpu", resume_from=ck)
    # Rows padded (as the JAX package's TP checkpoints are): the hint.
    state, _ = tck.load_state(ck)
    tck.save_state(ck, {k: np.concatenate([v, v[:2]]) for k, v in state.items()})
    with pytest.raises(ValueError, match="mesh-padded row counts"):
        thpf.HPF(thpf.HPFConfig(n_factors=4, max_iter=1, verbose=False)).fit(
            train, val, device="cpu", resume_from=ck)


def test_orbax_only_checkpoint_is_named(tmp_path):
    (tmp_path / "ck" / "state.orbax").mkdir(parents=True)
    with pytest.raises(ValueError, match="state.orbax is an orbax checkpoint"):
        tck.load_state(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError):
        tck.load_state(str(tmp_path / "nothing"))


def test_port_save_removes_a_stale_orbax_state(tmp_path):
    (tmp_path / "ck" / "state.orbax").mkdir(parents=True)
    tck.save_state(str(tmp_path / "ck"), {"a": np.ones(3)})
    assert not (tmp_path / "ck" / "state.orbax").exists()
    got, _ = jck.load_state(str(tmp_path / "ck"))
    np.testing.assert_array_equal(got["a"], np.ones(3))


def test_jax_map_checkpoint_is_refused(tmp_path, small_splits, no_orbax):
    train, val, _ = _splits(small_splits)
    jck_dir, tck_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    base = dict(n_factors=4, epochs=2, batch_size=256, verbose=False)
    jmap.HPFMap(jmap.HPFMapConfig(**base)).fit(train, val, checkpoint_dir=jck_dir,
                                               checkpoint_every=2)
    tmap.HPFMap(tmap.HPFMapConfig(**base)).fit(train, val, device="cpu",
                                               checkpoint_dir=tck_dir,
                                               checkpoint_every=2)
    # Same leaves in the same order, shapes and dtypes; only the RNG differs.
    jflat, _ = jck.load_state(jck_dir)
    tflat, _ = tck.load_state(tck_dir)
    assert set(jflat) - {"rng_key_data"} == set(tflat) - {tmap.GEN_KEY}
    for k in tflat:
        if k != tmap.GEN_KEY:
            assert (tflat[k].shape, tflat[k].dtype) == (jflat[k].shape, jflat[k].dtype), k
    assert int(tflat["leaf_2"]) == int(jflat["leaf_2"])  # Adam's step count
    with pytest.raises(ValueError, match="JAX package HPFMap checkpoint"):
        tmap.HPFMap(tmap.HPFMapConfig(**base)).fit(train, val, device="cpu",
                                                   resume_from=jck_dir)
