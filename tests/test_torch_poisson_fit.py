"""The Poisson-MF slice as a whole against the JAX package: blocked sweeps
over the hybrid layout (tail + dense head), plain and extended, and the
full ``PoissonMF.fit`` with its validation history and early stop, run on
the CPU through the kernels' plain versions."""

import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.models import poisson_mf as jpmf
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.data.coo import build_ratings as t_build_ratings
from pmf_tpu_torch.models import poisson_mf as tpmf

torch.set_num_threads(1)

VARIANTS = pytest.mark.parametrize("extended", [False, True],
                                   ids=["plain", "extended"])


@VARIANTS
@pytest.mark.parametrize("head", [None, (16, 24), [(0, 8, 40), (8, 24, 12)]],
                         ids=["tail_only", "one_tier", "staircase"])
def test_sweep_blocked_matches_jax(small_ratings, head, extended):
    u, i, x = small_ratings
    x = x + 1.0  # integer ratings: the head planes hold X exactly
    kw = dict(n_factors=6, verbose=False, extended=extended)
    jcfg, tcfg = jpmf.PoissonMFConfig(**kw), tpmf.PoissonMFConfig(**kw)
    a0, b0 = jcfg.a0, jcfg.b0
    jflat = j_build_ratings(u, i, x, n_users=120, n_items=80)
    tflat = t_build_ratings(u, i, x, n_users=120, n_items=80, device="cpu")
    jb = j_build_blocked(u, i, x, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=head, head_r0=4)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True,
                         head=head, head_r0=4, device="cpu")
    sx = [np.bincount(ids, weights=x, minlength=n).astype(np.float32)
          for ids, n in ((u, 120), (i, 80))]
    js_blk = jpmf.init_state(120, 80, jcfg)
    js_flat = dict(js_blk)
    ts = tpmf.init_state(120, 80, tcfg, device="cpu")
    for _ in range(3):
        js_flat = jpmf.sweep(js_flat, jflat, a0, b0, extended)
        if extended:
            js_blk = jpmf.sweep_blocked_extended(
                js_blk, jb, jflat.user_counts, jflat.item_counts, sx[0], sx[1],
                a0, b0, precision="high", interpret=True)
            ts = tpmf.sweep_blocked_extended(
                ts, tb, tflat.user_counts, tflat.item_counts,
                torch.from_numpy(sx[0]), torch.from_numpy(sx[1]), a0, b0)
        else:
            js_blk = jpmf.sweep_blocked(js_blk, jb, jflat.user_counts,
                                        jflat.item_counts, a0, b0,
                                        precision="high", interpret=True)
            ts = tpmf.sweep_blocked(ts, tb, tflat.user_counts, tflat.item_counts,
                                    a0, b0)
    assert set(ts) == set(js_flat) and len(ts) == (8 if extended else 4)
    for k in ts:
        for ref in (js_blk[k], js_flat[k]):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(ref),
                                       rtol=5e-4, atol=1e-5, err_msg=k)


@VARIANTS
@pytest.mark.parametrize("engine", ["blocked_high", "flat"])
def test_fit_history_matches_jax(small_splits, engine, extended):
    train, val, test = small_splits
    kw = dict(n_factors=8, max_iter=40, verbose=False, engine=engine,
              extended=extended)
    jm = jpmf.PoissonMF(jpmf.PoissonMFConfig(**kw)).fit(train, val)
    tm = tpmf.PoissonMF(tpmf.PoissonMFConfig(**kw)).fit(train, val, device="cpu")
    assert tm.engine_used == engine
    # Same stop iteration (the Poisson rule stops on improvement < tol).
    assert len(tm.fit_history) == len(jm.fit_history) < 40
    for t_rec, j_rec in zip(tm.fit_history, jm.fit_history):
        assert t_rec["iteration"] == j_rec["iteration"]
        assert abs(t_rec["val_rmse"] - j_rec["val_rmse"]) < 1e-4
        assert abs(t_rec["val_macro_mae"] - j_rec["val_macro_mae"]) < 1e-4
        assert t_rec["updates_per_sec"] > 0
        assert "elbo" not in t_rec
    np.testing.assert_allclose(tm.predict(test[0], test[1]),
                               jm.predict(test[0], test[1]), rtol=5e-4, atol=1e-5)
    assert tm.evaluate_rmse(test) == pytest.approx(jm.evaluate_rmse(test), abs=1e-4)
    assert tm.evaluate_macro_mae(test) == pytest.approx(
        jm.evaluate_macro_mae(test), abs=1e-4)


@VARIANTS
def test_fit_without_val_runs_max_iter(small_splits, extended):
    train, _, _ = small_splits
    m = tpmf.PoissonMF(tpmf.PoissonMFConfig(
        n_factors=4, max_iter=3, verbose=False, engine="blocked_high",
        extended=extended)).fit(train, device="cpu")
    assert [r["iteration"] for r in m.fit_history] == [1, 2, 3]
    assert m.n_sweeps == 3
    n_users, n_items = int(train[0].max()) + 1, int(train[1].max()) + 1
    state = tpmf.state_to_numpy(m.state)
    shapes = {"a_theta": (n_users, 4), "b_theta": (n_users, 4),
              "a_beta": (n_items, 4), "b_beta": (n_items, 4)}
    if extended:
        shapes.update(a_phi=(n_users,), b_phi=(n_users,), a_psi=(n_items,),
                      b_psi=(n_items,))
    assert {k: v.shape for k, v in state.items()} == shapes
    assert all(np.all(np.isfinite(v)) for v in state.values())
    rate = 4 if extended else 2
    rec = m.fit_history[-1]
    assert rec["updates_per_sec"] * rec["iter_seconds"] == pytest.approx(
        rate * len(train[0]))


@VARIANTS
def test_predict_out_of_range_is_zero(small_splits, extended):
    train, _, _ = small_splits
    m = tpmf.PoissonMF(tpmf.PoissonMFConfig(
        n_factors=4, max_iter=2, verbose=False, engine="flat",
        extended=extended)).fit(train, device="cpu")
    pred = m.predict([0, 10_000, -1, 0], [0, 0, 3, 10_000])
    assert pred[0] > 0 and np.all(pred[1:] == 0)
    assert pred.dtype == np.float64


def test_engine_auto_and_unknown(small_splits):
    train, _, _ = small_splits
    m = tpmf.PoissonMF(tpmf.PoissonMFConfig(n_factors=3, max_iter=1,
                                            verbose=False)).fit(train, device="cpu")
    assert m.engine_used == "flat"  # below the 300k-edge cutover
    # As in the JAX package: "blocked_fast" runs the blocked engine, and a
    # name that does not start with "blocked" runs flat.
    m = tpmf.PoissonMF(tpmf.PoissonMFConfig(
        n_factors=3, max_iter=1, verbose=False,
        engine="blocked_fast")).fit(train, device="cpu")
    assert m.engine_used == "blocked_fast" and m.blocked is not None
    flat = tpmf.PoissonMF(tpmf.PoissonMFConfig(n_factors=3, max_iter=1, verbose=False,
                                               engine="flat")).fit(train, device="cpu")
    other = tpmf.PoissonMF(tpmf.PoissonMFConfig(
        n_factors=3, max_iter=1, verbose=False,
        engine="unknown")).fit(train, device="cpu")
    assert other.engine_used == "unknown" and not hasattr(other, "blocked")
    for k in flat.state:
        torch.testing.assert_close(other.state[k], flat.state[k], rtol=0, atol=0)


def test_package_exports_the_model():
    import pmf_tpu_torch

    assert pmf_tpu_torch.PoissonMF is tpmf.PoissonMF
    assert pmf_tpu_torch.PoissonMFConfig is tpmf.PoissonMFConfig
    jf = {f.name: f.default for f in jpmf.PoissonMFConfig.__dataclass_fields__.values()}
    tf = {f.name: f.default for f in tpmf.PoissonMFConfig.__dataclass_fields__.values()}
    assert jf == tf  # same fields, same defaults
