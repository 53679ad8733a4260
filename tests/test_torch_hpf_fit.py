"""The port's slice as a whole against the JAX package: blocked sweeps over
the hybrid layout (tail + dense head) and the full ``HPF.fit`` with its
validation history and early stop, run on the CPU through the kernels'
plain versions."""

import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.models import hpf as jhpf
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.data.coo import build_ratings as t_build_ratings
from pmf_tpu_torch.models import hpf as thpf
from pmf_tpu_torch.models.base import resolve_engine

torch.set_num_threads(1)


def _hyper(cfg):
    return (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)


@pytest.mark.parametrize("head", [(16, 24), [(0, 8, 40), (8, 24, 12)]],
                         ids=["one_tier", "staircase"])
def test_sweep_blocked_matches_jax(small_ratings, head):
    u, i, x = small_ratings
    x = x + 1.0
    jcfg = jhpf.HPFConfig(n_factors=6, verbose=False)
    tcfg = thpf.HPFConfig(n_factors=6, verbose=False)
    jflat = j_build_ratings(u, i, x, n_users=120, n_items=80)
    tflat = t_build_ratings(u, i, x, n_users=120, n_items=80, device="cpu")
    jb = j_build_blocked(u, i, x, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=head, head_r0=4)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True,
                         head=head, head_r0=4, device="cpu")
    js_blk = jhpf.init_state(120, 80, jcfg)
    js_flat = dict(js_blk)
    ts = thpf.init_state(120, 80, tcfg, device="cpu")
    for _ in range(3):
        js_blk = jhpf.sweep_blocked(js_blk, jb, jflat.user_counts,
                                    jflat.item_counts, *_hyper(jcfg),
                                    precision="high", interpret=True)
        js_flat = jhpf.sweep(js_flat, jflat, *_hyper(jcfg))
        ts = thpf.sweep_blocked(ts, tb, tflat.user_counts, tflat.item_counts,
                                *_hyper(tcfg))
    for k in ts:
        for ref in (js_blk[k], js_flat[k]):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(ref),
                                       rtol=5e-4, atol=1e-5, err_msg=k)


def _splits(small_splits):
    (tu, ti, tx), (vu, vi, vx), (su, si, sx) = small_splits
    return (tu, ti, tx + 1.0), (vu, vi, vx + 1.0), (su, si, sx + 1.0)


@pytest.mark.parametrize("engine", ["blocked_high", "flat"])
def test_fit_history_matches_jax(small_splits, engine):
    train, val, test = _splits(small_splits)
    kw = dict(n_factors=8, max_iter=40, verbose=False, engine=engine)
    jm = jhpf.HPF(jhpf.HPFConfig(**kw)).fit(train, val)
    tm = thpf.HPF(thpf.HPFConfig(**kw)).fit(train, val, device="cpu")
    assert tm.engine_used == engine
    # Same stop iteration (the Poisson rule stops on improvement < tol).
    assert len(tm.fit_history) == len(jm.fit_history) < 40
    for t_rec, j_rec in zip(tm.fit_history, jm.fit_history):
        assert t_rec["iteration"] == j_rec["iteration"]
        assert abs(t_rec["val_rmse"] - j_rec["val_rmse"]) < 1e-4
        assert abs(t_rec["val_macro_mae"] - j_rec["val_macro_mae"]) < 1e-4
        assert t_rec["updates_per_sec"] > 0
    np.testing.assert_allclose(tm.predict(test[0], test[1]),
                               jm.predict(test[0], test[1]), rtol=5e-4, atol=1e-5)
    assert tm.evaluate_rmse(test) == pytest.approx(jm.evaluate_rmse(test), abs=1e-4)
    assert tm.evaluate_macro_mae(test) == pytest.approx(
        jm.evaluate_macro_mae(test), abs=1e-4)


def test_fit_without_val_runs_max_iter(small_splits):
    train, _, _ = _splits(small_splits)
    m = thpf.HPF(thpf.HPFConfig(n_factors=4, max_iter=3, verbose=False,
                                engine="blocked_high")).fit(train, device="cpu")
    assert [r["iteration"] for r in m.fit_history] == [1, 2, 3]
    assert m.n_sweeps == 3
    assert all(np.all(np.isfinite(v)) for v in thpf.state_to_numpy(m.state).values())


def test_predict_out_of_range_is_zero(small_splits):
    train, _, _ = _splits(small_splits)
    m = thpf.HPF(thpf.HPFConfig(n_factors=4, max_iter=2, verbose=False,
                                engine="flat")).fit(train, device="cpu")
    pred = m.predict([0, 10_000, -1], [0, 0, 3])
    assert pred[0] > 0 and pred[1] == 0 and pred[2] == 0


def test_resolve_engine_keeps_the_jax_cutover():
    assert resolve_engine("auto", 299_999) == "flat"
    assert resolve_engine("auto", 300_000) == "blocked_high"
    assert resolve_engine("flat", 10**8) == "flat"


def test_resolve_engine_on_the_cpu_is_flat():
    """Fault F3: the JAX package runs "flat" whenever its backend is the
    CPU; the port resolves "auto" by the fit's device the same way."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_engine("auto", 300_000, cpu) == "flat"
    assert resolve_engine("auto", 10**8, "cpu") == "flat"
    assert resolve_engine("auto", 300_000, cuda) == "blocked_high"
    assert resolve_engine("auto", 299_999, cuda) == "flat"
    assert resolve_engine("blocked_high", 10, cpu) == "blocked_high"


@pytest.mark.parametrize("family", ["hpf", "poisson", "extended", "gaussian"])
def test_auto_fit_on_the_cpu_runs_flat_above_the_cutover(family):
    """300k distinct edges (1000 users x 300 items), one sweep, K=2."""
    from pmf_tpu_torch.models import gaussian_mf as tgmf
    from pmf_tpu_torch.models import poisson_mf as tpmf

    k = np.arange(300_000)
    u, i, x = k % 1000, k // 1000, 1.0 + (k % 5)
    kw = dict(n_factors=2, max_iter=1, tol=None, verbose=False, engine="auto")
    model = {"hpf": lambda: thpf.HPF(thpf.HPFConfig(**kw)),
             "poisson": lambda: tpmf.PoissonMF(tpmf.PoissonMFConfig(**kw)),
             "extended": lambda: tpmf.PoissonMF(tpmf.PoissonMFConfig(extended=True,
                                                                      **kw)),
             "gaussian": lambda: tgmf.GaussianMF(tgmf.GaussianMFConfig(**kw))}[family]()
    model.fit((u, i, x), device="cpu")
    assert model.engine_used == "flat"
    assert not hasattr(model, "blocked")


def test_state_numpy_round_trip():
    cfg = jhpf.HPFConfig(n_factors=5, verbose=False)
    js = {k: np.asarray(v) for k, v in jhpf.init_state(30, 20, cfg).items()}
    ts = thpf.state_from_numpy(js, device="cpu")
    assert all(ts[k].dtype == torch.float32 for k in ts)
    back = thpf.state_to_numpy(ts)
    for k in js:
        np.testing.assert_array_equal(back[k], js[k])
    t64 = thpf.state_from_numpy(js, device="cpu", dtype=torch.float64)
    assert all(t64[k].dtype == torch.float64 for k in t64)
    np.testing.assert_array_equal(thpf.state_to_numpy(t64)["a_theta"],
                                  js["a_theta"].astype(np.float64))


def test_scalar_reader_and_mark_on_cpu():
    from pmf_tpu_torch.utils.device import ScalarReader, mark

    reader = ScalarReader()
    for vals in ((1.5, 2.25), (0.5, 4.0)):
        read = reader.start(*(torch.tensor(v, dtype=torch.float64) for v in vals))
        assert read() == list(vals)
    assert mark(torch.zeros(3))() is None
