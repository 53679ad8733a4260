"""The other single-device engines of the port against the JAX package:
"blocked_fast" and "blocked_mid" for the three CAVI families and HPF-MAP,
HPF's "flat_chunked", and the head arithmetic at precision "fast" (K2's
one-term instance and the one-plane head products) against a numpy
emulation of the reference's ``Precision.DEFAULT``.

The JAX package cannot show that rounding on the CPU, where XLA's DEFAULT
precision is full float32, so the port's fast statistics are held to the
emulation and its fast fits to the JAX flat fit at the reference's own
criterion (``tests/test_engines.py::test_fast_engine_converges_like_flat``:
final val RMSE within 5e-3).  The default head sizing builds no head at
this size (``_pick_tiers`` wants 4M edges), so the fast fits run
``sweep_blocked`` over an explicit head tier, where K2 and the head
products do the work."""

import numpy as np
import pytest
import torch

from pmf_tpu.models import gaussian_mf as jgm
from pmf_tpu.models import hpf as jhpf
from pmf_tpu.models import poisson_mf as jpmf
from pmf_tpu_torch.cli import run_single as trun
from pmf_tpu_torch.data import layout_cache
from pmf_tpu_torch.data.blocked import DenseHead
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.data.coo import build_eval_set, build_ratings
from pmf_tpu_torch.models import gaussian_mf as tgm
from pmf_tpu_torch.models import hpf as thpf
from pmf_tpu_torch.models import hpf_map as tmap
from pmf_tpu_torch.models import poisson_mf as tpmf
from pmf_tpu_torch.models.base import BLOCKED_PRECISION, blocked_precision
from pmf_tpu_torch.ops import dense_head

torch.set_num_threads(1)

SWEEPS = 10
HEAD = [(0, 48, 60)]  # one tier: the 48 busiest users x the 60 busiest items
HEAD_R0 = 16


@pytest.fixture(autouse=True)
def _layout_cache_in_tmp(monkeypatch, tmp_path):
    """A CLI's ``main`` turns the layout cache on where the environment
    names no directory: keep it in this test's own directory, so no layout
    outlives the test."""
    monkeypatch.setenv(layout_cache.ENV_VAR, str(tmp_path / "layouts"))


def _rn_bf16(a) -> np.ndarray:
    """float32 values rounded to nearest-even bf16, as float64 (numpy bit
    arithmetic, independent of torch's conversion)."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().astype(np.float64)


def _cells(rows, hip, hi, m_f32, with_lo, seed):
    rng = np.random.default_rng(seed)
    m = np.floor(4 * rng.random((rows, hip)) ** 3)
    if m_f32:
        m = np.where(rng.random((rows, hip)) < 0.05, np.floor(300 + 900 * rng.random((rows, hip))), m)
    m[:, hi:] = 0
    per = np.floor(1 + 5 * rng.random((rows, hip)))
    if with_lo:
        per = per + 0.37 * rng.random((rows, hip))
    x = torch.from_numpy((m * per).astype(np.float32))
    x_hi = x.to(torch.bfloat16)
    x_lo = (x - x_hi.float()).to(torch.bfloat16) if with_lo else None
    mt = torch.from_numpy(m.astype(np.float32))
    return x_hi, x_lo, (mt if m_f32 else mt.to(torch.bfloat16))


def _tables(rows, hip, hi, K, seed):
    rng = np.random.default_rng(seed + 1)
    theta = (0.02 + rng.random((rows, K))).astype(np.float32)
    theta[::5] *= 1e-3  # rates under the floor
    beta = (0.02 + rng.random((hip, K))).astype(np.float32)
    beta[hi:] = 0
    return torch.from_numpy(theta), torch.from_numpy(beta)


@pytest.mark.parametrize("item_side", [False, True], ids=["user", "item"])
@pytest.mark.parametrize("kind", ["integer", "fractional", "m_f32"])
@pytest.mark.parametrize("K", [3, 20])
def test_k2_fast_plain_matches_default_precision_emulation(item_side, kind, K):
    """K2's plain version at "fast": theta, beta, W and M rounded to nearest
    bf16, X = x_hi + x_lo, float64 sums in the emulation (float32 in the
    plain version: 1e-5 relative)."""
    rows, hip, hi, floor = 40, 512, 300, 0.05
    x_hi, x_lo, m = _cells(rows, hip, hi, kind == "m_f32", kind != "integer", seed=K)
    theta, beta = _tables(rows, hip, hi, K, seed=K)
    got = dense_head.fused_alloc_tier(theta, beta, x_hi, m, x_lo, rate_floor=floor,
                                      item_side=item_side, precision="fast")
    th, bt = _rn_bf16(theta.numpy()), _rn_bf16(beta.numpy())
    x = _bf16_bits(x_hi) + (_bf16_bits(x_lo) if x_lo is not None else 0.0)
    mm = m.float().numpy().astype(np.float64)
    R = th @ bt.T
    W = np.where(mm > 0, x / np.maximum(R, floor), 0.0)
    W, mr = _rn_bf16(W), _rn_bf16(mm)
    ref = (np.concatenate([W.T @ th, mr.T @ th], 1) if item_side
           else np.concatenate([W @ bt, mr @ bt], 1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert kind != "m_f32" or not np.array_equal(mr, mm)  # M > 256 was rounded
    high = dense_head.fused_alloc_tier(theta, beta, x_hi, m, x_lo, rate_floor=floor,
                                       item_side=item_side)
    assert not torch.equal(got, high)  # the rounding shows


@pytest.mark.parametrize("transpose", [False, True], ids=["user", "item"])
@pytest.mark.parametrize("m_f32", [False, True], ids=["m_bf16", "m_f32"])
def test_fast_head_products_drop_x_lo_and_round_m(transpose, m_f32):
    """``head_products{,_t}`` at "fast": M rounded to bf16, X its x_hi
    plane alone (x_lo dropped, as the reference's ``parts > 1`` test does),
    the table rounded to nearest bf16; at "high", the exact planes."""
    rows, hip, hi = 32, 512, 200
    x_hi, x_lo, m = _cells(rows, hip, hi, m_f32, True, seed=3)
    head = DenseHead(x_hi=x_hi, x_lo=x_lo, m=m, x_sum_user=torch.zeros(rows),
                     x_sum_item=torch.zeros(hip), hu=rows, hi=hi, r0=rows)
    rng = np.random.default_rng(4)
    n_tab = rows if transpose else hip
    tab = torch.from_numpy(rng.standard_normal((n_tab, 7)).astype(np.float32))
    xtab = torch.from_numpy(rng.standard_normal((n_tab, 5)).astype(np.float32))
    fn = dense_head.head_products_t if transpose else dense_head.head_products
    mp, xp = fn(head, tab, xtab, "fast")
    mr, xr = _rn_bf16(m.float().numpy()), _bf16_bits(x_hi)
    if transpose:
        mr, xr = mr.T, xr.T
    np.testing.assert_allclose(mp.numpy(), mr @ _rn_bf16(tab.numpy()), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xp.numpy(), xr @ _rn_bf16(xtab.numpy()), rtol=1e-5, atol=1e-5)
    mp2, xp2 = fn(head, tab, xtab, "high")
    x_full = xr + (_bf16_bits(x_lo).T if transpose else _bf16_bits(x_lo))
    m_full = m.float().numpy().astype(np.float64)
    np.testing.assert_allclose(xp2.numpy(), x_full @ xtab.numpy().astype(np.float64),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        mp2.numpy(), (m_full.T if transpose else m_full) @ tab.numpy().astype(np.float64),
        rtol=1e-4, atol=1e-4)


def test_precision_names():
    """The engines' head precision: "blocked_mid" runs "high" (the
    reference's mid differs only in its TPU tail gathers), and the ops
    take "fast" and "high" alone."""
    assert BLOCKED_PRECISION == {"blocked_fast": "fast", "blocked_mid": "high",
                                 "blocked_high": "high"}
    assert [blocked_precision(e) for e in ("blocked_fast", "blocked_mid", "blocked_high",
                                           "blocked_other", "flat", "flat_chunked",
                                           "other")] == ["fast", "high", "high", "high",
                                                         None, None, None]
    assert [dense_head.is_fast(p) for p in ("fast", "high")] == [True, False]
    for bad in ("mid", "highest"):
        with pytest.raises(ValueError, match="unknown precision"):
            dense_head.is_fast(bad)


# ------------------------------------------------------------ fits --

def _data(train, val, dtype=np.float32):
    data = build_ratings(*train, dtype=dtype, device="cpu")
    ev = build_eval_set(*val, data.n_users, data.n_items, dtype=dtype, device="cpu")
    blocked = t_build_blocked(*train, n_users=data.n_users, n_items=data.n_items,
                              dtype=dtype, reorder=True, head=HEAD, head_r0=HEAD_R0,
                              device="cpu")
    assert blocked.head and int(blocked.head[0].m.float().sum()) > 0.3 * data.nnz
    return data, ev, blocked


def _poisson_splits(small_splits, shift):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    return (tu, ti, tx + shift), (vu, vi, vx + shift)


def _hpf_run(small_splits, precision):
    train, val = _poisson_splits(small_splits, 1.0)
    data, ev, blocked = _data(train, val)
    cfg = thpf.HPFConfig(n_factors=6, verbose=False)
    hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    s = thpf.init_state(data.n_users, data.n_items, cfg, device="cpu")
    for _ in range(SWEEPS):
        s = thpf.sweep_blocked(s, blocked, data.user_counts, data.item_counts, *hyper,
                               precision=precision)
    return s, float(thpf.eval_metrics(s, ev)[0])


def _poisson_run(small_splits, precision, extended):
    train, val = _poisson_splits(small_splits, 0.0)
    data, ev, blocked = _data(train, val)
    cfg = tpmf.PoissonMFConfig(n_factors=6, a0=0.6, b0=1.1, verbose=False,
                               extended=extended)
    s = tpmf.init_state(data.n_users, data.n_items, cfg, device="cpu")
    sx = [torch.from_numpy(np.bincount(ids, weights=train[2], minlength=n)
                           .astype(np.float32)) for ids, n in
          ((train[0], data.n_users), (train[1], data.n_items))]
    for _ in range(SWEEPS):
        if extended:
            s = tpmf.sweep_blocked_extended(s, blocked, data.user_counts, data.item_counts,
                                            *sx, cfg.a0, cfg.b0, precision=precision)
        else:
            s = tpmf.sweep_blocked(s, blocked, data.user_counts, data.item_counts,
                                   cfg.a0, cfg.b0, precision=precision)
    return s, float(tpmf.eval_metrics(s, ev, extended)[0])


GAUSS = dict(n_factors=5, sigma2=0.5, eta_theta2=0.4, eta_beta2=0.4, eta_bias2=0.7,
             use_bias=True, dtype="float32")


def _gauss_splits(small_splits):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    mean = tx.mean()
    return (tu, ti, tx - mean), (vu, vi, vx - mean)


def _gauss_run(small_splits, precision):
    train, val = _gauss_splits(small_splits)
    data, ev, blocked = _data(train, val)
    cfg = tgm.GaussianMFConfig(verbose=False, **GAUSS)
    s = tgm.init_state(data.n_users, data.n_items, cfg, device="cpu")
    hyper = (cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2, cfg.eta_bias2, cfg.use_bias)
    for _ in range(SWEEPS):
        s = tgm.sweep_blocked(s, blocked, data.user_counts, data.item_counts, *hyper,
                              precision=precision)
    return s, float(tgm.eval_metrics(s, ev, cfg.use_bias)[0])


def _jax_flat_rmse(family, small_splits):
    base = dict(max_iter=SWEEPS, tol=None, verbose=False, engine="flat")
    if family == "hpf":
        train, val = _poisson_splits(small_splits, 1.0)
        m = jhpf.HPF(jhpf.HPFConfig(n_factors=6, dtype="float32", **base)).fit(train, val)
    elif family == "gaussian":
        train, val = _gauss_splits(small_splits)
        m = jgm.GaussianMF(jgm.GaussianMFConfig(**GAUSS, **base)).fit(train, val)
    else:
        train, val = _poisson_splits(small_splits, 0.0)
        m = jpmf.PoissonMF(jpmf.PoissonMFConfig(
            n_factors=6, a0=0.6, b0=1.1, dtype="float32", extended=family == "extended",
            **base)).fit(train, val)
    return m.fit_history[-1]["val_rmse"]


RUNS = {"hpf": _hpf_run, "gaussian": _gauss_run,
        "poisson": lambda sp, p: _poisson_run(sp, p, False),
        "extended": lambda sp, p: _poisson_run(sp, p, True)}


@pytest.mark.parametrize("family", sorted(RUNS))
def test_fast_engine_converges_like_jax_flat(small_splits, family):
    """blocked_fast over a head tier: the final val RMSE within 5e-3 of the
    JAX flat fit's after 10 sweeps, and the fast statistics differ from
    the high ones (the head ran at one term)."""
    fast, r_fast = RUNS[family](small_splits, "fast")
    high, _ = RUNS[family](small_splits, "high")
    assert np.isfinite(r_fast)
    assert abs(r_fast - _jax_flat_rmse(family, small_splits)) < 5e-3
    assert any(not torch.equal(fast[k], high[k]) for k in fast)


@pytest.mark.parametrize("family", sorted(RUNS))
def test_mid_equals_high_in_bits(small_splits, family):
    mid, _ = RUNS[family](small_splits, blocked_precision("blocked_mid"))
    high, _ = RUNS[family](small_splits, blocked_precision("blocked_high"))
    for k in high:
        assert torch.equal(mid[k], high[k]), k


def test_gaussian_mid_fit_matches_jax_mid(small_splits):
    """``GaussianMF(engine="blocked_mid")`` against the JAX package's, at
    ``tests/test_gaussian_lagged.py``'s mid-tier tolerances."""
    train, val = _gauss_splits(small_splits)
    base = dict(max_iter=3, tol=None, verbose=False, engine="blocked_mid", **GAUSS)
    jm = jgm.GaussianMF(jgm.GaussianMFConfig(**base)).fit(train, val)
    tm = tgm.GaussianMF(tgm.GaussianMFConfig(**base)).fit(train, val, device="cpu")
    assert tm.engine_used == "blocked_mid"
    for k in ("m_theta", "m_beta", "b_user", "b_item"):
        np.testing.assert_allclose(tm.state[k].numpy(), np.asarray(jm.state[k]),
                                   rtol=3e-2, atol=3e-3, err_msg=k)
    assert abs(tm.fit_history[-1]["val_rmse"] - jm.fit_history[-1]["val_rmse"]) < 5e-3


@pytest.mark.parametrize("family", ["hpf", "poisson", "extended"])
def test_poisson_family_mid_fit_matches_jax_mid(small_splits, family):
    """The Poisson family's ``blocked_mid`` fits against the JAX package's,
    at ``tests/test_engines.py``'s tolerances."""
    base = dict(n_factors=6, max_iter=4, tol=None, verbose=False, dtype="float32",
                engine="blocked_mid")
    if family == "hpf":
        train, val = _poisson_splits(small_splits, 1.0)
        jm = jhpf.HPF(jhpf.HPFConfig(**base)).fit(train, val)
        tm = thpf.HPF(thpf.HPFConfig(**base)).fit(train, val, device="cpu")
    else:
        train, val = _poisson_splits(small_splits, 0.0)
        kw = dict(base, a0=0.6, b0=1.1, extended=family == "extended")
        jm = jpmf.PoissonMF(jpmf.PoissonMFConfig(**kw)).fit(train, val)
        tm = tpmf.PoissonMF(tpmf.PoissonMFConfig(**kw)).fit(train, val, device="cpu")
    assert tm.engine_used == "blocked_mid"
    for k in tm.state:
        np.testing.assert_allclose(tm.state[k].numpy(), np.asarray(jm.state[k]),
                                   rtol=5e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose([h["val_rmse"] for h in tm.fit_history],
                               [h["val_rmse"] for h in jm.fit_history], rtol=1e-4)


# ------------------------------------------------------- flat_chunked --

@pytest.mark.parametrize("chunk_len", [97, 1024, 1 << 20])
def test_sweep_chunked_matches_flat_and_jax(small_splits, chunk_len):
    train, _ = _poisson_splits(small_splits, 1.0)
    import pmf_tpu.data.coo as jcoo

    cfg = thpf.HPFConfig(n_factors=6, dtype="float64")
    hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    data = build_ratings(*train, dtype=np.float64, device="cpu")
    jdata = jcoo.build_ratings(*train, dtype=np.float64)
    s0 = thpf._init_state_numpy(data.n_users, data.n_items, cfg)
    ts = tc = thpf.state_from_numpy(s0, device="cpu")
    js = dict(s0)
    for _ in range(3):
        ts = thpf.sweep(ts, data, *hyper)
        tc = thpf.sweep(tc, data, *hyper, chunk_len=chunk_len)
        js = jhpf.sweep_chunked(js, jdata, *hyper, chunk_len=chunk_len)
    for k in ts:
        np.testing.assert_allclose(tc[k].numpy(), ts[k].numpy(), rtol=1e-12, atol=0,
                                   err_msg=k)
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(js[k]), rtol=1e-12, atol=0,
                                   err_msg=k)


def test_hpf_flat_chunked_fit_matches_flat(small_splits):
    train, val = _poisson_splits(small_splits, 1.0)
    base = dict(n_factors=6, max_iter=4, tol=None, verbose=False, dtype="float64")
    flat = thpf.HPF(thpf.HPFConfig(engine="flat", **base)).fit(train, val, device="cpu")
    chunked = thpf.HPF(thpf.HPFConfig(engine="flat_chunked", **base)).fit(
        train, val, device="cpu")
    jm = jhpf.HPF(jhpf.HPFConfig(engine="flat_chunked", **base)).fit(train, val)
    assert chunked.engine_used == "flat_chunked"
    for k in flat.state:
        np.testing.assert_allclose(chunked.state[k].numpy(), flat.state[k].numpy(),
                                   rtol=1e-12, atol=0, err_msg=k)
        np.testing.assert_allclose(chunked.state[k].numpy(), np.asarray(jm.state[k]),
                                   rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("family", ["poisson", "gaussian"])
def test_flat_chunked_runs_flat_outside_hpf(small_splits, family):
    """As in the JAX package, only HPF has "flat_chunked"; elsewhere any
    name that does not start with "blocked" runs flat."""
    if family == "poisson":
        train, val = _poisson_splits(small_splits, 0.0)
        mk = lambda e: tpmf.PoissonMF(tpmf.PoissonMFConfig(  # noqa: E731
            n_factors=4, max_iter=2, verbose=False, engine=e))
    else:
        train, val = _gauss_splits(small_splits)
        mk = lambda e: tgm.GaussianMF(tgm.GaussianMFConfig(  # noqa: E731
            n_factors=4, max_iter=2, verbose=False, engine=e))
    a = mk("flat_chunked").fit(train, val, device="cpu")
    b = mk("flat").fit(train, val, device="cpu")
    assert a.engine_used == "flat_chunked"
    for k in a.state:
        assert torch.equal(a.state[k], b.state[k]), k


# --------------------------------------------------------- HPF-MAP --

@pytest.mark.parametrize("engine", ["blocked_fast", "blocked_mid"])
def test_hpf_map_fast_and_mid_equal_high(small_splits, engine):
    train, val = _poisson_splits(small_splits, 1.0)
    base = dict(n_factors=5, lr=0.02, batch_size=512, epochs=2, verbose=False,
                random_state=3)
    got = tmap.HPFMap(tmap.HPFMapConfig(engine=engine, **base)).fit(train, val, device="cpu")
    ref = tmap.HPFMap(tmap.HPFMapConfig(engine="blocked_high", **base)).fit(
        train, val, device="cpu")
    assert got.engine_used == engine
    for k in ("user", "item"):
        assert torch.equal(got.state[k], ref.state[k]), k
    assert [h["val_rmse"] for h in got.fit_history] == [h["val_rmse"] for h in ref.fit_history]


# -------------------------------------------------------------- CLI --

CLI_ENGINES = ("flat", "flat_chunked", "blocked_high", "blocked_mid", "blocked_fast", "auto")


@pytest.mark.parametrize("engine", CLI_ENGINES)
def test_run_single_accepts_every_engine_name(engine):
    res = trun.main(["--model", "hpf_cavi", "--max_iter", "1", "--engine", engine,
                     "--n_factors", "3", "--synthetic", "4000", "--synthetic_users", "300",
                     "--synthetic_items", "120", "--device", "cpu"])
    assert res["_model"].engine_used == ("flat" if engine == "auto" else engine)
    assert np.isfinite(res["test_rmse"])


@pytest.mark.parametrize("K", [8, 20, 64, 128])
@pytest.mark.parametrize("item_side", [False, True], ids=["user", "item"])
def test_fast_stage_holds_no_q_lo_tile(K, item_side):
    """The one-term instance's ring stage is the three-term one's less the
    Q lo tile (32 rows of 16 bytes per 8 factors, padded by 16 where that
    count is even; past K = 32 one depth chunk of ``pass_width(K)``
    factors, beside P's and W's planes), so its launch plan fits at least
    as many CTAs."""
    blocks = dense_head.depth_blocks(K) if K <= 32 else dense_head.pass_width(K) // 8
    q_plane = dense_head.Q_TILE * (16 * blocks + (0 if blocks % 2 else 16))
    for m_f32 in (False, True):
        for has_lo in (False, True):
            high = dense_head.stage_bytes(item_side, m_f32, has_lo, K)
            fast = dense_head.stage_bytes(item_side, m_f32, has_lo, K, fast=True)
            assert high - fast == q_plane
            ph = dense_head.plan_launch(36864, 4096, K, item_side, m_f32, has_lo, 132)
            pf = dense_head.plan_launch(36864, 4096, K, item_side, m_f32, has_lo, 132,
                                        fast=True)
            if K <= 32:
                assert pf.smem_bytes == dense_head.STAGES * fast < ph.smem_bytes
            else:  # the ring as deep as the shared memory allows
                assert pf.smem_bytes == dense_head.pass_smem_bytes(
                    K, item_side, m_f32, has_lo, fast=True, stages=pf.stages)
                assert pf.stages >= ph.stages
                assert dense_head.pass_smem_bytes(
                    K, item_side, m_f32, has_lo, fast=True, stages=ph.stages) < ph.smem_bytes
            assert pf.ctas_per_sm >= ph.ctas_per_sm
