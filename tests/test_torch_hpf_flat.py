"""Port flat HPF-CAVI against the JAX package: the initial state bit for
bit, three flat sweeps in float64 at 1e-10, the segment primitives and
the fit loop's validation metrics."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.coo import build_eval_set as j_build_eval_set
from pmf_tpu.data.coo import build_ratings as j_build_ratings
from pmf_tpu.eval import metrics as jmetrics
from pmf_tpu.models import hpf as jhpf
from pmf_tpu.ops import segment as jseg
from pmf_tpu_torch.data.coo import build_eval_set as t_build_eval_set
from pmf_tpu_torch.data.coo import build_ratings as t_build_ratings
from pmf_tpu_torch.eval import metrics as tmetrics
from pmf_tpu_torch.models import hpf as thpf
from pmf_tpu_torch.ops import segment as tseg

torch.set_num_threads(1)


def _cfgs(dtype, K=6):
    return (jhpf.HPFConfig(n_factors=K, dtype=dtype, verbose=False),
            thpf.HPFConfig(n_factors=K, dtype=dtype, verbose=False))


def _hyper(cfg):
    return (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_state_matches_jax_bitwise(dtype):
    jcfg, tcfg = _cfgs(dtype)
    js = jhpf.init_state(120, 80, jcfg)
    ts = thpf.init_state(120, 80, tcfg, device="cpu")
    assert set(js) == set(ts)
    for k in js:
        ref = np.asarray(js[k])
        got = ts[k].numpy()
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)


def test_flat_sweep_matches_jax_float64(small_ratings):
    u, i, x = small_ratings
    x = x + 1.0
    jcfg, tcfg = _cfgs("float64")
    jd = j_build_ratings(u, i, x, dtype=np.float64)
    td = t_build_ratings(u, i, x, dtype=np.float64, device="cpu")
    js = jhpf.init_state(jd.n_users, jd.n_items, jcfg)
    ts = thpf.init_state(td.n_users, td.n_items, tcfg, device="cpu")
    for _ in range(3):
        js = jhpf.sweep(js, jd, *_hyper(jcfg))
        ts = thpf.sweep(ts, td, *_hyper(tcfg))
    for k in js:
        assert ts[k].dtype == torch.float64, k
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-10,
                                   err_msg=k)


def test_segment_primitives_match_jax():
    rng = np.random.default_rng(4)
    data = rng.standard_normal((50, 3))
    ids = np.sort(rng.integers(0, 9, size=50)).astype(np.int32)
    ids[-5:] = 7  # sentinel: out of range for 7 segments, dropped
    got = tseg.sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 7)
    ref = jseg.sorted_segment_sum(jnp.asarray(data), jnp.asarray(ids), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    table = rng.standard_normal((6, 3))
    gids = np.array([0, 5, 6, 9, 2], np.int32)  # 6 and 9 clip to row 5
    np.testing.assert_array_equal(
        tseg.gather_rows(torch.from_numpy(table), torch.from_numpy(gids)).numpy(),
        np.asarray(jseg.gather_rows(jnp.asarray(table), jnp.asarray(gids))))


def test_eval_metrics_match_jax(small_splits):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    tx, vx = tx + 1.0, vx + 1.0
    jcfg, tcfg = _cfgs("float64")
    n_users, n_items = int(tu.max()) + 1, int(ti.max()) + 1
    js = jhpf.init_state(n_users, n_items, jcfg)
    ts = thpf.init_state(n_users, n_items, tcfg, device="cpu")
    jev = j_build_eval_set(vu, vi, vx, n_users, n_items, dtype=np.float64)
    tev = t_build_eval_set(vu, vi, vx, n_users, n_items, dtype=np.float64, device="cpu")
    for got, ref in zip(thpf.eval_metrics(ts, tev), jhpf.eval_metrics(js, jev)):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)


def test_host_metrics_match_jax():
    rng = np.random.default_rng(1)
    y = rng.integers(1, 6, size=200).astype(np.float64)
    p = y + rng.standard_normal(200)
    assert tmetrics.rmse(y, p) == pytest.approx(jmetrics.rmse(y, p), rel=1e-12)
    assert tmetrics.macro_mae(y, p) == pytest.approx(jmetrics.macro_mae(y, p),
                                                     rel=1e-12)
