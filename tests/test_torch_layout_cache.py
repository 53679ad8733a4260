"""The port's layout cache (``data/layout_cache.py``): a hit gives the cold
build's layout, with and without head tiers; the key follows the data and
every geometry argument; a corrupt entry means a rebuild; the environment
variable is the port's own; and a cached layout fits identically."""

import os

import numpy as np
import pytest
import torch

from pmf_tpu_torch.data import blocked as tblocked
from pmf_tpu_torch.data import layout_cache as lc
from pmf_tpu_torch.models import hpf as thpf

torch.set_num_threads(1)

HEADS = {"no_head": dict(reorder=True, head=None),
         "one_tier": dict(reorder=True, head=(16, 24), head_r0=4),
         "staircase": dict(reorder=True, head=[(0, 8, 40), (8, 24, 12)], head_r0=4),
         "not_reordered": dict(reorder=False, head=None)}


@pytest.fixture(autouse=True)
def no_env(monkeypatch):
    monkeypatch.delenv(lc.ENV_VAR, raising=False)


@pytest.fixture
def spy(monkeypatch):
    """Counts of the host builds and of the head scatters."""
    calls = {"tail": 0, "scatter": 0}
    tail, scatter = tblocked._tail_host, tblocked._scatter_head

    def tail_spy(*a, **k):
        calls["tail"] += 1
        return tail(*a, **k)

    def scatter_spy(*a, **k):
        calls["scatter"] += 1
        return scatter(*a, **k)

    monkeypatch.setattr(tblocked, "_tail_host", tail_spy)
    monkeypatch.setattr(tblocked, "_scatter_head", scatter_spy)
    return calls


def _ratings(small_ratings):
    u, i, x = small_ratings
    return u, i, x + 1.0


def _build(small_ratings, cache_dir, **kw):
    u, i, x = _ratings(small_ratings)
    return tblocked.build_blocked(u, i, x, n_users=120, n_items=80, device="cpu",
                                  cache_dir=cache_dir, **kw)


def _assert_same_layout(a, b):
    for p, q in ((a.by_user, b.by_user), (a.by_item, b.by_item)):
        for f in ("row_ptr", "other", "x", "self_old_of_new", "other_old_of_new",
                  "self_new_of_old", "other_new_of_old"):
            x, y = getattr(p, f), getattr(q, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f
        for f in ("n_self", "n_other", "nnz", "reordered", "long_rows"):
            assert getattr(p, f) == getattr(q, f), f
    assert (a.head is None) == (b.head is None)
    for h, g in zip(a.head or (), b.head or ()):
        for f in ("x_hi", "m", "x_sum_user", "x_sum_item"):
            x, y = getattr(h, f), getattr(g, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f
        assert (h.x_lo is None) == (g.x_lo is None)
        if h.x_lo is not None:
            assert torch.equal(h.x_lo, g.x_lo)
        assert (h.hu, h.hi, h.r0, h.row_start) == (g.hu, g.hi, g.r0, g.row_start)


@pytest.mark.parametrize("case", sorted(HEADS))
def test_round_trip(small_ratings, tmp_path, spy, case):
    kw = HEADS[case]
    ref = _build(small_ratings, None, **kw)
    cold = _build(small_ratings, str(tmp_path), **kw)
    entries = sorted(tmp_path.iterdir())
    assert len(entries) == 1 and entries[0].name.startswith(lc.KIND + "_")
    n_tiers = len(ref.head or ())
    assert spy == {"tail": 4, "scatter": 2 * n_tiers}
    hit = _build(small_ratings, str(tmp_path), **kw)
    assert spy == {"tail": 4, "scatter": 3 * n_tiers}  # the hit scatters, builds no tail
    _assert_same_layout(cold, ref)
    _assert_same_layout(hit, ref)


def test_fractional_ratings_keep_x_lo(small_ratings, tmp_path):
    u, i, x = small_ratings
    x = x - x.mean()
    kw = dict(n_users=120, n_items=80, reorder=True, head=(16, 24), head_r0=4,
              device="cpu")
    ref = tblocked.build_blocked(u, i, x, **kw)
    tblocked.build_blocked(u, i, x, cache_dir=str(tmp_path), **kw)
    hit = tblocked.build_blocked(u, i, x, cache_dir=str(tmp_path), **kw)
    assert ref.head[0].x_lo is not None
    _assert_same_layout(hit, ref)


def test_key_follows_data_and_geometry(small_ratings, tmp_path):
    u, i, x = _ratings(small_ratings)
    kw = dict(n_users=120, n_items=80, reorder=True, head=(16, 24), head_r0=4,
              device="cpu", cache_dir=str(tmp_path))
    tblocked.build_blocked(u, i, x, **kw)
    tblocked.build_blocked(u, i, x, **kw)
    assert len(os.listdir(tmp_path)) == 1
    x2 = x.copy()
    x2[0] += 1.0
    tblocked.build_blocked(u, i, x2, **kw)  # the data
    tblocked.build_blocked(u, i, x, **dict(kw, head=(16, 32)))  # the head
    tblocked.build_blocked(u, i, x, **dict(kw, head_r0=8))  # the row chunk
    tblocked.build_blocked(u, i, x, **dict(kw, n_users=121))  # the sizes
    tblocked.build_blocked(u, i, x, **dict(kw, dtype=np.float64))  # the dtype
    assert len(os.listdir(tmp_path)) == 6
    fp = lc.data_fingerprint(u, i, x)
    assert lc.make_key(fp, {"a": 1}) != lc.make_key(fp, {"a": 2})
    assert lc.make_key(fp, {"a": 1}) != lc.make_key(lc.data_fingerprint(u, i, x2), {"a": 1})


def test_key_follows_the_layout_code(small_ratings, tmp_path, spy, monkeypatch):
    """An edit to the code that builds or packs the layout is a miss, even
    where LAYOUT_CACHE_VERSION stayed: the key holds the sources' sha1."""
    import hashlib

    h = hashlib.sha1()
    for mod in (tblocked, lc):
        with open(mod.__file__, "rb") as f:
            h.update(f.read())
    assert lc.code_fingerprint() == h.hexdigest()
    _build(small_ratings, str(tmp_path), **HEADS["one_tier"])
    _build(small_ratings, str(tmp_path), **HEADS["one_tier"])
    assert spy["tail"] == 2 and len(os.listdir(tmp_path)) == 1
    monkeypatch.setattr(lc, "code_fingerprint", lambda: "an edited build")
    _build(small_ratings, str(tmp_path), **HEADS["one_tier"])
    assert spy["tail"] == 4 and len(os.listdir(tmp_path)) == 2


def test_corrupt_entry_means_a_rebuild(small_ratings, tmp_path, spy):
    ref = _build(small_ratings, None, **HEADS["one_tier"])
    _build(small_ratings, str(tmp_path), **HEADS["one_tier"])
    (entry,) = tmp_path.iterdir()
    entry.write_bytes(entry.read_bytes()[:100])
    spy.update(tail=0, scatter=0)
    with pytest.warns(UserWarning, match="unreadable"):
        got = _build(small_ratings, str(tmp_path), **HEADS["one_tier"])
    assert spy["tail"] == 2  # rebuilt
    _assert_same_layout(got, ref)
    assert lc.load_entry(str(entry)) is not None  # and written again, whole


def test_env_var_is_the_ports_own(small_ratings, tmp_path, monkeypatch):
    monkeypatch.setenv("PMF_TPU_LAYOUT_CACHE", str(tmp_path / "jax"))
    _build(small_ratings, None, **HEADS["one_tier"])
    assert not (tmp_path / "jax").exists()  # the JAX package's variable: no cache
    monkeypatch.setenv(lc.ENV_VAR, str(tmp_path / "torch"))
    assert lc.ENV_VAR == "PMF_TPU_TORCH_LAYOUT_CACHE"
    _build(small_ratings, None, **HEADS["one_tier"])
    assert len(os.listdir(tmp_path / "torch")) == 1
    _build(small_ratings, "", **HEADS["one_tier"])  # an empty argument turns it off
    monkeypatch.setenv(lc.ENV_VAR, "")
    assert lc.resolve_cache_dir(None) is None
    assert len(os.listdir(tmp_path / "torch")) == 1


def test_cli_runtime_sets_the_default(monkeypatch):
    from pmf_tpu_torch.cli import common

    # Recorded so that teardown removes what setup_runtime sets.
    monkeypatch.setenv(lc.ENV_VAR, "")
    monkeypatch.delenv(lc.ENV_VAR)
    common.setup_runtime("cpu")
    assert os.environ[lc.ENV_VAR] == common.LAYOUT_CACHE_DEFAULT
    assert common.LAYOUT_CACHE_DEFAULT.endswith(os.path.join(".torch_cache", "layouts"))
    monkeypatch.setenv(lc.ENV_VAR, "elsewhere")
    common.setup_runtime("cpu")
    assert os.environ[lc.ENV_VAR] == "elsewhere"
    gitignore = open(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                  ".gitignore")).read().split()
    assert ".torch_cache/" in gitignore


def test_cached_layout_fits_identically(small_splits, tmp_path, monkeypatch):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    train, val = (tu, ti, tx + 1.0), (vu, vi, vx + 1.0)
    cfg = dict(n_factors=5, max_iter=4, tol=None, verbose=False, engine="blocked_high")
    plain = thpf.HPF(thpf.HPFConfig(**cfg)).fit(train, val, device="cpu")
    monkeypatch.setenv(lc.ENV_VAR, str(tmp_path))
    cold = thpf.HPF(thpf.HPFConfig(**cfg)).fit(train, val, device="cpu")
    hit = thpf.HPF(thpf.HPFConfig(**cfg)).fit(train, val, device="cpu")
    assert len(os.listdir(tmp_path)) == 1
    for m in (cold, hit):
        for k in plain.state:
            assert torch.equal(m.state[k], plain.state[k]), k
        assert ([h["val_rmse"] for h in m.fit_history]
                == [h["val_rmse"] for h in plain.fit_history])
