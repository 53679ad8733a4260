"""The port's bindings of the C++ ingest runtime (``native/ingest.cpp``,
shared with the JAX package and unchanged): the CSV parse against pandas,
the radix sort against numpy's stable argsort, the build under several
processes at once, and the numpy/pandas fallback."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from pmf_tpu.data import native as jnative
from pmf_tpu_torch.data import coo, native
from pmf_tpu_torch.data.blocked import _tail_host, build_blocked
from pmf_tpu_torch.eval.recommend import build_exclusion_index

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.fail("the native ingest library did not build (g++ is expected here)")
    return native.get_lib()


@pytest.fixture
def no_lib(monkeypatch):
    """The library unavailable: every function takes its fallback."""
    monkeypatch.setattr(native, "get_lib", lambda: None)


def _csv(tmp_path, fractional, n=5000, seed=0, name="r.csv"):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 700, n)
    i = rng.integers(0, 300, n)
    x = (rng.integers(0, 6, n) + (np.round(rng.random(n), 3) if fractional else 0))
    df = pd.DataFrame({"extra": np.arange(n), "u": u, "rating": x, "i": i})
    path = tmp_path / name
    df.to_csv(path, index=False)
    return path, df


@pytest.mark.parametrize("fractional", [False, True], ids=["integer", "fractional"])
def test_parse_equals_pandas(lib, tmp_path, fractional):
    path, df = _csv(tmp_path, fractional)
    before = native.CALLS["parse_csv"]
    u, i, x = native.parse_interactions_csv(path)
    assert native.CALLS["parse_csv"] == before + 1
    assert u.dtype == i.dtype == np.int64 and x.dtype == np.float64
    np.testing.assert_array_equal(u, df["u"].to_numpy())
    np.testing.assert_array_equal(i, df["i"].to_numpy())
    # The parser keeps float32 ratings, as the JAX package's does.
    np.testing.assert_array_equal(x, df["rating"].to_numpy().astype(np.float32))
    for a, b in zip((u, i, x), jnative.parse_interactions_csv(str(path))):
        np.testing.assert_array_equal(a, b)


def test_parse_fallback_is_pandas(no_lib, tmp_path):
    path, df = _csv(tmp_path, False)
    before = native.CALLS["parse_csv"]
    u, i, x = native.parse_interactions_csv(path)
    assert native.CALLS["parse_csv"] == before
    for got, col in ((u, "u"), (i, "i"), (x, "rating")):
        np.testing.assert_array_equal(got, df[col].to_numpy())


@pytest.mark.parametrize("n_keys,n", [(1, 10), (5, 1000), (3000, 20_000), (70_000, 50_000)])
def test_radix_argsort_equals_stable_argsort(lib, n_keys, n):
    keys = np.random.default_rng(n_keys).integers(0, n_keys, n)
    before = native.CALLS["radix_argsort"]
    perm, counts = native.radix_argsort(keys, n_keys)
    assert native.CALLS["radix_argsort"] == before + 1
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(counts, np.bincount(keys, minlength=n_keys))


def test_radix_fallback_is_numpy(no_lib):
    keys = np.random.default_rng(1).integers(0, 50, 999)
    before = native.CALLS["radix_argsort"]
    perm, counts = native.radix_argsort(keys, 60)
    assert native.CALLS["radix_argsort"] == before
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(counts, np.bincount(keys, minlength=60))


def test_callers_equal_with_and_without_the_library(lib, monkeypatch, small_ratings):
    """build_ratings, the tail CSR, the layout and the exclusion index give
    the same arrays through the library and through numpy."""
    from pmf_tpu_torch.data import layout_cache

    monkeypatch.delenv(layout_cache.ENV_VAR, raising=False)  # build, do not reload
    u, i, x = small_ratings

    def build():
        r = coo.build_ratings(u, i, x, device="cpu")
        b = build_blocked(u, i, x + 1.0, reorder=True, head=(16, 24), head_r0=4,
                          device="cpu")
        host, meta = _tail_host(u, i, x, 120, 80, (np.arange(120),) * 4, False,
                                np.float32)
        idx = build_exclusion_index(u, i, device="cpu")
        return r, b, host, meta, idx

    before = native.CALLS["radix_argsort"]
    with_lib = build()
    assert native.CALLS["radix_argsort"] >= before + 6
    monkeypatch.setattr(native, "get_lib", lambda: None)
    without = build()
    (r1, b1, h1, m1, x1), (r2, b2, h2, m2, x2) = with_lib, without
    for f in ("u_by_u", "i_by_u", "x_by_u", "u_by_i", "i_by_i", "x_by_i",
              "user_counts", "item_counts"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f
    for p1, p2 in ((b1.by_user, b2.by_user), (b1.by_item, b2.by_item)):
        assert torch.equal(p1.row_ptr, p2.row_ptr) and torch.equal(p1.other, p2.other)
        assert torch.equal(p1.x, p2.x) and p1.long_rows == p2.long_rows
    assert m1 == m2 and all(np.array_equal(h1[k], h2[k]) for k in h1)
    np.testing.assert_array_equal(x1[0], x2[0])
    assert torch.equal(x1[1], x2[1])


BUILD_ONE = """
import sys
sys.path.insert(0, {repo!r})
from pathlib import Path
from pmf_tpu_torch.data import native
path = native.build(Path({out!r}))
import ctypes
ctypes.CDLL(str(path)).pmf_radix_argsort
print(path)
"""


def test_build_is_atomic_under_concurrent_processes(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library, one file stays, and no temporary is left behind."""
    out = tmp_path / "build"
    code = BUILD_ONE.format(repo=str(REPO), out=str(out))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    results = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [r[1] for r in results]
    paths = {r[0].strip() for r in results}
    assert paths == {str(native.library_path(out))}
    assert sorted(p.name for p in out.iterdir()) == [native.library_path(out).name]


def test_build_writes_nothing_into_the_native_directory(lib):
    """The library lives under the port's build directory, keyed by the
    source's hash; ``native/`` (the JAX package's build) is not written;
    ``pmf_scatter_edges`` (the TPU layout's packer) is not bound."""
    assert native.library_path().parent == REPO / "pmf_tpu_torch" / "_build"
    assert native.library_path().exists()
    assert native.SRC == REPO / "native" / "ingest.cpp"
    assert "-march=native" not in native.CXX_FLAGS
    assert not hasattr(native, "scatter_edges")
    assert "pmf_scatter_edges" not in [n for n in dir(lib) if not n.startswith("_")]


@pytest.mark.parametrize("bad", [-1, 50])
def test_radix_argsort_rejects_keys_out_of_range(bad):
    keys = np.array([0, 3, bad, 7])
    with pytest.raises(ValueError, match=r"outside \[0, 50\)"):
        native.radix_argsort(keys, 50)
