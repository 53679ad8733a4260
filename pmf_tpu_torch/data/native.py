"""ctypes bindings of the C++ ingest runtime (``native/ingest.cpp``).

The source is the JAX package's, unchanged: a multithreaded CSV parser of
(u, i, rating) columns and a stable LSD radix argsort with per-key counts.
``build()`` compiles it with ``g++`` into ``pmf_tpu_torch/_build/`` under a
name keyed by the source's hash and the flags (no ``-march=native``, so a
library built on one x86-64 host runs on another), writing a temporary file
and moving it into place with ``os.replace``: several processes may build
at once, and a reader only ever sees a whole library.  Nothing is written
into ``native/``, where the JAX package keeps its own build.

Bound: ``pmf_parse_csv``, ``pmf_free`` and ``pmf_radix_argsort``.  Not
bound: ``pmf_scatter_edges``, which packs the TPU layout's chunk and slot
geometry; the port's CSR tail has none.

Where the library cannot be built (no ``g++``) the functions fall back to
pandas and numpy, as the JAX package's do: the same arrays, host code
either way.  ``available()`` says which path runs, and ``CALLS`` counts
the calls that went through the library.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
SRC = REPO / "native" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
COLUMNS = ("u", "i", "rating")  # the columns parsed, by header name

# Calls that ran in the library, by function ("parse_csv", "radix_argsort").
CALLS: collections.Counter = collections.Counter()

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path(build_dir: Path | None = None) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / f"libpmf_ingest_{h.hexdigest()[:16]}.so"


def build(build_dir: Path | None = None) -> Path | None:
    """The keyed library, compiled first if missing; None when the source
    or ``g++`` is missing or the compile fails."""
    if not SRC.exists():
        return None
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=out.name + ".", suffix=".tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    except (OSError, subprocess.CalledProcessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def get_lib():
    """The loaded library (built at first use), or None."""
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.pmf_parse_csv.restype = ctypes.c_int64
    lib.pmf_parse_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_I32P), ctypes.POINTER(_I32P), ctypes.POINTER(_F32P)]
    lib.pmf_free.restype = None
    lib.pmf_free.argtypes = [ctypes.c_void_p]
    lib.pmf_radix_argsort.restype = None
    lib.pmf_radix_argsort.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int32, _I64P,
                                      _I64P]
    return lib


def available() -> bool:
    """Whether the native library built and loaded on this host."""
    return get_lib() is not None


def parse_interactions_csv(path):
    """(u int64, i int64, x float64) from the ``u``, ``i`` and ``rating``
    columns of a CSV with a header row, by the native parser (ratings pass
    through float32, as the JAX package's), or by pandas without the
    library."""
    path = str(path)
    lib = get_lib()
    if lib is None:
        import pandas as pd

        df = pd.read_csv(path)
        return (df["u"].to_numpy(np.int64), df["i"].to_numpy(np.int64),
                df["rating"].to_numpy(np.float64))
    with open(path) as f:
        header = f.readline().strip().split(",")
    idx = [header.index(c) for c in COLUMNS]
    up, ip, xp = _I32P(), _I32P(), _F32P()
    # 0 threads: the library picks its own count.
    n = lib.pmf_parse_csv(path.encode(), idx[0], idx[1], idx[2], 0,
                          ctypes.byref(up), ctypes.byref(ip), ctypes.byref(xp))
    if n < 0:
        raise IOError(f"native parse failed for {path}")
    try:
        u, i, x = (np.ctypeslib.as_array(p, shape=(n,)).astype(dt) if n else np.zeros(0, dt)
                   for p, dt in ((up, np.int64), (ip, np.int64), (xp, np.float64)))
    finally:
        for p in (up, ip, xp):
            lib.pmf_free(p)
    CALLS["parse_csv"] += 1
    return u, i, x


def radix_argsort(keys, n_keys: int):
    """(perm int64, counts int64): the stable argsort of non-negative keys
    below ``n_keys`` (the permutation of ``np.argsort(kind="stable")``) and
    each key's count, by the native radix sort, or by numpy without the
    library."""
    keys32 = np.ascontiguousarray(keys, dtype=np.int32)
    if len(keys32) and (keys32.min() < 0 or keys32.max() >= n_keys):
        # The radix passes cover [0, n_keys) only: another key would sort
        # wrong without a word.
        raise ValueError(f"keys outside [0, {n_keys})")
    lib = get_lib()
    if lib is None:
        return (np.argsort(keys32, kind="stable"),
                np.bincount(keys32, minlength=n_keys).astype(np.int64))
    n = len(keys32)
    perm = np.empty(n, dtype=np.int64)
    counts = np.zeros(n_keys, dtype=np.int64)
    lib.pmf_radix_argsort(keys32.ctypes.data_as(_I32P), n, n_keys,
                          perm.ctypes.data_as(_I64P), counts.ctypes.data_as(_I64P))
    CALLS["radix_argsort"] += 1
    return perm, counts
