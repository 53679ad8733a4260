"""Disk cache of the hybrid layout (``data.blocked.build_blocked``).

The layout is a pure function of the edge data and the geometry
arguments, and at 25M edges its host build takes seconds that a repeat
fit (tune, compare, train_full, a benchmark's turns) need not pay again.
This module keeps built layouts keyed by a sha1 of the (u, i, x) arrays,
every geometry argument, ``LAYOUT_CACHE_VERSION`` and a sha1 of the
sources that build and pack the layout (``data/blocked.py`` and this
module), after the JAX package's ``pmf_tpu/data/layout_cache.py``: an edit
to either source is a miss even where the version was not bumped.

What is stored, in one self-contained ``.npz`` an entry:

* each direction's ``TailCSR`` host arrays verbatim (``row_ptr``,
  ``other``, ``x`` and the four permutations) with its sizes and
  ``long_rows``;
* each ``DenseHead`` tier as its scatter triples (flat cell index and
  float32 rating of every head edge) with ``(hu, hi, r0, row_start)``.
  A hit scatters them on the device as the cold build does
  (``blocked._scatter_head``), so only the triples cross to the card, not
  the cell planes.

The kind string (``torch_blocked``) is the port's own, so the two packages
never read each other's entries.  Entries are written to a temporary file
and moved into place (``os.replace``): readers never see a partial entry.
An entry that does not load is a miss: the layout is rebuilt and written
again.  A write that fails warns and keeps the built layout.

On with ``build_blocked(..., cache_dir=DIR)`` or the environment variable
``PMF_TPU_TORCH_LAYOUT_CACHE`` (the CLIs set a default, see
``cli.common.setup_runtime``); an empty value turns it off.  Only the
blocked layout is cached, as in the JAX package.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
import warnings

import numpy as np

LAYOUT_CACHE_VERSION = 1
ENV_VAR = "PMF_TPU_TORCH_LAYOUT_CACHE"
KIND = "torch_blocked"


def resolve_cache_dir(cache_dir: str | None) -> str | None:
    """The argument where given (an empty string turns caching off), else
    ``PMF_TPU_TORCH_LAYOUT_CACHE``, else None (off)."""
    if cache_dir is not None:
        return cache_dir or None
    return os.environ.get(ENV_VAR) or None


def data_fingerprint(*arrays) -> str:
    """sha1 over each array's dtype, shape and bytes, in order."""
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.view(np.uint8).data)
    return h.hexdigest()


@functools.cache
def code_fingerprint() -> str:
    """sha1 of the sources whose code decides an entry's arrays: the
    layout build (``data/blocked.py``) and this module's packing."""
    h = hashlib.sha1()
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("blocked.py", "layout_cache.py"):
        with open(os.path.join(here, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def make_key(fingerprint: str, params: dict) -> str:
    blob = json.dumps({"kind": KIND, "fp": fingerprint, "params": params,
                       "version": LAYOUT_CACHE_VERSION, "code": code_fingerprint()},
                      sort_keys=True, default=repr)
    return hashlib.sha1(blob.encode()).hexdigest()


def entry_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{KIND}_{key}.npz")


def save_entry(path: str, arrays: dict, meta: dict) -> None:
    """Write an uncompressed npz to a temporary name, then move it into
    place.  A failure warns: the layout in hand is still good."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                         **arrays)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except Exception as e:  # noqa: BLE001 - the cache is best-effort
        warnings.warn(f"layout cache write failed ({path}): {e}")


def load_entry(path: str):
    """(arrays, meta) of an entry, or None when it is missing or does not
    load (then the caller rebuilds)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        return arrays, meta
    except Exception as e:  # noqa: BLE001 - a bad entry is a miss
        warnings.warn(f"layout cache entry unreadable ({path}): {e}")
        return None


def pack(tails: dict, head_triples: list, arrays: dict) -> dict:
    """``tails``: {"bu": (host arrays, meta), "bi": ...} as
    ``blocked._tail_host`` returns them; ``head_triples``: per tier
    (idx, x, {"hu", "hi", "r0", "row_start"}).  Fills ``arrays`` and
    returns the entry's meta."""
    meta = {"tails": {}, "tiers": []}
    for prefix, (host, tmeta) in tails.items():
        for name, a in host.items():
            arrays[f"{prefix}.{name}"] = a
        meta["tails"][prefix] = tmeta
    for t, (idx, xs, tm) in enumerate(head_triples):
        arrays[f"t{t}.idx"] = np.asarray(idx, np.int32)
        arrays[f"t{t}.x"] = np.asarray(xs, np.float32)
        meta["tiers"].append(tm)
    return meta


def unpack(arrays: dict, meta: dict, device):
    """The ``BlockedCOO`` of an entry on ``device``, its head tiers
    scattered there from the triples."""
    from pmf_tpu_torch.data.blocked import BlockedCOO, _scatter_head, _tail_from_host

    tails = {}
    for prefix, tmeta in meta["tails"].items():
        host = {k.split(".", 1)[1]: a for k, a in arrays.items()
                if k.startswith(prefix + ".")}
        tails[prefix] = _tail_from_host(host, tmeta, device)
    heads = [_scatter_head(arrays[f"t{t}.idx"], arrays[f"t{t}.x"], hu=tm["hu"],
                           hi=tm["hi"], r0=tm["r0"], row_start=tm["row_start"],
                           device=device)
             for t, tm in enumerate(meta["tiers"])]
    return BlockedCOO(by_user=tails["bu"], by_item=tails["bi"],
                      head=tuple(heads) if heads else None)
