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
never read each other's entries.

A TP rank's share of the blocked ring layout
(``parallel.tp_blocked.build_tp_blocked``) is an entry of its own kind
(``torch_tp_blocked``), one a rank: its key adds the rank's ring and
replica coordinates, so the ranks of a mesh write distinct files.  It
holds the rank's buckets (each CSR tail verbatim, with its row pieces;
each tier as its scatter triples), its permutations, counts and rating
sums and the tiers picked (``pack_tp`` / ``unpack_tp``), and its code
fingerprint adds ``parallel/tp_blocked.py`` and ``parallel/mesh.py``
(whose ``band_csr`` cuts the buckets' bands).  Entries are written to a temporary file
and moved into place (``os.replace``): readers never see a partial entry.
An entry that does not load is a miss: the layout is rebuilt and written
again.  A write that fails warns and keeps the built layout.

On with ``build_blocked(..., cache_dir=DIR)`` or the environment variable
``PMF_TPU_TORCH_LAYOUT_CACHE`` (the CLIs set a default, see
``cli.common.setup_runtime``); an empty value turns it off.  Only the
blocked layouts are cached (single-device and TP), as in the JAX
package.
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
TP_KIND = "torch_tp_blocked"
# Sources beside those of ``code_fingerprint`` that decide a TP entry: the
# bucket build and the modules it calls (the native sort's result is the
# stable argsort whichever code runs it, so its C source is left out).
TP_SOURCES = ("parallel/tp_blocked.py", "parallel/mesh.py", "parallel/tp.py",
              "data/native.py", "ops/_tail.py")
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    return _sha1_of_sources(hashlib.sha1(), ("data/blocked.py", "data/layout_cache.py"))


@functools.cache
def tp_code_fingerprint() -> str:
    """sha1 of ``code_fingerprint`` and the sources that build a TP
    rank's buckets (``TP_SOURCES``)."""
    return _sha1_of_sources(hashlib.sha1(code_fingerprint().encode()), TP_SOURCES)


def _sha1_of_sources(h, names) -> str:
    for name in names:
        with open(os.path.join(PKG_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def make_key(fingerprint: str, params: dict, kind: str = KIND,
             code: str | None = None) -> str:
    """The entry's key: ``kind``, the data fingerprint, ``params``, the
    version and ``code`` (None: ``code_fingerprint()``)."""
    blob = json.dumps({"kind": kind, "fp": fingerprint, "params": params,
                       "version": LAYOUT_CACHE_VERSION,
                       "code": code_fingerprint() if code is None else code},
                      sort_keys=True, default=repr)
    return hashlib.sha1(blob.encode()).hexdigest()


def entry_path(cache_dir: str, key: str, kind: str = KIND) -> str:
    return os.path.join(cache_dir, f"{kind}_{key}.npz")


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


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def pack_tp(layout, triples: dict, arrays: dict) -> dict:
    """A TP rank's ``TPBlockedLayout``: each bucket's tail arrays (and
    row pieces) read back to the host, each tier as its scatter triples
    (``triples[prefix][step]``: per tier (idx, x, {"hu", "hi", "r0",
    "row_start"}), as ``build_tp_blocked`` collected them), the rank's
    permutations, counts and sums.  Fills ``arrays`` and returns the
    entry's meta."""
    meta = {"dirs": {}, "layout": {}}
    for prefix, buckets in (("bu", layout.by_user), ("bi", layout.by_item)):
        dmeta = []
        for st, b in enumerate(buckets):
            key = f"{prefix}{st}"
            p = b.tail
            for name in ("row_ptr", "other", "x"):
                arrays[f"{key}.{name}"] = _host(getattr(p, name))
            if b.pieces is not None:
                arrays[f"{key}.piece_row"] = _host(b.piece_row)
                arrays[f"{key}.pieces"] = _host(b.pieces)
            tiers = []
            for t, (idx, xs, tm) in enumerate(triples[prefix][st]):
                arrays[f"{key}.t{t}.idx"] = np.asarray(idx, np.int32)
                arrays[f"{key}.t{t}.x"] = np.asarray(xs, np.float32)
                tiers.append(tm)
            dmeta.append({"n_self": p.n_self, "n_other": p.n_other, "nnz": p.nnz,
                          "long_rows": p.long_rows, "row0": b.row0, "rows": b.rows,
                          "pieces": b.pieces is not None, "tiers": tiers})
        meta["dirs"][prefix] = dmeta
    for name in ("u_old_of_new", "u_new_of_old", "i_old_of_new", "i_new_of_old",
                 "user_counts", "item_counts", "x_sum_user", "x_sum_item"):
        arrays[name] = _host(getattr(layout, name))
    meta["layout"] = {n: getattr(layout, n) for n in (
        "n_users", "n_items", "n_users_pad", "n_items_pad", "users_per", "items_per",
        "n_devices", "nnz", "tiers_user", "tiers_item")}
    return meta


def unpack_tp(arrays: dict, meta: dict, device):
    """The ``TPBlockedLayout`` of a TP entry on ``device``, each tier
    scattered there from its triples as the cold build does."""
    import torch

    from pmf_tpu_torch.data.blocked import TailCSR, _scatter_head
    from pmf_tpu_torch.parallel.tp_blocked import TPBlockedBucket, TPBlockedLayout

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    none = torch.empty(0, dtype=torch.int64, device=device)
    dirs = {}
    for prefix, dmeta in meta["dirs"].items():
        buckets = []
        for st, bm in enumerate(dmeta):
            key = f"{prefix}{st}"
            tail = TailCSR(row_ptr=t(arrays[f"{key}.row_ptr"]), other=t(arrays[f"{key}.other"]),
                           x=t(arrays[f"{key}.x"]), self_old_of_new=none,
                           other_old_of_new=none, self_new_of_old=none,
                           other_new_of_old=none, n_self=bm["n_self"],
                           n_other=bm["n_other"], nnz=bm["nnz"], reordered=False,
                           long_rows=bm["long_rows"])
            head = tuple(_scatter_head(arrays[f"{key}.t{n}.idx"], arrays[f"{key}.t{n}.x"],
                                       device=device, **tm)
                         for n, tm in enumerate(bm["tiers"]))
            pieces = ((t(arrays[f"{key}.piece_row"]), t(arrays[f"{key}.pieces"]))
                      if bm["pieces"] else (None, None))
            buckets.append(TPBlockedBucket(tail, head, bm["row0"], bm["rows"], *pieces))
        dirs[prefix] = tuple(buckets)
    lm = dict(meta["layout"])
    for side in ("tiers_user", "tiers_item"):
        lm[side] = tuple(tuple(tier) for tier in lm[side])
    return TPBlockedLayout(by_user=dirs["bu"], by_item=dirs["bi"],
                           **{n: t(arrays[n]) for n in (
                               "u_old_of_new", "u_new_of_old", "i_old_of_new",
                               "i_new_of_old", "user_counts", "item_counts",
                               "x_sum_user", "x_sum_item")}, **lm)
