"""The TP blocked layout's entry in the layout cache
(``parallel.tp_blocked.build_tp_blocked(cache_dir=)``,
``data.layout_cache.pack_tp`` / ``unpack_tp``) in gloo worlds of 2 ranks,
a ring of 2 (1 x 2) and two replicas of a ring of 1 (2 x 1): each rank's
share reloads equal array by array to its cold build and a sweep on it
equals one on the cold build in bits; a changed knob or code is a miss;
each rank writes its own entry; a truncated entry warns and is rebuilt;
a TP fit reads the entry named by ``PMF_TPU_TORCH_LAYOUT_CACHE``."""

from __future__ import annotations

import dataclasses
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_world import World, mesh_of, numpy_state

torch.set_num_threads(1)

MESHES = {"tp2": (1, 2), "dp2": (2, 1)}  # (dp, tp)
HEAD = [(0, 8, 8)]  # rows a multiple of head_r0 * dp = 4 * 2
KNOBS = dict(dtype=np.float64, head=HEAD, head_r0=4, split_row=3)


def _ratings(n_users=90, n_items=70, nnz=1400, seed=3):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz)
    i = rng.integers(0, n_items, nnz)
    _, first = np.unique(u * n_items + i, return_index=True)
    u, i = u[first], i[first]
    return u, i, rng.integers(1, 6, len(u)).astype(np.float64), n_users, n_items


def differences(a, b, path="layout") -> list:
    """The fields where two layouts differ: tensors in dtype, shape or bits,
    anything else in value or type."""
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
        return [] if same else [path]
    if dataclasses.is_dataclass(a):
        return [d for f in dataclasses.fields(a) if f.compare
                for d in differences(getattr(a, f.name), getattr(b, f.name),
                                     f"{path}.{f.name}")]
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            return [path]
        return [d for n, (x, y) in enumerate(zip(a, b))
                for d in differences(x, y, f"{path}[{n}]")]
    return [] if (a == b and type(a) is type(b)) else [path]


def cache_world(rank, world, dims, root, ratings):
    from pmf_tpu_torch.data import layout_cache as lc
    from pmf_tpu_torch.models.hpf import HPF, HPFConfig
    from pmf_tpu_torch.parallel import tp, tp_blocked

    mesh = mesh_of(world, dims)
    u, i, x, n_users, n_items = ratings
    D = tp.tp_degree(mesh)
    bal = tp.balance_perms(u, i, -(-n_users // D) * D, -(-n_items // D) * D, D)
    ub, ib = bal.u_new_of_old[u], bal.i_new_of_old[i]
    cdir = os.path.join(root, "tp")
    spy = {"builds": 0, "written": []}
    real_build, real_save = tp_blocked._build_dir, lc.save_entry

    def counting_build(*args, **kwargs):
        spy["builds"] += 1
        return real_build(*args, **kwargs)

    def recording_save(path, *args):
        spy["written"].append(path)
        return real_save(path, *args)

    tp_blocked._build_dir = counting_build
    lc.save_entry = recording_save

    def build(cache_dir=cdir, **knobs):
        before = spy["builds"]
        lay = tp_blocked.build_tp_blocked(ub, ib, x, n_users, n_items, mesh,
                                          cache_dir=cache_dir, **dict(KNOBS, **knobs))
        return lay, spy["builds"] > before

    uncached, _ = build(cache_dir="")
    cold, cold_built = build()
    torch.distributed.barrier()
    entries = sorted(os.listdir(cdir))
    warm, warm_built = build()
    out = {"cold_built": cold_built, "warm_built": warm_built, "entries": entries,
           "mine": [os.path.basename(p) for p in spy["written"]],
           "warm_vs_cold": differences(warm, cold),
           "cold_vs_uncached": differences(cold, uncached)}

    cfg = HPFConfig(n_factors=4, random_state=0, dtype="float64")
    fam = tp.hpf_family(cfg)
    init = tp.permute_state_rows(
        tp.pad_state_rows(fam.init_numpy(n_users, n_items), fam.axis_of,
                          cold.n_users_pad, cold.n_items_pad, fam.pad_ones),
        fam.axis_of, bal.u_old_of_new, bal.i_old_of_new)
    sweeps = []
    for lay in (cold, warm):
        s = fam.blocked(tp.place_tp(init, fam.axis_of, mesh), lay, mesh, "high")
        sweeps.append(numpy_state(tp.gather_state(s, mesh)))
    out["sweeps"] = sweeps

    out["knob_rebuilt"] = {name: build(**knobs)[1] for name, knobs in (
        ("split_row", {"split_row": 2}), ("head_bytes", {"head_bytes": 1 << 20}))}
    real_fp = lc.tp_code_fingerprint
    lc.tp_code_fingerprint = lambda: "an edited ring build"
    out["code_rebuilt"] = build()[1]
    lc.tp_code_fingerprint = real_fp

    mine = Path(spy["written"][0])
    mine.write_bytes(mine.read_bytes()[:100])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        again, rebuilt = build()
    out["truncated"] = (rebuilt, [str(w.message) for w in caught],
                        differences(again, cold), lc.load_entry(str(mine)) is not None)

    # A TP fit through the environment's cache, twice: the second reads it.
    os.environ[lc.ENV_VAR] = os.path.join(root, "fits")
    fits = []
    for _ in range(2):
        before = spy["builds"]
        m = HPF(HPFConfig(n_factors=4, max_iter=2, tol=None, verbose=False,
                          engine="blocked_high", dtype="float64")).fit(
            (u, i, x + 1.0), mesh=mesh, state_sharding="rows")
        fits.append((numpy_state(m.state), spy["builds"] > before))
    out["fits"] = fits
    torch.distributed.barrier()
    out["fit_entries"] = sorted(os.listdir(os.path.join(root, "fits")))
    return out


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    return World(cache_world, 2, root, MESHES[request.param], str(root),
                 _ratings()).join()


def test_warm_layout_equals_cold_array_by_array(ranks):
    for r in ranks:
        assert r["cold_built"] and not r["warm_built"]
        assert r["warm_vs_cold"] == [] and r["cold_vs_uncached"] == []


def test_a_sweep_on_the_warm_layout_equals_the_cold_one_in_bits(ranks):
    for r in ranks:
        cold, warm = r["sweeps"]
        for k, v in cold.items():
            np.testing.assert_array_equal(warm[k], v, err_msg=k)


@pytest.mark.parametrize("knob", ["split_row", "head_bytes"])
def test_a_changed_knob_misses(ranks, knob):
    for r in ranks:
        assert r["knob_rebuilt"][knob]


def test_a_code_change_misses(ranks):
    assert all(r["code_rebuilt"] for r in ranks)


def test_each_rank_wrote_its_own_entry(ranks):
    from pmf_tpu_torch.data import layout_cache as lc

    mine = [r["mine"][0] for r in ranks]
    assert mine[0] != mine[1]
    assert ranks[0]["entries"] == sorted(mine)
    assert all(name.startswith(lc.TP_KIND + "_") for name in mine)


def test_a_truncated_entry_warns_and_is_rebuilt(ranks):
    for r in ranks:
        rebuilt, messages, diffs, whole_again = r["truncated"]
        assert rebuilt and diffs == [] and whole_again
        assert any("unreadable" in m for m in messages)


def test_a_tp_fit_reads_the_environments_cache(ranks):
    for r in ranks:
        (first, first_built), (second, second_built) = r["fits"]
        assert first_built and not second_built
        for k, v in first.items():
            np.testing.assert_array_equal(second[k], v, err_msg=k)
    assert len(ranks[0]["fit_entries"]) == 2
