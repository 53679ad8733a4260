"""The port's blocked TP ring (``parallel.tp_blocked``: the tail and head
kernels' plain versions inside the ring) in multi-rank CPU worlds over
gloo, world 4 (a ring of 4) and 2 x 2 (rings of 2, each bucket's tail
rows and head tier rows in bands over "data"), held against the port's flat
ring (itself held against the JAX package's TP fits in
``tests/test_torch_tp.py``): HPF, plain and extended Poisson with and
without dense heads, Gaussian full and diag covariance with exact and
lagged biases (lagged against the single-device flat lagged sweep, as
the JAX package's test does), and full fits through the facade.

Everything runs in float64, where the plain versions sum exactly as the
flat ring does up to order, so the gate is 1e-9 relative (1e-12 absolute),
tighter than the JAX tests' 3e-4 / 3e-5 (Gaussian 2e-3 / 2e-4), which
cover the TPU kernels' bf16 parts in float32.  JAX is imported inside the
tests only."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_world import World, mesh_of, numpy_state

torch.set_num_threads(1)

MESHES = {"ring4": (4, None), "dp2xtp2": (4, (2, 2))}
RTOL, ATOL = 1e-9, 1e-12
HEAD = [(0, 8, 8)]  # rows a multiple of head_r0 * dp = 4 * 2
SPLIT = 3  # a piece of a tail row at most 3 edges: most rows are cut
# case -> (family, config, head tiers, the most edges a piece of a tail row)
SWEEPS = {
    "hpf": ("hpf", {}, None, None),
    "hpf_head": ("hpf", {}, HEAD, None),
    "hpf_head_split": ("hpf", {}, HEAD, SPLIT),
    "poisson": ("poisson", {}, None, None),
    "poisson_head": ("poisson", {}, HEAD, None),
    "poisson_ext": ("poisson", {"extended": True}, None, None),
    "poisson_ext_head": ("poisson", {"extended": True}, HEAD, None),
    "poisson_ext_head_split": ("poisson", {"extended": True}, HEAD, SPLIT),
    "poisson_ext_two_tiers": ("poisson", {"extended": True}, [(0, 8, 6), (8, 8, 3)],
                              None),
    "gauss_full": ("gauss", {}, None, None),
    "gauss_full_split": ("gauss", {}, None, SPLIT),
    "gauss_full_nobias": ("gauss", {"use_bias": False}, None, None),
    "gauss_diag": ("gauss", {"covariance": "diag"}, None, None),
    "gauss_diag_split": ("gauss", {"covariance": "diag"}, None, SPLIT),
    "gauss_lagged": ("gauss", {"bias_update": "lagged"}, None, None),
    "gauss_lagged_split": ("gauss", {"bias_update": "lagged"}, None, SPLIT),
}
FITS = {
    "hpf": ("hpf", dict(n_factors=4, max_iter=4, tol=None)),
    "poisson_ext": ("poisson", dict(n_factors=4, max_iter=4, tol=None, extended=True)),
    "gauss_diag": ("gauss", dict(n_factors=4, max_iter=3, tol=None, covariance="diag")),
}


def _ratings(n_users=90, n_items=70, nnz=1400, seed=3):
    """The JAX package's test data (``tests/test_tp_blocked.py::_ratings``):
    deduplicated pairs, ratings 1..5."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz)
    i = rng.integers(0, n_items, nnz)
    _, first = np.unique(u * n_items + i, return_index=True)
    u, i = u[first], i[first]
    return u, i, rng.integers(1, 6, len(u)).astype(np.float64), n_users, n_items


def _config(family, extra):
    from pmf_tpu_torch.models import gaussian_mf, hpf, poisson_mf

    if family == "hpf":
        return hpf.HPFConfig(n_factors=5, random_state=0, dtype="float64", **extra)
    if family == "poisson":
        return poisson_mf.PoissonMFConfig(n_factors=4, random_state=2, dtype="float64",
                                          **extra)
    return gaussian_mf.GaussianMFConfig(n_factors=4, random_state=0, dtype="float64",
                                        **extra)


def _family(family, cfg):
    from pmf_tpu_torch.parallel import tp

    return {"hpf": tp.hpf_family, "poisson": tp.poisson_family,
            "gauss": tp.gaussian_family}[family](cfg)


def _ring_sweeps(mesh, case, u, i, x, n_users, n_items, iters=3):
    """(flat ring state, blocked ring state) after ``iters`` sweeps from the
    same initial state, gathered, unpermuted and cut to the real rows (the
    flat one None for lagged biases, which the flat ring does not run)."""
    from pmf_tpu_torch.parallel import tp, tp_blocked

    family, extra, head, split = SWEEPS[case]
    if family == "gauss":
        x = x - x.mean()
    cfg = _config(family, extra)
    fam = _family(family, cfg)
    D = tp.tp_degree(mesh)
    bal = tp.balance_perms(u, i, -(-n_users // D) * D, -(-n_items // D) * D, D)
    ub, ib = bal.u_new_of_old[u], bal.i_new_of_old[i]
    flat = tp.build_tp_layout(ub, ib, x, n_users, n_items, mesh, dtype=np.float64)
    blk = tp_blocked.build_tp_blocked(ub, ib, x, n_users, n_items, mesh,
                                      dtype=np.float64, head=head, head_r0=4,
                                      split_row=split or tp_blocked.SPLIT_ROW)
    if head:
        assert all(len(b.head) == len(head) for b in blk.by_user + blk.by_item)
    cut = [b.pieces is not None for b in blk.by_user + blk.by_item]
    assert all(cut) if split else not any(cut)
    init = tp.permute_state_rows(
        tp.pad_state_rows(fam.init_numpy(n_users, n_items), fam.axis_of,
                          flat.n_users_pad, flat.n_items_pad, fam.pad_ones),
        fam.axis_of, bal.u_old_of_new, bal.i_old_of_new)
    s_flat = s_blk = tp.place_tp(init, fam.axis_of, mesh)
    lagged = getattr(cfg, "bias_update", "exact") == "lagged"
    for _ in range(iters):
        if not lagged:
            s_flat = fam.flat(s_flat, flat, mesh)
        s_blk = fam.blocked(s_blk, blk, mesh, "high")

    def whole(s):
        g = tp.permute_state_rows(tp.gather_state(s, mesh), fam.axis_of,
                                  bal.u_new_of_old, bal.i_new_of_old)
        return numpy_state(tp.slice_state_rows(g, fam.axis_of, n_users, n_items))

    return None if lagged else whole(s_flat), whole(s_blk)


def _fit_model(family, cfg, engine):
    from pmf_tpu_torch.models import gaussian_mf, hpf, poisson_mf

    cls, config = {"hpf": (hpf.HPF, hpf.HPFConfig),
                   "poisson": (poisson_mf.PoissonMF, poisson_mf.PoissonMFConfig),
                   "gauss": (gaussian_mf.GaussianMF, gaussian_mf.GaussianMFConfig)}[family]
    return cls(config(verbose=False, dtype="float64", engine=engine, **cfg))


def _fit_data(family, splits):
    (tu, ti, tx), (vu, vi, vx), _ = splits
    if family == "hpf":
        return (tu, ti, tx + 1.0), (vu, vi, vx + 1.0), {}
    if family == "gauss":
        mean = float(tx.mean())
        return (tu, ti, tx - mean), (vu, vi, vx - mean), {"global_mean": mean}
    return (tu, ti, tx), (vu, vi, vx), {}


def blocked_world(rank, world, dims, ratings, splits, auto):
    mesh = mesh_of(world, dims)
    out = {"sweeps": {c: _ring_sweeps(mesh, c, *ratings) for c in SWEEPS}, "fits": {}}
    for case, (family, cfg) in FITS.items():
        train, val, extra = _fit_data(family, splits)
        runs = {}
        for engine in ("flat", "blocked_high", "blocked_fast"):
            m = _fit_model(family, cfg, engine).fit(train, val, mesh=mesh,
                                                    state_sharding="rows", **extra)
            runs[engine] = (numpy_state(m.state), [r["val_rmse"] for r in m.fit_history],
                            m.engine_used, m.tp.layout.n_buckets)
        out["fits"][case] = runs
    # head="auto" with the small-data gates lifted picks tiers on shards of
    # 300 rows (the reference's test_hpf_tp_head_auto data).
    from pmf_tpu_torch.parallel import tp, tp_blocked

    u, i, x, n_users, n_items = auto
    D = tp.tp_degree(mesh)
    cfg = _config("hpf", {})
    fam = tp.hpf_family(cfg)
    bal = tp.balance_perms(u, i, -(-n_users // D) * D, -(-n_items // D) * D, D)
    ub, ib = bal.u_new_of_old[u], bal.i_new_of_old[i]
    init = tp.permute_state_rows(
        tp.pad_state_rows(fam.init_numpy(n_users, n_items), fam.axis_of,
                          -(-n_users // D) * D, -(-n_items // D) * D, fam.pad_ones),
        fam.axis_of, bal.u_old_of_new, bal.i_old_of_new)
    states = []
    for head in ("auto", None):
        lay = tp_blocked.build_tp_blocked(ub, ib, x, n_users, n_items, mesh,
                                          dtype=np.float64, head=head, head_r0=4,
                                          head_min_nnz=0, head_bytes=1 << 20)
        s = fam.blocked(tp.place_tp(init, fam.axis_of, mesh), lay, mesh, "high")
        states.append((numpy_state(tp.gather_state(s, mesh)), lay.tiers_user,
                       lay.tiers_item))
    out["auto"] = states
    out["D"] = D
    return out


def _auto_ratings():
    rng = np.random.default_rng(7)
    n = 1200
    u = rng.integers(0, n, 20000)
    i = rng.integers(0, n, 20000)
    _, first = np.unique(u * n + i, return_index=True)
    u, i = u[first], i[first]
    return u, i, rng.integers(1, 6, len(u)).astype(np.float64), n, n


@pytest.fixture(scope="module", params=list(MESHES))
def blocked(request, small_splits, tmp_path_factory):
    world, dims = MESHES[request.param]
    return World(blocked_world, world, tmp_path_factory.mktemp(request.param), dims,
                 _ratings(), small_splits, _auto_ratings()).join()


def _close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("case", [c for c in SWEEPS if "lagged" not in c])
def test_blocked_ring_matches_flat_ring(blocked, case):
    for r in blocked:
        flat, blk = r["sweeps"][case]
        _close(blk, flat)


def test_blocked_ring_lagged_matches_single_device_flat_sweep(blocked):
    """Lagged biases (2 ring passes an iteration, the bias statistics on
    K3's payload, the closed forms local) against the single-device flat
    lagged sweep."""
    from pmf_tpu_torch.data.coo import build_ratings
    from pmf_tpu_torch.models import gaussian_mf

    u, i, x, n_users, n_items = _ratings()
    x = x - x.mean()
    cfg = _config("gauss", {"bias_update": "lagged"})
    data = build_ratings(u, i, x, n_users=n_users, n_items=n_items, dtype=np.float64,
                         device="cpu")
    s = gaussian_mf.init_state(n_users, n_items, cfg, device="cpu")
    for _ in range(3):
        s = gaussian_mf.sweep(s, data, cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2,
                              cfg.eta_bias2, True, "full", "lagged")
    for r in blocked:
        for case in ("gauss_lagged", "gauss_lagged_split"):
            _close(r["sweeps"][case][1], numpy_state(s))


@pytest.mark.parametrize("case", list(FITS))
def test_blocked_tp_fit_matches_flat_tp_fit(blocked, case):
    """The facade: ``engine="blocked_high"`` under ``state_sharding="rows"``
    trains on the blocked ring (2 D buckets a rank) and lands on the flat
    ring's fit; ``blocked_fast`` runs the same ring at K2's one-term
    precision (no head at this size, so the same state)."""
    for r in blocked:
        runs = r["fits"][case]
        flat_state, flat_hist, _, _ = runs["flat"]
        for engine in ("blocked_high", "blocked_fast"):
            state, hist, used, n_buckets = runs[engine]
            assert used == engine and n_buckets == 2 * r["D"]
            _close(state, flat_state)
            np.testing.assert_allclose(hist, flat_hist, rtol=RTOL)


def test_blocked_ring_head_auto_picks_tiers_and_matches_headless(blocked):
    for r in blocked:
        (with_head, tiers_u, tiers_i), (plain, none_u, none_i) = r["auto"]
        assert tiers_u and tiers_i and not none_u and not none_i
        _close(with_head, plain)


def test_gaussian_ring_refuses_a_head(tmp_path):
    import torch.distributed as dist

    from pmf_tpu_torch.parallel import make_mesh, tp_blocked

    u, i, x, n_users, n_items = _ratings()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, device="cpu")
        lay = tp_blocked.build_tp_blocked(u, i, x, n_users, n_items, mesh,
                                          dtype=np.float64, head=HEAD, head_r0=4)
        cfg = _config("gauss", {})
        from pmf_tpu_torch.models.gaussian_mf import init_state

        s = init_state(n_users, n_items, cfg, device="cpu")
        with pytest.raises(ValueError, match="does not consume a dense head"):
            tp_blocked.tp_sweep_gaussian_blocked(s, lay, 1.0, 1.0, 1.0, 1.0,
                                                 use_bias=True, covariance="full",
                                                 mesh=mesh)
        with pytest.raises(ValueError, match="overlap"):
            tp_blocked.build_tp_blocked(u, i, x, n_users, n_items, mesh,
                                        head=[(0, 8, 8), (4, 8, 8)], head_r0=4)
        with pytest.raises(ValueError, match="invalid for shard shape"):
            tp_blocked.build_tp_blocked(u, i, x, n_users, n_items, mesh,
                                        head=[(0, 6, 8)], head_r0=4)
    finally:
        dist.destroy_process_group()
