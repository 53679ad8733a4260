"""Data-parallel training of the port (``fit(mesh=)``) in multi-rank CPU
worlds over gloo, against the JAX package's fits on ``make_mesh(n)`` of
its 8 virtual devices: HPF, plain and extended Poisson and Gaussian on
``flat`` and ``blocked_high``, HPF-MAP, the sharded validation metrics,
the ELBO under a mesh, checkpoints, the stop rule on every rank,
``recommend_sharded``, and the blocked layout's bands with dense heads.
JAX is imported inside the tests only: the spawned ranks import torch,
numpy and the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.torch_world import World, mesh_of, numpy_state

torch.set_num_threads(1)

WORLDS = [2, 4]

# case -> (family, config, fit kwargs); the JAX fit takes the same.
CASES = {
    "hpf_flat": ("hpf", dict(n_factors=5, max_iter=8, tol=1e-4, dtype="float64",
                             engine="flat"), {}),
    "hpf_flat_chunked": ("hpf", dict(n_factors=5, max_iter=4, tol=None,
                                     dtype="float64", engine="flat_chunked"), {}),
    "hpf_blocked": ("hpf", dict(n_factors=5, max_iter=4, tol=None, dtype="float32",
                                engine="blocked_high"), {}),
    "poisson_flat": ("poisson", dict(n_factors=4, a0=0.5, max_iter=6, tol=None,
                                     dtype="float64", engine="flat"), {}),
    "poisson_ext_flat": ("poisson", dict(n_factors=4, a0=0.5, max_iter=6, tol=None,
                                         dtype="float64", engine="flat",
                                         extended=True), {}),
    "poisson_blocked": ("poisson", dict(n_factors=4, max_iter=4, tol=None,
                                        dtype="float32", engine="blocked_high"), {}),
    "poisson_ext_blocked": ("poisson", dict(n_factors=4, max_iter=4, tol=None,
                                            dtype="float32", engine="blocked_high",
                                            extended=True), {}),
    "gauss_flat": ("gauss", dict(n_factors=5, sigma2=0.8, max_iter=8, tol=1e-4,
                                 dtype="float64", engine="flat"), {"elbo_every": 2}),
    "gauss_diag_flat": ("gauss", dict(n_factors=5, sigma2=0.8, max_iter=5, tol=None,
                                      dtype="float64", engine="flat",
                                      covariance="diag"), {}),
    "gauss_lagged_flat": ("gauss", dict(n_factors=5, sigma2=0.8, max_iter=5,
                                        tol=None, dtype="float64", engine="flat",
                                        bias_update="lagged"), {}),
    # In float64, against the JAX mesh fit on "flat" (JAX_ENGINE below).
    "gauss_blocked": ("gauss", dict(n_factors=4, sigma2=0.8, max_iter=4, tol=None,
                                    dtype="float64", engine="blocked_high"), {}),
    "map": ("map", dict(n_factors=4, lr=0.01, batch_size=4096, epochs=5,
                        random_state=1, dtype="float64"), {}),
}
# The JAX tests' gates (tests/test_mesh_fit.py): 1e-10 for the float64 CAVI
# fits, 1e-8 for the MAP fit, 1e-5 for the float32 blocked fits.  The JAX
# blocked Gaussian engine's bf16 parts move the covariances' small
# off-diagonal entries by more than 1e-5 from the port's float32 sums, so the
# port's blocked Gaussian fit runs in float64 and is held against the JAX
# mesh fit on the flat engine at the port's blocked-vs-JAX gate, 1e-8
# (tests/test_torch_gaussian_fit.py).
GATES = {"map": (1e-8, 1e-10), "gauss_blocked": (1e-8, 1e-10)}
JAX_ENGINE = {"gauss_blocked": "flat"}
BLOCKED_GATE = (1e-5, 1e-6)
FLAT_GATE = (1e-10, 1e-12)


def _gate(case):
    if case in GATES:
        return GATES[case]
    return BLOCKED_GATE if "blocked" in case else FLAT_GATE


def _hist_tol(case):
    return 10 * _gate(case)[0]


def _data(family, splits):
    (tu, ti, tx), (vu, vi, vx), _ = splits
    if family in ("hpf", "map"):
        return (tu, ti, tx + 1.0), (vu, vi, vx + 1.0), {}
    if family == "gauss":
        mean = float(tx.mean())
        return (tu, ti, tx - mean), (vu, vi, vx - mean), {"global_mean": mean}
    return (tu, ti, tx), (vu, vi, vx), {}


def _port_model(family, cfg):
    from pmf_tpu_torch.models import gaussian_mf, hpf, hpf_map, poisson_mf

    cls, config = {"hpf": (hpf.HPF, hpf.HPFConfig),
                   "poisson": (poisson_mf.PoissonMF, poisson_mf.PoissonMFConfig),
                   "gauss": (gaussian_mf.GaussianMF, gaussian_mf.GaussianMFConfig),
                   "map": (hpf_map.HPFMap, hpf_map.HPFMapConfig)}[family]
    return cls(config(verbose=False, **cfg))


def _summary(model):
    return {"state": numpy_state(model.state), "history": model.fit_history,
            "engine": model.engine_used}


def _heads_sweeps(mesh, splits):
    """Blocked sweeps of each CAVI family over a layout with an explicit
    two-tier head, the rank's band (``shard_blocked``), summed by the
    mesh: three sweeps each, float64."""
    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.coo import build_ratings
    from pmf_tpu_torch.parallel.mesh import shard_blocked

    out = {}
    for family, sweeps in _head_cases().items():
        train, _, _ = _data(family, splits)
        u, i, x = train
        data = build_ratings(u, i, x, n_users=150, n_items=90, dtype=np.float64,
                             device="cpu")
        blocked = shard_blocked(build_blocked(
            u, i, x, n_users=150, n_items=90, dtype=np.float64, reorder=True,
            head=[(0, 8, 40), (8, 16, 12)], head_r0=4, device="cpu"), mesh)
        for name, (init, sweep) in sweeps.items():
            s = init()
            for _ in range(3):
                s = sweep(s, blocked, data, mesh.sum)
            out[name] = numpy_state(s)
    return out


def _head_cases():
    """family -> {name: (initial state, sweep(state, blocked, data, reduce))}."""
    from pmf_tpu_torch.models import gaussian_mf, hpf, poisson_mf

    hcfg = hpf.HPFConfig(n_factors=5, dtype="float64")
    pcfg = poisson_mf.PoissonMFConfig(n_factors=4, dtype="float64")
    ecfg = poisson_mf.PoissonMFConfig(n_factors=4, dtype="float64", extended=True)
    hyper = (hcfg.a, hcfg.a_prime, hcfg.b_prime, hcfg.c, hcfg.c_prime, hcfg.d_prime)

    def gauss(covariance, bias_update):
        cfg = gaussian_mf.GaussianMFConfig(n_factors=4, sigma2=0.8, dtype="float64",
                                           covariance=covariance)
        return (lambda: gaussian_mf.init_state(150, 90, cfg, device="cpu"),
                lambda s, b, d, r: gaussian_mf.sweep_blocked(
                    s, b, d.user_counts, d.item_counts, cfg.sigma2, cfg.eta_theta2,
                    cfg.eta_beta2, cfg.eta_bias2, True, covariance=covariance,
                    bias_update=bias_update, reduce=r))

    def sx(d, axis):
        ids, n = (d.u_by_u, 150) if axis == 0 else (d.i_by_i, 90)
        x = d.x_by_u if axis == 0 else d.x_by_i
        keep = ids < n
        return torch.zeros(n, dtype=x.dtype).index_add_(0, ids[keep].long(), x[keep])

    return {
        "hpf": {"hpf": (lambda: hpf.init_state(150, 90, hcfg, device="cpu"),
                        lambda s, b, d, r: hpf.sweep_blocked(
                            s, b, d.user_counts, d.item_counts, *hyper, reduce=r))},
        "poisson": {
            "poisson": (lambda: poisson_mf.init_state(150, 90, pcfg, device="cpu"),
                        lambda s, b, d, r: poisson_mf.sweep_blocked(
                            s, b, d.user_counts, d.item_counts, pcfg.a0, pcfg.b0,
                            reduce=r)),
            "extended": (lambda: poisson_mf.init_state(150, 90, ecfg, device="cpu"),
                         lambda s, b, d, r: poisson_mf.sweep_blocked_extended(
                             s, b, d.user_counts, d.item_counts, sx(d, 0), sx(d, 1),
                             ecfg.a0, ecfg.b0, reduce=r))},
        "gauss": {"gauss_exact": gauss("full", "exact"),
                  "gauss_lagged": gauss("full", "lagged"),
                  "gauss_diag": gauss("diag", "exact")},
    }


def dp_world(rank, world, splits, ck_dir):
    """Every data-parallel case on this rank's mesh."""
    mesh = mesh_of(world, None)
    out = {}
    for case, (family, cfg, kw) in CASES.items():
        train, val, extra = _data(family, splits)
        model = _port_model(family, cfg).fit(train, val, device="cpu", mesh=mesh,
                                             **extra, **kw)
        out[case] = _summary(model)
        if case == "hpf_flat":
            users = np.arange(150)
            out["recommend"] = (model.recommend(users, k=10, train=train, mesh=mesh),
                                model.recommend(users, k=10, train=train))
    # The Poisson stop rule on a longer fit: every rank stops at one sweep.
    train, val, _ = _data("hpf", splits)
    stop = _port_model("hpf", dict(n_factors=8, max_iter=40, dtype="float64",
                                   engine="flat")).fit(train, val, device="cpu",
                                                       mesh=mesh)
    out["stop"] = (len(stop.fit_history), stop.n_sweeps, stop.fit_history[-1])
    # Checkpoint after 3 sweeps (rank 0 writes), resume for 3 more.
    cfg = dict(n_factors=4, tol=None, dtype="float64", engine="flat")
    full = _port_model("hpf", dict(max_iter=6, **cfg)).fit(train, val, device="cpu",
                                                           mesh=mesh)
    _port_model("hpf", dict(max_iter=3, **cfg)).fit(
        train, val, device="cpu", mesh=mesh, checkpoint_dir=ck_dir, checkpoint_every=3)
    resumed = _port_model("hpf", dict(max_iter=3, **cfg)).fit(
        train, val, device="cpu", mesh=mesh, resume_from=ck_dir)
    out["resume"] = (numpy_state(full.state), numpy_state(resumed.state))
    try:
        _port_model("map", dict(n_factors=4, batch_size=4097, epochs=1)).fit(
            train, None, device="cpu", mesh=mesh)
        out["map_batch_error"] = None
    except ValueError as e:
        out["map_batch_error"] = str(e)
    out["map_blocked_engine"] = _port_model("map", dict(
        n_factors=4, batch_size=4096, epochs=1, engine="blocked_high")).fit(
        train, None, device="cpu", mesh=mesh).engine_used
    out["heads"] = _heads_sweeps(mesh, splits)
    from pmf_tpu_torch.parallel import shard_state_rows

    rows = {"even": torch.arange(8 * 3.0).reshape(8, 3), "odd": torch.arange(7.0)}
    out["state_rows"] = {k: v.tolist() for k, v in shard_state_rows(rows, mesh).items()}
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def dp(request, small_splits, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"dp{n}")
    world = World(dp_world, n, tmp, small_splits, str(tmp / "ck"))
    jax_fits = _jax_fits(n, small_splits)
    return n, world.join(), jax_fits


def _jax_fits(n, splits):
    """The JAX package's fit of every case on ``make_mesh(n)``."""
    from pmf_tpu.models import gaussian_mf, hpf, hpf_map, poisson_mf
    from pmf_tpu.parallel import make_mesh

    classes = {"hpf": (hpf.HPF, hpf.HPFConfig),
               "poisson": (poisson_mf.PoissonMF, poisson_mf.PoissonMFConfig),
               "gauss": (gaussian_mf.GaussianMF, gaussian_mf.GaussianMFConfig),
               "map": (hpf_map.HPFMap, hpf_map.HPFMapConfig)}
    mesh = make_mesh(n)
    out = {}
    for case, (family, cfg, kw) in CASES.items():
        cls, config = classes[family]
        train, val, extra = _data(family, splits)
        cfg = {**cfg, **({"engine": JAX_ENGINE[case]} if case in JAX_ENGINE else {})}
        model = cls(config(verbose=False, **cfg)).fit(train, val, mesh=mesh, **extra,
                                                      **kw)
        out[case] = ({k: np.asarray(v) for k, v in model.state.items()},
                     model.fit_history)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_dp_fit_matches_jax_mesh_fit(dp, case):
    n, ranks, jax_fits = dp
    got = ranks[0][case]
    want_state, want_hist = jax_fits[case]
    rtol, atol = _gate(case)
    assert got["engine"] == ("flat" if case == "map" else CASES[case][1]["engine"])
    assert len(got["history"]) == len(want_hist)
    for g, w in zip(got["history"], want_hist):
        assert abs(g["val_rmse"] - w["val_rmse"]) <= _hist_tol(case)
        assert abs(g["val_macro_mae"] - w["val_macro_mae"]) <= _hist_tol(case)
        if "elbo" in w:
            assert g["elbo"] == pytest.approx(w["elbo"], rel=1e-9)
    assert set(got["state"]) == set(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(got["state"][k], v, rtol=rtol, atol=atol, err_msg=k)


def _metrics(summary):
    return [(r["val_rmse"], r["val_macro_mae"], r.get("elbo")) for r in summary["history"]]


def test_dp_ranks_hold_equal_replicas(dp):
    """Every rank ends with the same state and history, in bits: the
    statistics and metrics are all-reduced, so no replica drifts."""
    n, ranks, _ = dp
    for other in ranks[1:]:
        for case in CASES:
            assert _metrics(other[case]) == _metrics(ranks[0][case]), case
            for k, v in ranks[0][case]["state"].items():
                np.testing.assert_array_equal(other[case]["state"][k], v, err_msg=case)


def test_dp_stop_rule_ends_every_rank_at_one_sweep(dp):
    n, ranks, _ = dp
    stops = {r["stop"][:2] for r in ranks}
    assert len(stops) == 1
    n_hist, n_sweeps = stops.pop()
    assert n_hist < 40 and n_sweeps == n_hist + 1  # one speculative sweep discarded


def test_dp_checkpoint_resume_equals_unbroken_fit(dp):
    n, ranks, _ = dp
    full, resumed = ranks[0]["resume"]
    for k, v in full.items():
        np.testing.assert_allclose(resumed[k], v, rtol=1e-10, atol=1e-12, err_msg=k)


def test_recommend_sharded_equals_recommend(dp):
    n, ranks, _ = dp
    for r in ranks:
        (items_s, scores_s), (items, scores) = r["recommend"]
        np.testing.assert_array_equal(items_s, items)
        np.testing.assert_array_equal(scores_s, scores)
    np.testing.assert_array_equal(ranks[-1]["recommend"][0][0], ranks[0]["recommend"][1][0])


def test_shard_state_rows_cuts_what_the_data_axis_divides(dp):
    n, ranks, _ = dp
    for p, r in enumerate(ranks):
        per = 8 // n
        assert r["state_rows"]["even"] == np.arange(24.0).reshape(8, 3)[
            p * per : (p + 1) * per].tolist()
        assert r["state_rows"]["odd"] == list(range(7))


def test_dp_map_batch_must_divide_the_data_axis(dp):
    n, ranks, _ = dp
    assert ranks[0]["map_batch_error"] == (
        f"batch_size=4097 not divisible by {n} mesh devices")


def test_dp_map_blocked_engine_runs_flat_under_a_mesh(dp):
    """As the JAX package's (``hpf_map.py:558``): K9 is not on this path."""
    assert {r["map_blocked_engine"] for r in dp[1]} == {"flat"}


def _single_head_sweeps(splits):
    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.coo import build_ratings

    out = {}
    for family, sweeps in _head_cases().items():
        u, i, x = _data(family, splits)[0]
        data = build_ratings(u, i, x, n_users=150, n_items=90, dtype=np.float64,
                             device="cpu")
        blocked = build_blocked(u, i, x, n_users=150, n_items=90, dtype=np.float64,
                                reorder=True, head=[(0, 8, 40), (8, 16, 12)],
                                head_r0=4, device="cpu")
        for name, (init, sweep) in sweeps.items():
            s = init()
            for _ in range(3):
                s = sweep(s, blocked, data, None)
            out[name] = numpy_state(s)
    return out


@pytest.mark.parametrize("name", ["hpf", "poisson", "extended", "gauss_exact",
                                  "gauss_lagged", "gauss_diag"])
def test_blocked_bands_with_heads_equal_one_device(dp, small_splits, name):
    """Each rank's band of the tails and of both head tiers (8 and 16 rows,
    cut into world-many bands), summed over the mesh, gives the
    single-device blocked sweep's state (float64)."""
    n, ranks, _ = dp
    want = _single_head_sweeps(small_splits)[name]
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0]["heads"][name][k], v, rtol=1e-10,
                                   atol=1e-12, err_msg=k)


# ------------------------------------------------- meshes and placement --

@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    from pmf_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")


def test_cuda_mesh_without_a_card_raises(one_rank_group, monkeypatch):
    from pmf_tpu_torch.parallel import make_mesh, make_mesh_2d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is absent"):
        make_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_2d(1, 1)


def test_cuda_mesh_over_gloo_raises(one_rank_group, monkeypatch):
    """A CUDA mesh runs NCCL or raises: it never falls back to gloo."""
    from pmf_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    with pytest.raises(RuntimeError, match="needs the nccl backend"):
        make_mesh(device="cuda:0")


def test_mesh_size_must_match_the_group(one_rank_group):
    from pmf_tpu_torch.parallel import make_mesh, make_mesh_2d

    with pytest.raises(ValueError, match="needs a process group of as many"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="needs a process group of as many"):
        make_mesh_2d(2, 2, device="cpu")
    mesh = make_mesh(1, device="cpu")
    assert (mesh.axis_names, mesh.size, mesh.dp, mesh.tp) == (("data",), 1, 1, 1)
    assert mesh.is_writer and mesh.device == torch.device("cpu")


def test_one_rank_mesh_fit_equals_the_single_device_fit(one_rank_group, small_splits):
    """At one rank the all-reduces are copies: the DP fit is the
    single-device fit in bits."""
    from pmf_tpu_torch.models.hpf import HPF, HPFConfig
    from pmf_tpu_torch.parallel import make_mesh

    train, val, _ = _data("hpf", small_splits)
    cfg = dict(n_factors=4, max_iter=3, tol=None, verbose=False, engine="blocked_high")
    single = HPF(HPFConfig(**cfg)).fit(train, val, device="cpu")
    meshed = HPF(HPFConfig(**cfg)).fit(train, val, mesh=make_mesh(1, device="cpu"))
    assert meshed.fit_history[-1]["val_rmse"] == single.fit_history[-1]["val_rmse"]
    for k, v in single.state.items():
        assert torch.equal(meshed.state[k], v), k


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7])
def test_shares_and_bands_cover_every_row_once(parts):
    from pmf_tpu_torch.data.blocked import band_bounds
    from pmf_tpu_torch.parallel.mesh import share

    cuts = [share(23, p, parts) for p in range(parts)]
    assert np.concatenate([np.arange(23)[c] for c in cuts]).tolist() == list(range(23))
    assert [c.start for c in cuts] == [a[0] for a in np.array_split(np.arange(23), parts)]
    rng = np.random.default_rng(parts)
    counts = np.sort(rng.zipf(1.5, 40).clip(max=300))[::-1]
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    bands = band_bounds(row_ptr, parts)
    assert bands[0][0] == 0 and bands[-1][1] == 40
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    edges = [row_ptr[b] - row_ptr[a] for a, b in bands]
    assert max(edges) <= row_ptr[-1] / parts + counts.max()


def test_band_of_a_csr_rebases_and_counts_long_rows():
    from pmf_tpu_torch.data.blocked import LONG_ROW, TailCSR, band_of

    counts = np.array([200, 5, 130, 3, 0, 140, 2])
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))
    nnz = int(row_ptr[-1])
    none = torch.empty(0, dtype=torch.int64)
    p = TailCSR(row_ptr=row_ptr, other=torch.arange(nnz, dtype=torch.int32),
                x=torch.arange(nnz, dtype=torch.float32), self_old_of_new=none,
                other_old_of_new=none, self_new_of_old=none, other_new_of_old=none,
                n_self=7, n_other=nnz, nnz=nnz, reordered=False, long_rows=6)
    b = band_of(p, 3, 7)
    assert (b.row0, b.rows, b.n_self, b.nnz) == (3, 4, 7, 145)
    assert b.row_ptr.tolist() == [0, 3, 3, 143, 145]
    assert b.other.tolist() == list(range(335, 480))
    assert b.long_rows == 3  # band row 2 (row 5) holds 140 >= LONG_ROW edges
    assert LONG_ROW == 128
    assert band_of(b, 1, 3).row0 == 4
