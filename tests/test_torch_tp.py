"""Row-sharded (TP) training of the port on the flat ring
(``fit(mesh=, state_sharding="rows")``, ``parallel.tp``) in multi-rank CPU
worlds over gloo: world 4 (a ring of 4) and 2 x 2 (rings of 2, edges split
over "data"), for the three CAVI families against the JAX package's TP
fits on the same mesh shapes of its 8 virtual devices (``tests/test_tp_fit.py``'s
gates: 1e-9 on each val RMSE, 1e-10 on the states); each rank holds only
its rows; the count-balanced deal equals the JAX package's; TP checkpoints
pass between the packages at the same degree and refuse another degree.
JAX is imported inside the tests only."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from tests.torch_world import World, mesh_of, numpy_state

torch.set_num_threads(1)

MESHES = {"ring4": (4, None), "dp2xtp2": (4, (2, 2))}
CASES = {
    "hpf": ("hpf", dict(n_factors=5, max_iter=8, tol=1e-4)),
    "poisson": ("poisson", dict(n_factors=5, max_iter=8, tol=1e-4)),
    "poisson_ext": ("poisson", dict(n_factors=5, max_iter=6, tol=1e-4, extended=True)),
    "gauss": ("gauss", dict(n_factors=5, sigma2=0.8, max_iter=8, tol=1e-4)),
    "gauss_nobias": ("gauss", dict(n_factors=5, sigma2=0.8, max_iter=8, tol=1e-4,
                                   use_bias=False)),
    "gauss_diag": ("gauss", dict(n_factors=5, sigma2=0.8, max_iter=6, tol=1e-4,
                                 covariance="diag")),
}


def _data(family, splits):
    (tu, ti, tx), (vu, vi, vx), _ = splits
    if family == "hpf":
        return (tu, ti, tx + 1.0), (vu, vi, vx + 1.0), {}
    if family == "gauss":
        mean = float(tx.mean())
        return (tu, ti, tx - mean), (vu, vi, vx - mean), {"global_mean": mean}
    return (tu, ti, tx), (vu, vi, vx), {}


def _port(family, cfg):
    from pmf_tpu_torch.models import gaussian_mf, hpf, poisson_mf

    cls, config = {"hpf": (hpf.HPF, hpf.HPFConfig),
                   "poisson": (poisson_mf.PoissonMF, poisson_mf.PoissonMFConfig),
                   "gauss": (gaussian_mf.GaussianMF, gaussian_mf.GaussianMFConfig)}[family]
    return cls(config(verbose=False, dtype="float64", engine="flat", **cfg))


def tp_world(rank, world, dims, splits, ck_port, ck_jax, ck_other):
    from pmf_tpu_torch.parallel.tp import tp_degree

    mesh = mesh_of(world, dims)
    out = {}
    for case, (family, cfg) in CASES.items():
        train, val, extra = _data(family, splits)
        m = _port(family, cfg).fit(train, val, mesh=mesh, state_sharding="rows", **extra)
        out[case] = {"state": numpy_state(m.state), "history": m.fit_history,
                     "n_sweeps": m.n_sweeps,
                     "local_rows": {k: tuple(v.shape) for k, v in m.tp.state.items()},
                     "per": (m.tp.layout.users_per, m.tp.layout.items_per),
                     "D": tp_degree(mesh)}
    train, val, _ = _data("hpf", splits)
    _port("hpf", dict(max_iter=3, n_factors=4, tol=None)).fit(
        train, val, mesh=mesh, state_sharding="rows", checkpoint_dir=ck_port,
        checkpoint_every=3)
    resumed = _port("hpf", dict(max_iter=3, n_factors=4, tol=None)).fit(
        train, val, mesh=mesh, state_sharding="rows", resume_from=ck_jax)
    out["resumed_jax"] = numpy_state(resumed.state)
    try:
        _port("hpf", dict(max_iter=1, n_factors=4, tol=None)).fit(
            train, val, mesh=mesh, state_sharding="rows", resume_from=ck_other)
        out["other_degree"] = None
    except ValueError as e:
        out["other_degree"] = str(e)
    gtrain, gval, extra = _data("gauss", splits)
    try:
        _port("gauss", dict(n_factors=4, max_iter=1, bias_update="lagged")).fit(
            gtrain, gval, mesh=mesh, state_sharding="rows", **extra)
        out["lagged_flat"] = None
    except ValueError as e:
        out["lagged_flat"] = str(e)
    return out


def _jax_mesh(dims):
    from pmf_tpu.parallel import make_mesh, make_mesh_2d

    return make_mesh(4) if dims is None else make_mesh_2d(*dims)


def _jax_model(family, cfg):
    from pmf_tpu.models import gaussian_mf, hpf, poisson_mf

    cls, config = {"hpf": (hpf.HPF, hpf.HPFConfig),
                   "poisson": (poisson_mf.PoissonMF, poisson_mf.PoissonMFConfig),
                   "gauss": (gaussian_mf.GaussianMF, gaussian_mf.GaussianMFConfig)}[family]
    return cls(config(verbose=False, dtype="float64", engine="flat", **cfg))


@pytest.fixture(scope="module", params=list(MESHES))
def tp(request, small_splits, tmp_path_factory):
    """The port's world and the JAX package's TP fits of every case, the
    JAX side's checkpoints written (npz) before the world starts."""
    from pmf_tpu.parallel import make_mesh

    world, dims = MESHES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    paths = {k: str(tmp / k) for k in ("port", "jax", "other")}
    splits = small_splits
    train, val, _ = _data("hpf", splits)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        jmesh = _jax_mesh(dims)
        _jax_model("hpf", dict(max_iter=3, n_factors=4, tol=None)).fit(
            train, val, mesh=jmesh, state_sharding="rows", checkpoint_dir=paths["jax"],
            checkpoint_every=3)
        _jax_model("hpf", dict(max_iter=1, n_factors=4, tol=None)).fit(
            train, val, mesh=make_mesh(8), state_sharding="rows",
            checkpoint_dir=paths["other"], checkpoint_every=1)
        run = World(tp_world, world, tmp, dims, splits, paths["port"], paths["jax"],
                    paths["other"])
        fits = {}
        for case, (family, cfg) in CASES.items():
            t, v, extra = _data(family, splits)
            m = _jax_model(family, cfg).fit(t, v, mesh=jmesh, state_sharding="rows",
                                            **extra)
            fits[case] = ({k: np.asarray(a) for k, a in m.state.items()}, m.fit_history)
        full = _jax_model("hpf", dict(max_iter=6, n_factors=4, tol=None)).fit(
            train, val, mesh=jmesh, state_sharding="rows")
        ranks = run.join()
        resumed = _jax_model("hpf", dict(max_iter=3, n_factors=4, tol=None)).fit(
            train, val, mesh=jmesh, state_sharding="rows", resume_from=paths["port"])
    return {"ranks": ranks, "fits": fits, "full": full, "jax_resumed": resumed}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_fit_matches_jax_tp_fit(tp, case):
    got = tp["ranks"][0][case]
    want_state, want_hist = tp["fits"][case]
    assert len(got["history"]) == len(want_hist)
    for g, w in zip(got["history"], want_hist):
        assert abs(g["val_rmse"] - w["val_rmse"]) < 1e-9
        assert abs(g["val_macro_mae"] - w["val_macro_mae"]) < 1e-9
    for k, v in want_state.items():
        np.testing.assert_allclose(got["state"][k], v, rtol=1e-10, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_state_is_row_sharded(tp, case):
    """Each rank holds rows_per rows of every state array for the whole
    fit (its own users and items), and every rank ends with the same
    gathered state and the same number of sweeps."""
    from pmf_tpu_torch.parallel.tp import (GAUSSIAN_AXIS_OF, HPF_AXIS_OF,
                                           POISSON_EXT_AXIS_OF)

    axis_of = {**GAUSSIAN_AXIS_OF, **HPF_AXIS_OF, **POISSON_EXT_AXIS_OF}
    ranks = tp["ranks"]
    D = ranks[0][case]["D"]
    users_per, items_per = ranks[0][case]["per"]
    assert users_per == -(-150 // D) and items_per == -(-90 // D)
    for r in ranks:
        for k, shape in r[case]["local_rows"].items():
            assert shape[0] == (users_per if axis_of[k] == "u" else items_per), k
        assert r[case]["n_sweeps"] == ranks[0][case]["n_sweeps"]
        for k, v in ranks[0][case]["state"].items():
            np.testing.assert_array_equal(r[case]["state"][k], v)


def test_tp_checkpoint_passes_between_the_packages(tp):
    """The port's TP checkpoint (rank 0's gather, the JAX package's npz
    form, mesh-padded balanced rows) resumes in the JAX TP fit at the same
    degree, and the JAX package's resumes in the port's: both equal the
    JAX package's unbroken 6-sweep fit."""
    full = {k: np.asarray(v) for k, v in tp["full"].state.items()}
    jax_resumed = {k: np.asarray(v) for k, v in tp["jax_resumed"].state.items()}
    for k, v in full.items():
        np.testing.assert_allclose(jax_resumed[k], v, rtol=1e-10, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(tp["ranks"][0]["resumed_jax"][k], v, rtol=1e-10,
                                   atol=1e-12, err_msg=k)


def test_tp_resume_at_another_degree_names_the_cause(tp):
    msg = tp["ranks"][0]["other_degree"]
    assert msg is not None and "does not match model state" in msg
    assert ("the leading (row) dimension differs; TP (state_sharding='rows') "
            "checkpoints store mesh-padded row counts") in msg


def test_tp_flat_ring_refuses_lagged_biases(tp):
    assert "lagged" in tp["ranks"][0]["lagged_flat"]


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
def test_balance_perms_equal_the_jax_package(small_splits, D):
    from pmf_tpu.parallel.tp import balance_perms as jbal
    from pmf_tpu_torch.parallel.tp import balance_perms as tbal

    (tu, ti, _), _, _ = small_splits
    nu, ni = -(-150 // D) * D, -(-90 // D) * D
    want, got = jbal(tu, ti, nu, ni, D), tbal(tu, ti, nu, ni, D)
    for name in ("u_old_of_new", "u_new_of_old", "i_old_of_new", "i_new_of_old"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_state_from_jax_tp_round_trips(tmp_path):
    """A JAX-form TP state (padded, balanced rows) cut into the ranks'
    shards and gathered back, on a one-rank ring."""
    import torch.distributed as dist

    from pmf_tpu_torch.parallel import make_mesh
    from pmf_tpu_torch.parallel.tp import HPF_AXIS_OF, state_from_jax_tp, state_to_jax_tp

    rng = np.random.default_rng(0)
    state = {k: rng.random((12, 3) if k[0] != "b" or k in ("b_theta", "b_beta")
                           else (12,)) for k in HPF_AXIS_OF}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, device="cpu")
        local = state_from_jax_tp(state, HPF_AXIS_OF, mesh)
        back = state_to_jax_tp(local, HPF_AXIS_OF, mesh)
    finally:
        dist.destroy_process_group()
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)


def test_remap_eval_passes_out_of_range_ids_through():
    from pmf_tpu_torch.data.coo import EvalSet
    from pmf_tpu_torch.parallel.tp import balance_perms, remap_eval

    n = 8
    bal = balance_perms(np.arange(n), np.arange(n), n, n, 2)
    t = torch.tensor
    ev = EvalSet(u=t([0, 3, n + 2], dtype=torch.int32), i=t([1, n + 5, 2], dtype=torch.int32),
                 x=torch.zeros(3), real=torch.ones(3, dtype=torch.bool),
                 valid=t([True, False, False]), class_id=torch.zeros(3, dtype=torch.int32),
                 class_value=torch.zeros(1), n_rows=3, n_rows_padded=3, n_classes=1)
    out = remap_eval(ev, bal.u_new_of_old, bal.i_new_of_old)
    assert int(out.u[2]) == n + 2 and int(out.i[1]) == n + 5
    assert int(out.u[0]) == bal.u_new_of_old[0] and int(out.i[0]) == bal.i_new_of_old[1]
