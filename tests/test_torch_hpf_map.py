"""Port ``models.hpf_map`` (HPF by MAP/SGD) against the JAX package on the
CPU: the init draws bit for bit, the loss and its gradient and Adam in
float64, one flat epoch on the same permutation (1e-9), one blocked epoch
on the same segments and segment order against the Pallas kernel in
interpret mode at the JAX tests' own gate (rtol 2e-4, atol 2e-5, f32), and
the fits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmf_tpu.data.coo import build_eval_set as j_build_eval_set
from pmf_tpu.models import hpf_map as j_map
from pmf_tpu_torch.data.coo import build_eval_set as t_build_eval_set
from pmf_tpu_torch.models import hpf_map as t_map
from pmf_tpu_torch.ops.adam import adam_init, adam_update
from tests.test_torch_map_grad import map_data, port_layout

torch.set_num_threads(1)

SCAL = (0.3, 1.0, 1.0, 0.3, 1.0, 1.0)
RTOL, ATOL = 2e-4, 2e-5  # tests/test_hpf_map_blocked.py's gate


def _scales(u, i, n_users, n_items, dtype):
    return ((1.0 / (np.bincount(u, minlength=n_users) + 1e-6)).astype(dtype),
            (1.0 / (np.bincount(i, minlength=n_items) + 1e-6)).astype(dtype))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_params_equal_the_jax_draws(dtype):
    ref = j_map.init_params(70, 50, j_map.HPFMapConfig(n_factors=7, random_state=5,
                                                       dtype=dtype))
    got = t_map.init_params(70, 50, t_map.HPFMapConfig(n_factors=7, random_state=5,
                                                       dtype=dtype), device="cpu")
    for k in ("user", "item"):
        assert got[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert got["user"].shape == (70, 8) and got["item"].shape == (50, 8)


def test_config_defaults_equal_the_jax_config():
    ref = dataclasses.asdict(j_map.HPFMapConfig())
    assert dataclasses.asdict(t_map.HPFMapConfig()) == ref
    assert t_map.LAMBDA_FLOOR == j_map.LAMBDA_FLOOR


def test_softplus_equals_jax_softplus_everywhere():
    x = np.array([-60.0, -5.0, 0.0, 3.0, 19.9, 20.1, 25.0, 60.0])
    np.testing.assert_allclose(t_map.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-15, atol=0)
    # torch's own softplus is the identity above 20; this one is not.
    assert t_map.softplus(_t(x))[6].item() > 25.0


@pytest.mark.parametrize("K", [3, 20])
def test_batch_loss_and_gradient_match_jax(K):
    u, i, x, n_users, n_items = map_data(n_users=60, n_items=45, nnz=900)
    pad = 37  # padded rows: u clamps to 0, mask False
    u_b = np.concatenate([u, np.zeros(pad, np.int64)])
    i_b = np.concatenate([i, np.zeros(pad, np.int64)])
    x_b = np.concatenate([x, np.zeros(pad)])
    mask = np.arange(len(u_b)) < len(u)
    us, is_ = _scales(u, i, n_users, n_items, np.float64)
    cfg = t_map.HPFMapConfig(n_factors=K, random_state=2, dtype="float64")
    p_np = t_map._init_params_numpy(n_users, n_items, cfg)
    loss_ref, g_ref = jax.value_and_grad(j_map.batch_loss)(
        _j(p_np), jnp.asarray(u_b), jnp.asarray(i_b), jnp.asarray(x_b),
        jnp.asarray(mask), jnp.asarray(us), jnp.asarray(is_), SCAL)
    leaves = {k: _t(v).requires_grad_(True) for k, v in p_np.items()}
    loss = t_map.batch_loss(leaves, _t(u_b), _t(i_b), _t(x_b), _t(mask), _t(us),
                            _t(is_), SCAL)
    g_user, g_item = torch.autograd.grad(loss, [leaves["user"], leaves["item"]])
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-12)
    np.testing.assert_allclose(g_user.numpy(), np.asarray(g_ref["user"]),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g_item.numpy(), np.asarray(g_ref["item"]),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("grads", ["dense", "partly_zero"])
def test_adam_update_matches_optax(grads):
    rng = np.random.default_rng(4)
    p_np = {"user": rng.standard_normal((9, 4)), "item": rng.standard_normal((6, 4))}
    opt = optax.adam(0.01)
    jp, js = _j(p_np), None
    js = opt.init(jp)
    tp = {k: _t(v) for k, v in p_np.items()}
    ts = adam_init(tp)
    for step in range(5):
        g_np = {k: rng.standard_normal(v.shape) for k, v in p_np.items()}
        if grads == "partly_zero":  # rows outside the batch: decay, old momentum
            g_np["user"][step % 3 :: 3] = 0.0
            g_np["item"][: 1 + step] = 0.0
        upd, js = opt.update(_j(g_np), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = adam_update({k: _t(v) for k, v in g_np.items()}, ts, tp, 0.01)
    assert ts["count"] == 5 == int(js[0].count)
    for k in ("user", "item"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(js[0].mu[k]),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js[0].nu[k]),
                                   rtol=1e-12, atol=1e-15)


def test_optimizer_state_round_trips_through_numpy():
    rng = np.random.default_rng(0)
    p_np = {"user": rng.standard_normal((5, 3)), "item": rng.standard_normal((4, 3))}
    opt = optax.adam(0.01)
    js = opt.init(_j(p_np))
    _, js = opt.update(_j(p_np), js, _j(p_np))
    adam = js[0]
    state = t_map.opt_state_from_numpy(
        np.asarray(adam.count), {k: np.asarray(v) for k, v in adam.mu.items()},
        {k: np.asarray(v) for k, v in adam.nu.items()}, device="cpu")
    assert state["count"] == 1 and state["mu"]["user"].dtype == torch.float64
    count, mu, nu = t_map.opt_state_to_numpy(state)
    assert count.dtype == np.int32 and int(count) == 1
    for k in ("user", "item"):
        np.testing.assert_array_equal(mu[k], np.asarray(adam.mu[k]))
        np.testing.assert_array_equal(nu[k], np.asarray(adam.nu[k]))
    back = t_map.params_to_numpy(t_map.params_from_numpy(p_np, device="cpu"))
    np.testing.assert_array_equal(back["item"], p_np["item"])


def _compare_state(tp, ts, jp, js, rtol, atol):
    for k in ("user", "item"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(js[0].mu[k]),
                                   rtol=rtol, atol=atol, err_msg="mu " + k)
        np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js[0].nu[k]),
                                   rtol=rtol, atol=atol, err_msg="nu " + k)
    assert ts["count"] == int(js[0].count)


def test_flat_epoch_matches_jax_on_the_same_permutation():
    u, i, x, n_users, n_items = map_data(n_users=60, n_items=45, nnz=900)
    B = 256
    nnz = len(u)
    n_pad = -(-nnz // B) * B
    assert n_pad > nnz and n_pad // B >= 3  # several batches, the last padded
    ui = np.full((n_pad, 2), -1, np.int32)
    ui[:nnz, 0], ui[:nnz, 1], ui[nnz:, 1] = u, i, 0
    x_pad = np.zeros(n_pad)
    x_pad[:nnz] = x
    us, is_ = _scales(u, i, n_users, n_items, np.float64)
    cfg = t_map.HPFMapConfig(n_factors=5, random_state=1, dtype="float64", lr=0.01)
    p_np = t_map._init_params_numpy(n_users, n_items, cfg)  # before the donation
    key = jax.random.key(7)
    perm = np.array(jax.random.permutation(key, n_pad))
    opt = optax.adam(cfg.lr)
    jp = _j(p_np)
    jp, js, j_loss = j_map.train_epoch(
        jp, opt.init(jp), key, jnp.asarray(ui), jnp.asarray(x_pad), jnp.asarray(us),
        jnp.asarray(is_), SCAL, opt, B)
    tp = t_map.params_from_numpy(p_np, device="cpu")
    tp, ts, t_loss = t_map.train_epoch(tp, adam_init(tp), perm, _t(ui), _t(x_pad),
                                       _t(us), _t(is_), SCAL, cfg.lr, B)
    assert t_loss.dim() == 0 and tp["user"].dtype == torch.float64
    _compare_state(tp, ts, jp, js, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-9)


@pytest.mark.parametrize("mix", [1, 3, 4])
def test_blocked_epoch_matches_jax_on_the_same_segments(mix):
    """Several Adam steps of ``mix`` segments each (mix=4 pads two empty
    segments), in the very segment order the JAX epoch draws."""
    u, i, x, n_users, n_items = map_data()
    cfg = t_map.HPFMapConfig(n_factors=6, random_state=0, lr=0.01)
    lay = j_map.build_map_layout(u, i, x, n_users, n_items, batch_size=mix * 2048,
                                 dtype=np.float32, mix=mix)
    n_steps = lay.n_segments // mix
    assert n_steps >= 2
    us, is_ = _scales(u, i, n_users, n_items, np.float32)
    u_o2n, i_o2n = np.asarray(lay.u_old_of_new), np.asarray(lay.i_old_of_new)
    p_np = t_map._init_params_numpy(n_users, n_items, cfg)
    p_new = {"user": p_np["user"][u_o2n], "item": p_np["item"][i_o2n]}
    key = jax.random.key(3)
    perm = np.array(jax.random.permutation(key, lay.n_segments))
    opt = optax.adam(cfg.lr)
    jp = _j(p_new)
    jp, js, j_loss = j_map.train_epoch_blocked(
        jp, opt.init(jp), key, lay, jnp.asarray(us[u_o2n]), jnp.asarray(is_[i_o2n]),
        SCAL, opt, precision="highest", interpret=True, mix=mix)
    t_lay = port_layout(lay, mix)
    tp = t_map.params_from_numpy(p_new, device="cpu")
    tp, ts, t_loss = t_map.train_epoch_blocked(
        tp, adam_init(tp), perm, t_lay, _t(us[u_o2n]), _t(is_[i_o2n]), SCAL, cfg.lr,
        mix)
    assert ts["count"] == n_steps and tp["user"].dtype == torch.float32
    _compare_state(tp, ts, jp, js, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4)


@pytest.mark.parametrize("mix", [1, 3, 4])
def test_blocked_step_equals_flat_full_batch_step(mix):
    """One composed step over segments whose union is the whole data (the
    port's own layout; mix=4 cuts four, mix=3 pads none) equals the flat
    full-batch step: the count column turns the per-occurrence prior
    weights into per-row ones."""
    u, i, x, n_users, n_items = map_data(nnz=3000, seed=2)
    nnz = len(u)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items,
                                 batch_size=mix * (-(-nnz // mix)), mix=mix,
                                 dtype=np.float64, device="cpu")
    assert lay.n_segments == mix
    us, is_ = _scales(u, i, n_users, n_items, np.float64)
    cfg = t_map.HPFMapConfig(n_factors=4, random_state=9, dtype="float64", lr=0.01)
    params = t_map.init_params(n_users, n_items, cfg, device="cpu")
    ui = np.stack([u, i], axis=1).astype(np.int32)
    p_ref, s_ref, loss_ref = t_map.train_epoch(
        params, adam_init(params), np.arange(nnz), _t(ui), _t(x), _t(us), _t(is_),
        SCAL, cfg.lr, nnz)
    p_blk, s_blk = t_map._permute_rows(params, adam_init(params), lay.u_old_of_new,
                                       lay.i_old_of_new)
    p_blk, s_blk, loss_blk = t_map.train_epoch_blocked(
        p_blk, s_blk, np.arange(mix)[::-1].copy(), lay, _t(us)[lay.u_old_of_new],
        _t(is_)[lay.i_old_of_new], SCAL, cfg.lr, mix)
    p_blk, s_blk = t_map._permute_rows(p_blk, s_blk, lay.u_new_of_old, lay.i_new_of_old)
    for k in ("user", "item"):
        torch.testing.assert_close(p_blk[k], p_ref[k], rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(s_blk["mu"][k], s_ref["mu"][k], rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(loss_blk, loss_ref, rtol=1e-10, atol=0)


def test_blocked_epoch_rejects_a_mix_that_does_not_divide():
    u, i, x, n_users, n_items = map_data(nnz=600, seed=2)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items, 300, mix=3, device="cpu")
    params = t_map.init_params(n_users, n_items, t_map.HPFMapConfig(n_factors=3),
                               device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        t_map.train_epoch_blocked(params, adam_init(params), np.arange(3), lay,
                                  torch.ones(n_users), torch.ones(n_items), SCAL,
                                  0.01, 4)
    with pytest.raises(ValueError, match="not a multiple"):
        t_map.MapBlockedLayout.from_segments(
            [(np.zeros(0, np.int64),) * 3] * 3, (np.arange(2),) * 4, 2, 2, 2,
            device="cpu")


def test_permute_rows_there_and_back():
    rng = np.random.default_rng(1)
    params = {"user": _t(rng.standard_normal((7, 3))), "item": _t(rng.standard_normal((5, 3)))}
    state = {"count": 4, "mu": {k: v + 1 for k, v in params.items()},
             "nu": {k: v * v for k, v in params.items()}}
    u_o2n, i_o2n = _t(rng.permutation(7)), _t(rng.permutation(5))
    u_n2o, i_n2o = torch.argsort(u_o2n), torch.argsort(i_o2n)
    p1, s1 = t_map._permute_rows(params, state, u_o2n, i_o2n)
    torch.testing.assert_close(p1["user"][2], params["user"][u_o2n[2]], rtol=0, atol=0)
    torch.testing.assert_close(s1["nu"]["item"][3], state["nu"]["item"][i_o2n[3]],
                               rtol=0, atol=0)
    p2, s2 = t_map._permute_rows(p1, s1, u_n2o, i_n2o)
    assert s2["count"] == 4
    for k in ("user", "item"):
        torch.testing.assert_close(p2[k], params[k], rtol=0, atol=0)
        torch.testing.assert_close(s2["mu"][k], state["mu"][k], rtol=0, atol=0)
        torch.testing.assert_close(s2["nu"][k], state["nu"][k], rtol=0, atol=0)


def test_eval_metrics_match_jax(small_splits):
    train, val, _ = small_splits
    n_users, n_items = int(train[0].max()) + 1, int(train[1].max()) + 1
    cfg = t_map.HPFMapConfig(n_factors=5, random_state=8, dtype="float64")
    p_np = t_map._init_params_numpy(n_users, n_items, cfg)
    ev_args = (val[0], val[1], val[2] + 1.0, n_users, n_items)
    ref = j_map.eval_metrics(_j(p_np), j_build_eval_set(*ev_args, dtype=np.float64))
    got = t_map.eval_metrics(t_map.params_from_numpy(p_np, device="cpu"),
                             t_build_eval_set(*ev_args, dtype=np.float64, device="cpu"))
    for g, r in zip(got, ref):
        assert g.dim() == 0
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-12)


@pytest.mark.parametrize("batch_size,mix", [(512, 1), (700, 3), (4096, 8), (8, 16)],
                         ids=["b512_m1", "b700_m3", "b4096_m8", "b8_m16"])
def test_build_map_layout_properties(batch_size, mix):
    u, i, x, n_users, n_items = map_data(n_users=1300, n_items=700, nnz=6000, seed=6)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items, batch_size, mix=mix,
                                 device="cpu")
    nnz = len(u)
    seg_len = max(batch_size // mix, 1)
    assert lay.n_segments % mix == 0 and lay.nnz == nnz and lay.mix == mix
    assert lay.n_real_segments == -(-nnz // seg_len)
    assert 0 <= lay.n_segments - lay.n_real_segments < mix
    # The perms are those of the hybrid layout, and inverse to each other.
    for o2n, n2o, ids, n in ((lay.u_old_of_new, lay.u_new_of_old, u, n_users),
                             (lay.i_old_of_new, lay.i_new_of_old, i, n_items)):
        assert o2n.dtype == torch.int64
        np.testing.assert_array_equal(n2o[o2n].numpy(), np.arange(n))
        counts = np.bincount(ids, minlength=n)
        np.testing.assert_array_equal(o2n.numpy(), np.argsort(-counts, kind="stable"))
    # Every edge once, in tile-major order (stable in the input order),
    # cut into uniform segments; each direction's grouping of one step of
    # segments holds those edges by its self row's run, the runs longest
    # first (the runs form's order at K = 3), then by row.
    nu, ni = lay.u_new_of_old.numpy()[u], lay.i_new_of_old.numpy()[i]
    order = np.lexsort((np.arange(nnz), ni // 512, nu // 512))
    want = np.stack([nu[order], ni[order], x[order]], axis=1)
    assert lay.u.dtype == lay.i.dtype == torch.int32 and lay.x.dtype == torch.float32
    lo = 0
    for s in range(lay.n_segments):
        su, si, sx = (t.numpy() for t in lay.segment(s))
        assert len(su) == (seg_len if s < lay.n_real_segments - 1
                           else (nnz - seg_len * s if s < lay.n_real_segments else 0))
        seg = want[lo : lo + len(su)]
        np.testing.assert_array_equal(np.stack([su, si, sx], axis=1), seg)
        by_user, by_item = lay.group([s], 1, 3)
        for g, self_col in ((by_user, 0), (by_item, 1)):
            assert g.other.dtype == torch.int32 and g.x.dtype == torch.float32
            assert g.piece_ptr.dtype == torch.int64 and int(g.piece_ptr[-1]) == len(su)
            rows = np.repeat(g.piece_row.numpy(), np.diff(g.piece_ptr.numpy()))
            got = np.stack([rows, g.other.numpy(), g.x.numpy()], axis=1)
            ids = seg[:, self_col].astype(np.int64)
            run_len = np.bincount(ids)[ids]
            ref = seg[np.lexsort((np.arange(len(seg)), ids, -run_len))]
            np.testing.assert_array_equal(got, ref[:, [self_col, 1 - self_col, 2]])
        lo += len(seg)
    assert lo == nnz
    assert lay.nbytes() == 12 * nnz


def _fit(engine, train, val, epochs, **kw):
    base = dict(n_factors=6, lr=0.02, batch_size=512, verbose=False, random_state=3)
    base.update(kw)
    cfg = t_map.HPFMapConfig(engine=engine, epochs=epochs, **base)
    return t_map.HPFMap(cfg).fit(train, val, device="cpu")


@pytest.fixture(scope="module")
def fits(small_splits):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    train, val = (tu, ti, tx + 1.0), (vu, vi, vx + 1.0)
    return {"flat": _fit("flat", train, val, 12),
            "blocked_high": _fit("blocked_high", train, val, 20)}, train, val


@pytest.mark.parametrize("engine", ["flat", "blocked_high"])
def test_fit_trains_on_the_cpu(fits, engine):
    model = fits[0][engine]
    hist = model.fit_history
    assert model.engine_used == engine and model.device == torch.device("cpu")
    assert [h["epoch"] for h in hist] == list(range(1, len(hist) + 1))
    assert set(hist[0]) == {"epoch", "train_loss", "epoch_seconds", "updates_per_sec",
                            "val_rmse", "val_macro_mae"}
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert np.isfinite([h["val_rmse"] for h in hist]).all()
    assert model.best_val_rmse == min(h["val_rmse"] for h in hist)
    assert model.best_val_rmse < hist[0]["val_rmse"]
    assert model.state["user"].shape == (model.n_users, 7)
    assert model.state["item"].shape == (model.n_items, 7)


def test_blocked_fit_lands_in_the_flat_fit_band(fits):
    models = fits[0]
    assert abs(models["blocked_high"].best_val_rmse - models["flat"].best_val_rmse) < 0.1


@pytest.mark.parametrize("engine", ["flat", "blocked_high"])
def test_predict_and_evaluate_match_the_jax_model(fits, engine):
    """The blocked fit exports its state in the original row order: the JAX
    model loaded with the same parameters predicts the same."""
    models, train, val = fits
    model = models[engine]
    ref = j_map.HPFMap(j_map.HPFMapConfig(n_factors=6, verbose=False))
    ref.n_users, ref.n_items = model.n_users, model.n_items
    ref.state = _j(t_map.params_to_numpy(model.state))
    uq = np.concatenate([val[0], [model.n_users + 3, 0]])
    iq = np.concatenate([val[1], [0, model.n_items]])  # out of range: 0
    got = model.predict(uq, iq)
    np.testing.assert_allclose(got, ref.predict(uq, iq), rtol=1e-5, atol=1e-6)
    assert got[-1] == 0.0 and got[-2] == 0.0 and (got >= 0).all()
    np.testing.assert_allclose(model.evaluate_rmse(val), ref.evaluate_rmse(val), rtol=1e-5)
    np.testing.assert_allclose(model.evaluate_macro_mae(val), ref.evaluate_macro_mae(val),
                               rtol=1e-5)
    # The last recorded val RMSE is that of the exported state.
    np.testing.assert_allclose(model.fit_history[-1]["val_rmse"],
                               model.evaluate_rmse(val), rtol=1e-5)


def test_fit_without_validation_and_auto_engine(small_splits):
    (tu, ti, tx), _, _ = small_splits
    model = _fit("auto", (tu, ti, tx + 1.0), None, 2)
    assert model.engine_used == "flat"  # "auto" stays flat for MAP
    assert set(model.fit_history[0]) == {"epoch", "train_loss", "epoch_seconds",
                                         "updates_per_sec"}
    assert model.best_val_rmse == float("inf")


def test_same_seed_same_fit(small_splits):
    (tu, ti, tx), (vu, vi, vx), _ = small_splits
    train, val = (tu, ti, tx + 1.0), (vu, vi, vx + 1.0)
    a = _fit("blocked_high", train, val, 2, mix=4)
    b = _fit("blocked_high", train, val, 2, mix=4)
    assert [h["train_loss"] for h in a.fit_history] == [h["train_loss"] for h in b.fit_history]
    torch.testing.assert_close(a.state["user"], b.state["user"], rtol=0, atol=0)


@pytest.mark.parametrize("engine", ["blocked_mid", "blocked_fast", "flat_chunked"])
def test_unported_engines_raise(small_splits, engine):
    """The engines this test once saw raise are ported: "blocked_mid" and
    "blocked_fast" run the blocked engine's K9 (equal in bits to
    "blocked_high"), "flat_chunked" runs flat, as in the JAX package."""
    (tu, ti, tx), _, _ = small_splits
    train = (tu, ti, tx + 1.0)
    got = _fit(engine, train, None, 1)
    want_engine = "flat" if engine == "flat_chunked" else engine
    assert got.engine_used == want_engine
    ref = _fit("flat" if engine == "flat_chunked" else "blocked_high", train, None, 1)
    for k in ("user", "item"):
        torch.testing.assert_close(got.state[k], ref.state[k], rtol=0, atol=0)
