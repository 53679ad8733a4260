"""The dense part of the blocked HPF-MAP step (``ops/map_dense.py``, kernel
K10 on the card): its plain version against a float64 computation from
the JAX package's own pieces, against the arithmetic ``train_steps_grouped``
ran before it, the grouped steps against the JAX package's blocked epoch,
the blocked fit held to the reference's on a cut of the bench where the
reference's blocked fit lags its flat one, and the wrapper's checks and its
no-fallback rule.  K10 itself runs only on the card (``chip_smoke.py``
holds it against the plain version there)."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmf_tpu.models import hpf_map as j_map
from pmf_tpu_torch.data.synthetic import synth
from pmf_tpu_torch.models import hpf_map as t_map
from pmf_tpu_torch.ops import _build, map_dense
from pmf_tpu_torch.ops.adam import adam_init, adam_update
from tests.test_torch_guard import _CudaLooking, _forbid, broken_build  # noqa: F401
from tests.test_torch_hpf_map import ATOL, RTOL, SCAL, _compare_state, _j, _scales, _t
from tests.test_torch_map_grad import map_data, port_layout

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PRIORS = (0.3, 1.2, 0.8, 0.4, 1.5, 2.0)  # a, a', b', c, c', d' with a' and c' != 1


def _inputs(K, n_users=23, n_items=17, seed=0, count=3):
    """One step's inputs, float64 numpy: parameters with entries near
    +-30 (saturated softplus and sigmoid), accumulators whose count column
    is 0 on every third row (rows outside the step), Adam moments as after
    ``count`` steps."""
    rng = np.random.default_rng(seed)

    def tab(n):
        p = rng.standard_normal((n, K + 1))
        p.flat[rng.choice(p.size, max(p.size // 10, 2), replace=False)] = \
            rng.choice([-30.0, -29.5, 29.5, 30.0], max(p.size // 10, 2))
        return p

    def acc(n, width):
        a = rng.standard_normal((n, width))
        cnt = rng.integers(1, 6, n).astype(np.float64)
        cnt[::3] = 0.0
        a[:, K] = cnt
        a[cnt == 0] = 0.0
        if width > K + 1:
            a[:, K + 1] = np.where(cnt > 0, np.abs(a[:, K + 1]) * cnt, 0.0)
        return a

    p = {"user": tab(n_users), "item": tab(n_items)}
    mu = {k: 0.1 * rng.standard_normal(v.shape) for k, v in p.items()} if count else \
        {k: np.zeros_like(v) for k, v in p.items()}
    nu = {k: 0.01 * rng.random(v.shape) for k, v in p.items()} if count else \
        {k: np.zeros_like(v) for k, v in p.items()}
    scales = (1.0 / (rng.integers(1, 40, n_users) + 1e-6),
              1.0 / (rng.integers(1, 40, n_items) + 1e-6))
    return p, mu, nu, acc(n_users, K + 2), acc(n_items, K + 1), scales


def _jax_step(p, mu, nu, count, acc_u, acc_i, scales, priors, lr):
    """The step from the JAX package's pieces in float64: jax.nn.softplus
    and jax.nn.sigmoid, the prior-gradient and log-prior formulas of
    ``train_epoch_blocked``'s step body, optax.adam at its defaults."""
    a, a_prime, b_prime, c, c_prime, d_prime = priors
    K = p["user"].shape[1] - 1

    def side(pp, acc, scale, s, s_p, r_p):
        sp = jax.nn.softplus(pp)
        th, xi = sp[:, :K], sp[:, K]
        w = acc[:, K] * scale
        g_t = acc[:, :K] + w[:, None] * (xi[:, None] - (s - 1.0) / th)
        g_x = w * (-s * K / xi + th.sum(1) - (s_p - 1.0) / xi + r_p)
        grad = jnp.concatenate([g_t, g_x[:, None]], 1) * jax.nn.sigmoid(pp)
        lp = (jnp.sum(-s * jnp.log(xi)[:, None] + xi[:, None] * th
                      - (s - 1.0) * jnp.log(th), axis=1)
              - (s_p - 1.0) * jnp.log(xi) + r_p * xi)
        return grad, jnp.sum(w * lp)

    jp = _j(p)
    g_u, l_u = side(jp["user"], jnp.asarray(acc_u), jnp.asarray(scales[0]), a, a_prime,
                    b_prime)
    g_i, l_i = side(jp["item"], jnp.asarray(acc_i), jnp.asarray(scales[1]), c, c_prime,
                    d_prime)
    loss = jnp.sum(jnp.asarray(acc_u)[:, K + 1]) + l_u + l_i
    opt = optax.adam(lr)
    state = opt.init(jp)
    state = (state[0]._replace(count=jnp.asarray(count, jnp.int32), mu=_j(mu), nu=_j(nu)),
             *state[1:])
    upd, state = opt.update({"user": g_u, "item": g_i}, state, jp)
    return optax.apply_updates(jp, upd), state, loss


def _plain(p, mu, nu, count, acc_u, acc_i, scales, priors, lr, dtype=torch.float64):
    params = {k: _t(v).to(dtype) for k, v in p.items()}
    state = {"count": count, "mu": {k: _t(v).to(dtype) for k, v in mu.items()},
             "nu": {k: _t(v).to(dtype) for k, v in nu.items()}}
    return map_dense.map_dense_step_plain(
        params, state, map_dense.softplus(params["user"]), map_dense.softplus(params["item"]),
        _t(acc_u).to(dtype), _t(acc_i).to(dtype), _t(scales[0]).to(dtype),
        _t(scales[1]).to(dtype), priors, lr)


@pytest.mark.parametrize("count", [0, 1, 7, 1000])
@pytest.mark.parametrize("K", [1, 20, 129, 160])
def test_plain_step_matches_the_jax_pieces_in_float64(K, count):
    p, mu, nu, acc_u, acc_i, scales = _inputs(K, seed=K + count, count=count)
    lr = 0.01
    tp, ts, t_loss = _plain(p, mu, nu, count, acc_u, acc_i, scales, PRIORS, lr)
    jp, js, j_loss = _jax_step(p, mu, nu, count, acc_u, acc_i, scales, PRIORS, lr)
    _compare_state(tp, ts, jp, js, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-12)
    # Rows outside the step still move: decayed moments, old momentum.
    idle = acc_u[:, K] == 0
    moved = tp["user"].numpy()[idle] != p["user"][idle]
    assert moved.any() if count else not moved.any()


def _parent_step(params, opt_state, u_sp, i_sp, acc_u, acc_i, user_scale, item_scale,
                 cfg_scalars, lr):
    """A frozen copy of ``train_steps_grouped``'s step body as it stood
    before K10 (its dense part and Adam), the accumulators given."""
    a, a_prime, b_prime, c, c_prime, d_prime = cfg_scalars
    dt = params["user"].dtype
    work = u_sp.dtype
    K = params["user"].shape[1] - 1
    p_user, p_item = params["user"].to(work), params["item"].to(work)
    theta, xi = u_sp[:, :K], u_sp[:, K]
    beta, eta = i_sp[:, :K], i_sp[:, K]
    wu = acc_u[:, K] * user_scale
    wi = acc_i[:, K] * item_scale
    g_theta = acc_u[:, :K] + wu[:, None] * (xi[:, None] - (a - 1.0) / theta)
    g_xi = wu * (-a * K / xi + theta.sum(1) - (a_prime - 1.0) / xi + b_prime)
    g_beta = acc_i[:, :K] + wi[:, None] * (eta[:, None] - (c - 1.0) / beta)
    g_eta = wi * (-c * K / eta + beta.sum(1) - (c_prime - 1.0) / eta + d_prime)
    grads = {
        "user": (torch.cat([g_theta, g_xi[:, None]], 1)
                 * torch.sigmoid(p_user)).to(dt),
        "item": (torch.cat([g_beta, g_eta[:, None]], 1)
                 * torch.sigmoid(p_item)).to(dt),
    }
    lp_theta = torch.sum(-a * torch.log(xi)[:, None] + xi[:, None] * theta
                         - (a - 1.0) * torch.log(theta), dim=1)
    lp_beta = torch.sum(-c * torch.log(eta)[:, None] + eta[:, None] * beta
                        - (c - 1.0) * torch.log(beta), dim=1)
    lp_xi = -(a_prime - 1.0) * torch.log(xi) + b_prime * xi
    lp_eta = -(c_prime - 1.0) * torch.log(eta) + d_prime * eta
    loss = (acc_u[:, K + 1].sum() + torch.sum(wu * (lp_theta + lp_xi))
            + torch.sum(wi * (lp_beta + lp_eta)))
    params, opt_state = adam_update(grads, opt_state, params, lr)
    return params, opt_state, loss


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 20, 160])
def test_plain_step_equals_the_parent_arithmetic_in_bits(K, dtype):
    p, mu, nu, acc_u, acc_i, scales = _inputs(K, seed=3 * K, count=4)
    params = {k: _t(v).to(dtype) for k, v in p.items()}

    def state():
        return {"count": 4, "mu": {k: _t(v).to(dtype) for k, v in mu.items()},
                "nu": {k: _t(v).to(dtype) for k, v in nu.items()}}

    args = (map_dense.softplus(params["user"]), map_dense.softplus(params["item"]),
            _t(acc_u).to(dtype), _t(acc_i).to(dtype), _t(scales[0]).to(dtype),
            _t(scales[1]).to(dtype), SCAL, 0.003)
    got = map_dense.map_dense_step_plain(params, state(), *args)
    want = _parent_step(params, state(), *args)
    for k in ("user", "item"):
        assert torch.equal(got[0][k], want[0][k])
        assert torch.equal(got[1]["mu"][k], want[1]["mu"][k])
        assert torch.equal(got[1]["nu"][k], want[1]["nu"][k])
    assert got[1]["count"] == want[1]["count"] == 5
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("K", [1, 20])
def test_host_run_steps_as_the_plain_version_does(K):
    """``dense_run`` and ``map_dense_step`` on CPU tables: the plain
    version each step, the next step's softplus tables from the moved
    parameters, the run's loss the sum of the steps'."""
    p, mu, nu, acc_u, acc_i, scales = _inputs(K, seed=K, count=2)
    params = {k: _t(v) for k, v in p.items()}
    state = {"count": 2, "mu": {k: _t(v) for k, v in mu.items()},
             "nu": {k: _t(v) for k, v in nu.items()}}
    us, is_ = _t(scales[0]), _t(scales[1])
    run = map_dense.dense_run(params, state, us, is_, SCAL, 0.01)
    assert run.acc is None and run.args is None
    want_p, want_s, total = params, state, torch.zeros((), dtype=torch.float64)
    for _ in range(3):
        run.acc = (_t(acc_u), _t(acc_i))
        map_dense.map_dense_step(run)
        assert run.acc is None  # the next step's K9 allocates its own
        want_p, want_s, loss = map_dense.map_dense_step_plain(
            want_p, want_s, map_dense.softplus(want_p["user"]),
            map_dense.softplus(want_p["item"]), _t(acc_u), _t(acc_i), us, is_, SCAL, 0.01)
        total = total + loss
    got_p, got_s, got_loss = run.result()
    for k in ("user", "item"):
        assert torch.equal(got_p[k], want_p[k])
        assert torch.equal(got_s["nu"][k], want_s["nu"][k])
    assert torch.equal(run.u_sp, map_dense.softplus(want_p["user"]))
    assert torch.equal(got_loss, total) and got_s["count"] == 5
    assert state["count"] == 2 and torch.equal(params["user"], _t(p["user"]))


@pytest.mark.parametrize("mix", [1, 2])
def test_grouped_steps_match_the_jax_blocked_epoch_at_k20(mix):
    """Every grouped step of an epoch (two K9 passes and the dense part
    each) against the JAX package's blocked epoch (its Pallas kernel in
    interpret mode, f32 HIGHEST), in the very segment order it draws, on
    its own layout's segments; tolerance tests/test_hpf_map_blocked.py's."""
    u, i, x, n_users, n_items = map_data(n_users=300, n_items=120, nnz=5000, seed=3)
    cfg = t_map.HPFMapConfig(n_factors=20, random_state=4, lr=0.01)
    lay = j_map.build_map_layout(u, i, x, n_users, n_items, batch_size=mix * 1024,
                                 dtype=np.float32, mix=mix)
    n_steps = lay.n_segments // mix
    assert 2 <= n_steps <= 8
    us, is_ = _scales(u, i, n_users, n_items, np.float32)
    u_o2n, i_o2n = np.asarray(lay.u_old_of_new), np.asarray(lay.i_old_of_new)
    p_np = t_map._init_params_numpy(n_users, n_items, cfg)
    p_new = {"user": p_np["user"][u_o2n], "item": p_np["item"][i_o2n]}
    key = jax.random.key(11)
    perm = np.array(jax.random.permutation(key, lay.n_segments))
    opt = optax.adam(cfg.lr)
    jp = _j(p_new)
    jp, js, j_loss = j_map.train_epoch_blocked(
        jp, opt.init(jp), key, lay, jnp.asarray(us[u_o2n]), jnp.asarray(is_[i_o2n]),
        SCAL, opt, precision="highest", interpret=True, mix=mix)
    t_lay = port_layout(lay, mix)
    groups = t_lay.group(perm, mix, 20)
    tp = t_map.params_from_numpy(p_new, device="cpu")
    tp, ts, t_loss = t_map.train_steps_grouped(tp, adam_init(tp), groups, _t(us[u_o2n]),
                                               _t(is_[i_o2n]), SCAL, cfg.lr)
    assert ts["count"] == n_steps
    _compare_state(tp, ts, jp, js, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4)


# The blocked fit where the reference's lags its flat one, at K = 20: the bench
# cut to 1/LAG_CUT of its users, items, ratings, held-out ratings and batch
# (tests/test_torch_maplr.py's cut), lr 0.001, 3 epochs, mix 8.  There the JAX package's blocked fit ends at val
# RMSE 5.91 against its flat fit's 1.92 (scripts/map_blocked_lag.py): its
# layout's segments hold at least 2048 slots, so the cut's epoch is 25 Adam
# steps where the port's own layout keeps the bench's 380.  The port's
# blocked steps on the reference's segments, in its segment orders, follow
# its val RMSE epoch by epoch.
LAG_CUT = 64
LAG_K = 20
LAG_EPOCHS = 3
LAG_RTOL = 1e-4  # val RMSE each epoch, float32 sums in another order
LAG_FACTOR = 1.5  # the reference's blocked fit ends above this times its flat one


@pytest.fixture(scope="module")
def lag_cut():
    n_users, n_items, nnz = 162_000 // LAG_CUT, 59_000 // LAG_CUT, 25_000_000 // LAG_CUT
    u, i, x = synth(n_users, n_items, nnz, seed=0)
    rng = np.random.default_rng(1)
    val = n_users + rng.choice(nnz - n_users, size=100_000 // LAG_CUT, replace=False)
    keep = np.ones(nnz, bool)
    keep[val] = False
    return (u[keep], i[keep], x[keep]), (u[~keep], i[~keep], x[~keep])


def test_blocked_fit_holds_to_the_reference_where_it_lags_flat(lag_cut):
    from pmf_tpu.data.coo import build_eval_set as j_build_eval_set
    from pmf_tpu_torch.data.coo import build_eval_set as t_build_eval_set

    (u, i, x), (vu, vi, vx) = lag_cut
    n_users, n_items = int(u.max()) + 1, int(i.max()) + 1
    batch, mix, lr = 65536 // LAG_CUT, 8, 0.001
    flat = j_map.HPFMap(j_map.HPFMapConfig(n_factors=LAG_K, lr=lr, batch_size=batch,
                                           epochs=LAG_EPOCHS, verbose=False,
                                           engine="flat")).fit((u, i, x), (vu, vi, vx))
    flat_rmse = flat.fit_history[-1]["val_rmse"]

    lay = j_map.build_map_layout(u, i, x, n_users, n_items, batch, dtype=np.float32, mix=mix)
    u_o2n, i_o2n = np.asarray(lay.u_old_of_new), np.asarray(lay.i_old_of_new)
    u_n2o, i_n2o = np.asarray(lay.u_new_of_old), np.asarray(lay.i_new_of_old)
    us, is_ = _scales(u, i, n_users, n_items, np.float32)
    cfg = t_map.HPFMapConfig(n_factors=LAG_K, lr=lr)
    p_np = t_map._init_params_numpy(n_users, n_items, cfg)
    p_new = {"user": p_np["user"][u_o2n], "item": p_np["item"][i_o2n]}
    ev = (vu, vi, vx, n_users, n_items)
    j_val = j_build_eval_set(*ev)
    j_val = dataclasses.replace(j_val, u=jnp.asarray(u_n2o)[jnp.clip(j_val.u, 0, n_users - 1)],
                                i=jnp.asarray(i_n2o)[jnp.clip(j_val.i, 0, n_items - 1)])
    t_val = t_build_eval_set(*ev, device="cpu")
    t_val = dataclasses.replace(t_val, u=_t(u_n2o)[t_val.u.long().clamp(0, n_users - 1)],
                                i=_t(i_n2o)[t_val.i.long().clamp(0, n_items - 1)])
    opt = optax.adam(lr)
    jp = _j(p_new)
    js = opt.init(jp)
    t_lay = port_layout(lay, mix)
    tp = t_map.params_from_numpy(p_new, device="cpu")
    ts = adam_init(tp)
    j_rmse, t_rmse = [], []
    for epoch in range(LAG_EPOCHS):
        key = jax.random.key(100 + epoch)
        jp, js, _ = j_map.train_epoch_blocked(
            jp, js, key, lay, jnp.asarray(us[u_o2n]), jnp.asarray(is_[i_o2n]), SCAL, opt,
            precision="highest", interpret=True, mix=mix)
        tp, ts, _ = t_map.train_epoch_blocked(
            tp, ts, np.array(jax.random.permutation(key, lay.n_segments)), t_lay,
            _t(us[u_o2n]), _t(is_[i_o2n]), SCAL, lr, mix)
        j_rmse.append(float(j_map.eval_metrics(jp, j_val)[0]))
        t_rmse.append(float(t_map.eval_metrics(tp, t_val)[0]))
    assert lay.n_segments // mix < 380 // 10  # the reference's short epoch
    assert j_rmse[-1] > LAG_FACTOR * flat_rmse
    np.testing.assert_allclose(t_rmse, j_rmse, rtol=LAG_RTOL)


def _cuda_run(K=4, n_users=5, n_items=3, dtype=torch.float32, **repl):
    """dense_run on CUDA-looking tables (reaches K10's branch without a
    card); ``repl`` replaces a parameter, moment or scale before the run."""
    g = torch.Generator().manual_seed(0)
    tabs = {"params": {"user": torch.randn(n_users, K + 1, generator=g, dtype=dtype),
                       "item": torch.randn(n_items, K + 1, generator=g, dtype=dtype)},
            "mu": {"user": torch.zeros(n_users, K + 1, dtype=dtype),
                   "item": torch.zeros(n_items, K + 1, dtype=dtype)},
            "nu": {"user": torch.zeros(n_users, K + 1, dtype=dtype),
                   "item": torch.zeros(n_items, K + 1, dtype=dtype)},
            "user_scale": torch.ones(n_users, dtype=dtype),
            "item_scale": torch.ones(n_items, dtype=dtype)}
    for name, t in repl.items():
        where, _, side = name.partition("_")
        if where in ("params", "mu", "nu"):
            tabs[where][side] = t
        else:
            tabs[name] = t

    def looking(t):  # strides kept
        return t.as_subclass(_CudaLooking)

    state = {"count": 0, "mu": {k: looking(v) for k, v in tabs["mu"].items()},
             "nu": {k: looking(v) for k, v in tabs["nu"].items()}}
    return map_dense.dense_run({k: looking(v) for k, v in tabs["params"].items()}, state,
                               looking(tabs["user_scale"]), looking(tabs["item_scale"]),
                               SCAL, 0.01)


def test_dense_run_checks_the_tables_once():
    run = _cuda_run()
    assert run.args is not None and run.acc[0].shape == (5, 6) and run.acc[1].shape == (3, 5)
    assert run.loss.shape == (2,) and run.loss.dtype == torch.float64
    assert _cuda_run(dtype=torch.float64).args[0][15] == 1  # is_double
    with pytest.raises(TypeError, match="float32 or float64"):
        _cuda_run(dtype=torch.float16)
    with pytest.raises(ValueError, match="K >= 1"):
        _cuda_run(K=0)
    with pytest.raises(TypeError, match="mu\\['item'\\] must be torch.float32"):
        _cuda_run(mu_item=torch.zeros(3, 5, dtype=torch.float64))
    with pytest.raises(TypeError, match="user_scale must be torch.float32"):
        _cuda_run(user_scale=torch.ones(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="nu\\['user'\\] must be \\(5, 5\\)"):
        _cuda_run(nu_user=torch.zeros(5, 4))
    with pytest.raises(ValueError, match="item_scale must be \\(3,\\)"):
        _cuda_run(item_scale=torch.ones(4))
    with pytest.raises(ValueError, match="is on meta"):
        _cuda_run(mu_user=torch.zeros(5, 5, device="meta"))
    # A strided table is copied to a contiguous one (and that one moved).
    run = _cuda_run(params_user=torch.randn(5, 10)[:, ::2])
    assert run.params["user"].is_contiguous()


def test_k10_launch_arguments_follow_the_c_entry():
    run = _cuda_run(K=7, n_users=70, n_items=33)
    args, priors = run.args
    assert len(args) + 3 + 1 == len(_build.SIGNATURES["pmf_map_dense"])
    assert args[6] == 70 and args[13] == 33 and args[14] == 7
    assert args[16] == __import__("ctypes").addressof(priors)
    a, a_prime, b_prime, c, c_prime, d_prime = SCAL
    assert list(priors) == [a - 1.0, -a * 7, a_prime - 1.0, b_prime, -a, -(a_prime - 1.0),
                            c - 1.0, -c * 7, c_prime - 1.0, d_prime, -c, -(c_prime - 1.0)]
    assert run.loss.shape == (map_dense.blocks_of(70) + map_dense.blocks_of(33),) == (5,)


def test_python_mirror_matches_the_kernel_source():
    src = (REPO / "pmf_tpu_torch" / "csrc" / "map_dense.cu").read_text()
    rows = int(re.search(r"constexpr int kRowsABlock = (\d+);", src).group(1))
    warps = int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    assert rows == map_dense.ROWS_A_BLOCK and rows % warps == 0
    assert "extern \"C\" int pmf_map_dense(" in src
    # No product of the step's arithmetic can be contracted into an fma:
    # the row's only bare products are its offsets.
    body = src[src.index("double dense_row("):src.index("double dense_block(")]
    assert set(re.findall(r"\w+ \* [\w.]+", body)) == {"row * W", "row * s.acc_width",
                                                        "kChunk * G", "c * G"}


def test_k10_wrapper_raises_instead_of_falling_back(monkeypatch, broken_build):  # noqa: F811
    _forbid(monkeypatch, map_dense, "map_dense_step_plain")
    run = _cuda_run()
    before = map_dense.MAP_DENSE_LAUNCHES.count
    with pytest.raises(RuntimeError, match="nvcc not found"):
        map_dense.map_dense_step(run)
    assert map_dense.MAP_DENSE_LAUNCHES.count == before
    assert run.opt_state["count"] == 0


def test_grouped_steps_on_the_card_reach_k10_not_the_plain_version(monkeypatch,
                                                                    broken_build):  # noqa: F811
    """``train_steps_grouped`` on CUDA-looking tables reaches K10 (the
    build fails there); K9 and the plain dense step are stubbed out."""
    _forbid(monkeypatch, map_dense, "map_dense_step_plain")
    monkeypatch.setattr(t_map, "map_grad_grouped", lambda u_sp, i_sp, g, s, f, out: out)
    run = _cuda_run()

    class Groups:
        n_steps = 2

    before = map_dense.MAP_DENSE_LAUNCHES.count
    with pytest.raises(RuntimeError, match="nvcc not found"):
        t_map.train_steps_grouped(run.params, run.opt_state, (Groups, Groups),
                                  run.user_scale, run.item_scale, SCAL, 0.01)
    assert map_dense.MAP_DENSE_LAUNCHES.count == before
