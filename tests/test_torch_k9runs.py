"""K9's runs form (``csrc/map_grad.cu``, K <= 128) on the CPU: the plan
against the kernel source's constants and instances, read from its text;
the grouping's classes (each step's runs longest first, the long runs'
pieces before the short runs, one piece each); a float32 numpy emulation
of the form's order of sums (a group of G lanes a short run, a long
piece's group shares joined by a butterfly across the groups, a run's
partials added in piece order) against the float64 plain version at
``tests/test_torch_map_grad.py``'s gate; and a blocked HPF-MAP epoch of the
port against the JAX package at K = 20 and 50."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmf_tpu.models import hpf_map as j_map
from pmf_tpu_torch.models import hpf_map as t_map
from pmf_tpu_torch.ops import _build, map_grad
from pmf_tpu_torch.ops.adam import adam_init
from tests.test_torch_map_grad import map_data, port_layout, softplus_tables

torch.set_num_threads(1)

FLOOR = t_map.LAMBDA_FLOOR
RTOL, ATOL = 2e-4, 2e-5  # tests/test_torch_map_grad.py's gate
SRC = (_build.SRC_DIR / "map_grad.cu").read_text()
EMULATED_KS = (1, 8, 20, 24, 32, 33, 50, 64, 96, 128)


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _runs_of(g):
    """(G, V) of the grouping's K (its scratch rows hold K + 2 floats)."""
    return map_grad.kernel_of(g.scratch.shape[1] - 2)[1:]


# ----------------------------------------------------------------- plan --

def test_runs_constants_mirror_the_kernel_source():
    assert _constant("kRunInFlight") == map_grad.RUN_IN_FLIGHT == 4
    assert _constant("kWarpsPerBlock") == 8
    assert 'extern "C" int pmf_map_grad_runs(' in SRC
    assert len(_build.SIGNATURES["pmf_map_grad_runs"]) == 18
    assert map_grad.SHORT_RUN <= map_grad.PIECE


@pytest.mark.parametrize("K", range(1, map_grad.RUNS_MAX_K + 1, 7))
def test_runs_instance_covers_k(K):
    """G (a power of two from 4, G * 8 >= K, the least such) lanes of V
    columns (even) hold the row; a batch of G edges holds whole rounds of
    kRunInFlight; the short threshold is SHORT_RUN and pieces hold PIECE."""
    kind, G, V = map_grad.kernel_of(K)
    assert kind == "runs" and G in (4, 8, 16) and G % map_grad.RUN_IN_FLIGHT == 0
    assert G * V >= K and V % 2 == 0 and G * (V - 2) < K
    assert G == 4 or 8 * (G // 2) < K
    assert (map_grad.short_of(K), map_grad.piece_of(K)) == (map_grad.SHORT_RUN,
                                                            map_grad.PIECE)
    inst = f"PMF_MAP_GRAD_RUNS({G}, {V});"
    assert inst in SRC


def test_past_the_runs_form_nothing_is_short():
    assert map_grad.short_of(map_grad.RUNS_MAX_K + 1) == 0
    assert map_grad.kernel_of(map_grad.RUNS_MAX_K + 1)[0] == "wide"


# ------------------------------------------------------------- grouping --

@pytest.mark.parametrize("K", [20, 50, 128])
@pytest.mark.parametrize("mix", [1, 3, 8])
def test_grouping_classes_hold_every_edge_once(mix, K):
    """``MapBlockedLayout.group`` on the CPU: each step's pieces are its
    long runs' pieces (``step_long``) and then its short runs, one piece
    each (``step_short``), the two counts adding to the step's pieces of
    ``step_off`` (``step_first`` its host copy); every edge lies in one
    class; each class's runs go longest first; the scratch rows and
    counters are as many as the most long pieces of a step."""
    u, i, x, n_users, n_items = map_data(n_users=40, n_items=900, nnz=9000, seed=mix)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items, batch_size=mix * 700, mix=mix,
                                 device="cpu")
    order = np.random.default_rng(mix + K).permutation(lay.n_segments)
    n_long_runs = 0
    for g in lay.group(order, mix, K):
        assert g.short == map_grad.SHORT_RUN
        step_off = g.step_off.numpy()
        np.testing.assert_array_equal(g.step_first, step_off)
        np.testing.assert_array_equal(g.step_long + g.step_short, np.diff(step_off))
        lens = np.diff(g.piece_ptr.numpy())
        first, count = g.piece_first.numpy(), g.piece_count.numpy()
        run_len = np.zeros(g.n_pieces, np.int64)
        np.add.at(run_len, first, lens)
        run_len = run_len[first]  # each piece's run's length
        in_long = np.zeros(g.n_pieces, bool)
        for s in range(g.n_steps):
            p0, mid, p1 = step_off[s], step_off[s] + g.step_long[s], step_off[s + 1]
            in_long[p0:mid] = True
            assert (run_len[p0:mid] > g.short).all() and (run_len[mid:p1] <= g.short).all()
            assert (count[mid:p1] == 1).all() and (lens[mid:p1] == run_len[mid:p1]).all()
            for lo, hi in ((p0, mid), (mid, p1)):
                runs = run_len[lo:hi][first[lo:hi] == np.arange(lo, hi)]
                assert (np.diff(runs) <= 0).all()  # longest first
            assert lens[p0:p1].sum() == g.step_edges[s]
            n_long_runs += int((first[p0:mid] == np.arange(p0, mid)).sum())
        edges = lens[in_long].sum() + lens[~in_long].sum()
        assert edges == lay.nnz == g.piece_ptr[-1]
        assert g.scratch.shape[0] == 0  # the CPU carries none
        assert g.counters.shape[0] == g.step_long.max()
    assert n_long_runs > 0


def test_a_piece_shorter_than_the_threshold_bounds_the_short_class():
    u, i, x, n_users, n_items = map_data(n_users=30, n_items=300, nnz=3000, seed=2)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items, batch_size=1000, mix=1,
                                 device="cpu")
    for g in lay.group(np.arange(lay.n_segments), 1, 20, piece=5):
        assert g.short == 5
        lens = np.diff(g.piece_ptr.numpy())
        assert lens.max() <= 5


# ------------------------------------------------------------ emulation --

def _fma(a, b, c):
    """float32 fma: the product of two float32 values is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _xor_sum(part, offsets):
    """An xor butterfly over the last axis at ``offsets`` (every lane ends
    with the same float)."""
    lanes = np.arange(part.shape[-1])
    for off in offsets:
        part = part + part[..., lanes ^ off]
    return part


def _walk(es, eo, xv, G, lam_floor):
    """A group's walk of one share: ``es`` (G, V) its lanes' self columns,
    ``eo`` (n, G, V) the edges' other columns in edge order; returns (acc
    (G, V), nll)."""
    f32 = np.float32
    V = es.shape[1]
    acc, nll = np.zeros_like(es), f32(0)
    for e in range(len(xv)):
        part = es[:, 0] * eo[e, :, 0]
        for v in range(1, V):
            part = _fma(es[:, v], eo[e, :, v], part)
        dot = _xor_sum(part, [G >> s for s in range(1, G.bit_length()) if G >> s])[0]
        lam = max(dot, f32(lam_floor))
        w = f32(1) - xv[e] / lam if dot >= f32(lam_floor) else f32(0)
        acc = _fma(w, eo[e], acc)
        nll = f32(nll + (lam - xv[e] * np.log(lam)))
    return acc, nll


def emulate(self_tab, other_tab, g, step, lam_floor, with_nll, out):
    """One direction of ``step`` as ``map_grad_runs_kernel<G, V>`` sums it,
    in float32: lane l of a group holds columns l, l + G, ...; a short run
    walked by one group in edge order; a long piece's edges cut into R =
    32 / G contiguous shares, one a group, the shares' sums joined by an
    xor butterfly across the groups (offsets 1, 2, ... in groups); a run of
    several pieces summed from its partial rows in piece order."""
    f32 = np.float32
    K = self_tab.shape[1] - 1
    G, V = _runs_of(g)
    R = 32 // G
    cols = np.arange(G)[:, None] + G * np.arange(V)[None, :]  # (G, V)
    valid = cols < K
    width = K + 1 + int(with_nll)

    def lane_rows(tab, ids):
        v = tab[np.asarray(ids)][:, np.minimum(cols, K - 1)].astype(f32)
        v[:, ~valid] = 0
        return v

    ptr, other, x = g.piece_ptr.numpy(), g.other.numpy(), g.x.numpy().astype(f32)
    prow, pfirst, pcount = g.piece_row.numpy(), g.piece_first.numpy(), g.piece_count.numpy()
    p0, p1 = g.step_first[step], g.step_first[step + 1]
    mid = p0 + g.step_long[step]
    rows = {}
    for p in range(p0, p1):
        es = lane_rows(self_tab, [prow[p]])[0]
        b, n = ptr[p], ptr[p + 1] - ptr[p]
        if p >= mid:  # a short run: one group
            acc, nll = _walk(es, lane_rows(other_tab, other[b:b + n]), x[b:b + n], G,
                             lam_floor)
        else:  # a long piece: R shares, joined across the groups
            share = -(-n // R)
            accs, nlls = np.zeros((R, G, V), f32), np.zeros(R, f32)
            for r in range(R):
                lo, hi = min(r * share, n), min(r * share + share, n)
                accs[r], nlls[r] = _walk(es, lane_rows(other_tab, other[b + lo:b + hi]),
                                         x[b + lo:b + hi], G, lam_floor)
            offs = [1 << s for s in range(R.bit_length() - 1)]
            acc = _xor_sum(accs.transpose(1, 2, 0), offs)[..., 0]
            nll = _xor_sum(nlls, offs)[0]
        row = np.zeros(width, f32)
        row[cols[valid]] = acc[valid]
        row[K] = n
        if with_nll:
            row[K + 1] = nll
        rows[p] = row
    for p in range(p0, p1):
        if p == pfirst[p]:
            s = rows[p].copy()
            for q in range(p + 1, p + pcount[p]):
                s = s + rows[q]
            out[prow[p]] = s


def _step_of_runs(G, seed=0):
    """One step whose user rows hold runs of 1, 2, G - 1, G, 31, 32, 33,
    128, 129, 757 and 9403 edges over 1,000 items (drawn with
    replacement), and a few users of 1-5 edges beside them."""
    rng = np.random.default_rng(seed)
    n_items = 1000
    runs = (1, 2, G - 1, G, 31, 32, 33, 128, 129, 757, 9403)
    u, i = [], []
    for row, n in enumerate(runs):
        u.append(np.full(n, row))
        i.append(rng.integers(0, n_items, n))
    extra = rng.integers(1, 6, 12)
    for j, n in enumerate(extra):
        u.append(np.full(n, len(runs) + j))
        i.append(rng.integers(0, n_items, n))
    u, i = np.concatenate(u), np.concatenate(i)
    perm = rng.permutation(len(u))
    x = rng.integers(1, 6, len(u)).astype(np.float64) + 1.0
    n_users = len(runs) + len(extra)
    ident = (np.arange(n_users),) * 2 + (np.arange(n_items),) * 2
    lay = t_map.MapBlockedLayout.from_segments([(u[perm], i[perm], x[perm])], ident,
                                               n_users, n_items, 1, device="cpu")
    return lay, runs


@pytest.mark.parametrize("K", EMULATED_KS)
def test_emulated_order_matches_plain_float64(K):
    """The emulation on both directions of a step with user runs of 1 to
    9403 edges (the bench's longest item run), against the COO plain
    version in float64, per column at the gate, counts exactly."""
    G = map_grad.kernel_of(K)[1]
    lay, runs = _step_of_runs(G)
    u_sp, i_sp = softplus_tables(lay.n_users, lay.n_items, K, np.float32, seed=K)
    dirs = lay.group([0], 1, K)
    lens = np.diff(dirs[0].piece_ptr.numpy())
    run_len = np.bincount(dirs[0].piece_row.numpy(), weights=lens)
    assert sorted(run_len[:len(runs)]) == sorted(runs)
    assert dirs[0].step_long[0] > 0 and dirs[0].step_short[0] > 0
    nu, ni, xs = lay.segment(0)
    ref = map_grad.map_grad_plain(torch.from_numpy(u_sp).double(),
                                  torch.from_numpy(i_sp).double(), nu, ni, xs.double(), FLOOR)
    for (g, tabs, with_nll), want in zip(
            ((dirs[0], (u_sp, i_sp), True), (dirs[1], (i_sp, u_sp), False)), ref):
        out = np.zeros((tabs[0].shape[0], K + 1 + int(with_nll)), np.float32)
        emulate(*tabs, g, 0, FLOOR, with_nll, out)
        want = want.numpy()
        np.testing.assert_array_equal(out[:, K], want[:, K])  # counts exactly
        scale = np.abs(want).max(axis=0)
        assert (np.abs(out - want).max(axis=0) <= RTOL * scale + ATOL).all()  # per column
        np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------- the epoch against JAX --

@pytest.mark.parametrize("K", [20, 50])
def test_blocked_epoch_matches_jax_at_k(K):
    """Several Adam steps of the blocked engine in the very segment order
    the JAX epoch draws, at the runs form's K = 20 and 50 (the plain
    version of K9 on the CPU, the Pallas kernel in interpret mode on the
    JAX side), at tests/test_torch_hpf_map.py's gate (rtol 2e-4, atol
    2e-5)."""
    mix = 2
    u, i, x, n_users, n_items = map_data(n_users=600, n_items=40, nnz=11000, seed=K)
    cfg = t_map.HPFMapConfig(n_factors=K, random_state=0, lr=0.01)
    lay = j_map.build_map_layout(u, i, x, n_users, n_items, batch_size=mix * 2048,
                                 dtype=np.float32, mix=mix)
    scal = (0.3, 1.0, 1.0, 0.3, 1.0, 1.0)
    us = (1.0 / (np.bincount(u, minlength=n_users) + 1e-6)).astype(np.float32)
    is_ = (1.0 / (np.bincount(i, minlength=n_items) + 1e-6)).astype(np.float32)
    u_o2n, i_o2n = np.asarray(lay.u_old_of_new), np.asarray(lay.i_old_of_new)
    p_np = t_map._init_params_numpy(n_users, n_items, cfg)
    p_new = {"user": p_np["user"][u_o2n], "item": p_np["item"][i_o2n]}
    key = jax.random.key(3)
    perm = np.array(jax.random.permutation(key, lay.n_segments))
    opt = optax.adam(cfg.lr)
    jp = jax.tree.map(jnp.asarray, p_new)
    jp, _, j_loss = j_map.train_epoch_blocked(
        jp, opt.init(jp), key, lay, jnp.asarray(us[u_o2n]), jnp.asarray(is_[i_o2n]), scal,
        opt, precision="highest", interpret=True, mix=mix)
    t_lay = port_layout(lay, mix)
    groups = t_lay.group(perm, mix, K)
    assert sum(g.step_long.sum() for g in groups) > 0  # long runs beside the short ones
    tp = t_map.params_from_numpy(p_new, device="cpu")
    tp, ts, t_loss = t_map.train_epoch_blocked(
        tp, adam_init(tp), perm, t_lay, torch.from_numpy(us[u_o2n]),
        torch.from_numpy(is_[i_o2n]), scal, cfg.lr, mix)
    assert ts["count"] == lay.n_segments // mix >= 2
    for k in ("user", "item"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4)


def test_the_launch_args_are_checked_once_and_not_copied():
    """A grouping's launch arguments are checked and kept on the first call;
    a ``dataclasses.replace`` copy checks its own tensors again."""
    import dataclasses

    u, i, x, n_users, n_items = map_data(n_users=20, n_items=60, nnz=400, seed=1)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items, batch_size=200, mix=1,
                                 device="cpu")
    g = lay.group(np.arange(lay.n_segments), 1, 20)[0]
    # The card's grouping carries a scratch row a slot; the CPU's none.
    g = dataclasses.replace(g, scratch=torch.zeros(g.counters.shape[0], 22))
    args = g.launch_args()
    assert args is g.launch_args() and len(args) == 6
    assert args[0] == g.piece_ptr.data_ptr() and args[-1] == g.x.data_ptr()
    bad = dataclasses.replace(g, piece_row=g.piece_row.long())
    with pytest.raises(TypeError, match="piece_row must be"):
        bad.launch_args()
    assert g.step_long.max() > 0
    with pytest.raises(ValueError, match="too small"):
        dataclasses.replace(g, counters=g.counters[:0]).launch_args()
